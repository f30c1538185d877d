"""Byzantine attacks.  ``topology_liar`` (it needs DMTT) and the adaptive
attacks (a lever) are refused by name until their slices land."""

from murmura_tpu_torch.attacks.alie import make_alie_attack
from murmura_tpu_torch.attacks.base import Attack, select_compromised
from murmura_tpu_torch.attacks.directed import make_directed_deviation_attack
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.attacks.ipm import make_ipm_attack
from murmura_tpu_torch.attacks.label_flip import make_label_flip, poison_labels

ATTACKS = {
    "gaussian": make_gaussian_attack,
    "directed_deviation": make_directed_deviation_attack,
    "alie": make_alie_attack,
    "ipm": make_ipm_attack,
    "label_flip": make_label_flip,
}

__all__ = [
    "ATTACKS",
    "Attack",
    "select_compromised",
    "make_alie_attack",
    "make_directed_deviation_attack",
    "make_gaussian_attack",
    "make_ipm_attack",
    "make_label_flip",
    "poison_labels",
]
