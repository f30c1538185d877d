"""Byzantine attacks.  The port has the gaussian attack; the others are
refused by name until their slice lands."""

from murmura_tpu_torch.attacks.base import Attack, select_compromised
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack

ATTACKS = {"gaussian": make_gaussian_attack}

__all__ = ["ATTACKS", "Attack", "select_compromised", "make_gaussian_attack"]
