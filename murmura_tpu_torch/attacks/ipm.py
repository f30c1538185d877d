"""IPM, inner-product manipulation (Xie, Koyejo & Gupta, UAI 2020): the
PyTorch counterpart of murmura_tpu/attacks/ipm.py without the ZMQ backend's
``ipm_vector``.  Every colluder broadcasts -epsilon * (the honest mean),
reduced in float32 and cast once to the parameter dtype.
"""

from typing import Optional

import torch

from murmura_tpu_torch.attacks.base import (
    Attack,
    check_rows,
    honest_mean,
    select_compromised,
)

DEFAULT_EPSILON = 1.5


def resolve_ipm_epsilon(epsilon: Optional[float] = None) -> float:
    return DEFAULT_EPSILON if epsilon is None else float(epsilon)


def make_ipm_attack(
    num_nodes: int,
    attack_percentage: float,
    epsilon: Optional[float] = None,
    seed: int = 42,
) -> Attack:
    compromised = select_compromised(num_nodes, attack_percentage, seed)
    eps = resolve_ipm_epsilon(epsilon)

    def apply(flat, compromised_mask, generator=None, noise=None):
        check_rows("ipm", flat, num_nodes)
        if not compromised.any():
            return flat
        malicious = (-eps * honest_mean(flat, compromised_mask)).to(flat.dtype)  # [1, P]
        return torch.where(compromised_mask[:, None] > 0, malicious, flat)

    return Attack(name="ipm", compromised=compromised, apply=apply)
