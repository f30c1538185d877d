"""IPM, inner-product manipulation (Xie, Koyejo & Gupta, UAI 2020): the
PyTorch counterpart of murmura_tpu/attacks/ipm.py.  Every colluder
broadcasts -epsilon * (the honest mean), reduced in float32 and cast once
to the parameter dtype; on the ZMQ backend -epsilon * the coalition's mean
(``ipm_vector``), and a node's [1, P] view passes through ``apply``.
"""

from typing import Optional

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import (
    Attack,
    check_rows,
    honest_mean,
    select_compromised,
)
from murmura_tpu_torch.parallel.mesh import node_rows

DEFAULT_EPSILON = 1.5


def resolve_ipm_epsilon(epsilon: Optional[float] = None) -> float:
    return DEFAULT_EPSILON if epsilon is None else float(epsilon)


# Copy of ipm_vector from murmura_tpu/attacks/ipm.py.
def ipm_vector(benign_states: np.ndarray, epsilon: float) -> np.ndarray:
    """The paper's malicious vector from a coalition sample ([M, P]):
    -epsilon * mean, float64 host statistics, float32 wire dtype."""
    s = np.asarray(benign_states, dtype=np.float64)
    return (-float(epsilon) * s.mean(axis=0)).astype(np.float32)


def make_ipm_attack(
    num_nodes: int,
    attack_percentage: float,
    epsilon: Optional[float] = None,
    seed: int = 42,
) -> Attack:
    compromised = select_compromised(num_nodes, attack_percentage, seed)
    eps = resolve_ipm_epsilon(epsilon)

    def apply(flat, compromised_mask, generator=None, noise=None):  # murmura: traced
        if check_rows("ipm", flat, num_nodes) or not compromised.any():  # murmura: ignore[MUR001] check_rows reads shapes; compromised is numpy
            return flat
        malicious = (-eps * honest_mean(flat, compromised_mask)).to(flat.dtype)  # [1, P]
        return torch.where(node_rows(compromised_mask)[:, None] > 0, malicious, flat)

    return Attack(name="ipm", compromised=compromised, apply=apply)
