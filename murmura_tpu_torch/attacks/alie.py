"""ALIE, "A Little Is Enough" (Baruch et al., NeurIPS 2019): the PyTorch
counterpart of murmura_tpu/attacks/alie.py.

Every colluder broadcasts the same vector mu - z * sigma (coordinate-wise),
placed just inside the benign spread.  mu and sigma come from the honest
rows (``omniscient``, stronger than the paper) or from the colluders' own
benign-trained rows (``coalition``, the paper's estimator; the colluders
then train, ``trains_locally``).  z defaults to the paper's z_max rule.
The statistics are float32 whatever the parameter dtype and the malicious
row is cast once, so every colluder row is the same bits.  On the ZMQ
backend each colluder estimates the statistics from the coalition's own
benign states (``colluding_vector``, distributed/node_process.py), and a
node's [1, P] view passes through ``apply`` unchanged, as in JAX.
"""

from statistics import NormalDist
from typing import Optional

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import (
    Attack,
    check_rows,
    coalition_stats,
    select_compromised,
)
from murmura_tpu_torch.parallel.mesh import node_rows


def alie_z_max(num_nodes: int, num_compromised: int) -> float:
    """The paper's z_max: the largest z with
    phi(z) <= (n - m - s) / (n - m), s = floor(n/2) + 1 - m; the quantile is
    clamped where m reaches a majority (s <= 0)."""
    n, m = int(num_nodes), int(num_compromised)
    honest = max(n - m, 1)
    s = n // 2 + 1 - m
    cdf = (honest - s) / honest
    cdf = min(max(cdf, 1e-9), 1.0 - 1e-9)
    return float(NormalDist().inv_cdf(cdf))


def resolve_alie_z(num_nodes: int, num_compromised: int, z: Optional[float] = None) -> float:
    """An explicit z wins, else the paper's z_max."""
    return float(z) if z is not None else alie_z_max(num_nodes, num_compromised)


# Copy of colluding_vector from murmura_tpu/attacks/alie.py.
def colluding_vector(benign_states: np.ndarray, z: float) -> np.ndarray:
    """The paper's malicious vector from a coalition sample: mu - z*sigma
    over the colluders' own benign states ([M, P], M >= 1), statistics in
    float64 on the host, returned in float32 (the wire dtype).  With one
    colluder sigma is 0 and the vector is its benign state."""
    s = np.asarray(benign_states, dtype=np.float64)
    mu = s.mean(axis=0)
    sigma = s.std(axis=0)
    return (mu - float(z) * sigma).astype(np.float32)


def make_alie_attack(
    num_nodes: int,
    attack_percentage: float,
    z: Optional[float] = None,
    seed: int = 42,
    estimator: str = "omniscient",
) -> Attack:
    if estimator not in ("omniscient", "coalition"):
        raise ValueError(
            f"ALIE estimator must be 'omniscient' or 'coalition', got {estimator!r}"
        )
    compromised = select_compromised(num_nodes, attack_percentage, seed)
    z_val = resolve_alie_z(num_nodes, int(compromised.sum()), z)

    def apply(flat, compromised_mask, generator=None, noise=None):  # murmura: traced
        if check_rows("alie", flat, num_nodes) or not compromised.any():  # murmura: ignore[MUR001] check_rows reads shapes; compromised is numpy
            return flat
        mu, var = coalition_stats(flat, compromised_mask, estimator)
        malicious = (mu - z_val * torch.sqrt(var)).to(flat.dtype)  # [1, P]
        return torch.where(node_rows(compromised_mask)[:, None] > 0, malicious, flat)

    return Attack(
        name="alie",
        compromised=compromised,
        apply=apply,
        trains_locally=(estimator == "coalition"),
    )
