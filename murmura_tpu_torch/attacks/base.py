"""Attack interface and compromised-node selection (the PyTorch
counterpart of murmura_tpu/attacks/base.py and of ``coalition_stats`` in
murmura_tpu/attacks/adaptive.py).

An attack transforms the *outgoing* broadcast states only:
``apply(flat[N, P], compromised[N], generator, noise=None) -> flat'``.
Compromised nodes also skip local training unless the attack says they
train (``trains_locally``); that mask lives in the round.
"""

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


def select_compromised(num_nodes: int, percentage: float, seed: int = 42) -> np.ndarray:
    """Seeded compromised-node selection: ceil-to-1 when percentage > 0,
    ``random.sample`` under ``random.Random(seed)``.

    Returns:
        [N] boolean mask.
    """
    num = int(num_nodes * percentage)
    if num == 0 and percentage > 0:
        num = 1
    rng = random.Random(seed)
    chosen = rng.sample(range(num_nodes), min(num, num_nodes)) if num > 0 else []
    mask = np.zeros(num_nodes, dtype=bool)
    mask[list(chosen)] = True
    return mask


def honest_mean(flat: torch.Tensor, compromised_mask: torch.Tensor) -> torch.Tensor:
    """[1, P] mean over the honest rows of the broadcast tensor, reduced in
    float32 whatever the parameter dtype (a bfloat16 sum over N rows would
    quantise the statistic the colluding attacks build on)."""
    f32 = flat.to(torch.float32)
    hm = (1.0 - compromised_mask.to(torch.float32))[:, None]  # [N, 1]
    cnt = torch.clamp(hm.sum(), min=1.0)
    return (f32 * hm).sum(dim=0, keepdim=True) / cnt


def coalition_stats(flat: torch.Tensor, compromised_mask: torch.Tensor, estimator: str):
    """(mu [1, P], var [1, P]) of the ALIE construction in float32, over the
    honest rows (``omniscient``: stronger than the paper's construction) or
    over the compromised rows' own benign-trained states (``coalition``:
    Baruch et al.'s estimator, which needs the colluders to train and at
    least 2 of them)."""
    if estimator not in ("omniscient", "coalition"):
        raise ValueError(
            f"ALIE estimator must be 'omniscient' or 'coalition', got {estimator!r}"
        )
    f32 = flat.to(torch.float32)
    comp = compromised_mask.to(torch.float32)[:, None]  # [N, 1]
    w = comp if estimator == "coalition" else (1.0 - comp)
    cnt = torch.clamp(w.sum(), min=1.0)
    mu = (f32 * w).sum(dim=0, keepdim=True) / cnt
    var = (torch.square(f32 - mu) * w).sum(dim=0, keepdim=True) / cnt
    return mu, var


def check_rows(name: str, flat: torch.Tensor, num_nodes: int) -> bool:
    """Whether ``flat`` is one node's [1, P] view (the ZMQ backend's node
    process attacks its own outgoing row, distributed/node_process.py, with
    a ones mask) rather than the whole network's [N, P] broadcast; any
    other row count is a fault."""
    if flat.shape[0] == num_nodes:
        return False
    if flat.shape[0] == 1:
        return True
    raise ValueError(
        f"{name} attack built for {num_nodes} nodes got {flat.shape[0]} rows"
    )


@dataclass(frozen=True)
class Attack:
    """A named attack with its compromised set and broadcast transform.

    ``trains_locally``: the compromised nodes run local SGD (a data
    poisoning attack, or ALIE's coalition estimator) instead of staying
    frozen.  ``data_poison_fn``: the build-time transform (y [N, S],
    sample_mask [N, S], num_classes) -> y' of a data-poisoning attack.
    ``claims_fn``: the DMTT topology claims (true adjacency [N, N],
    compromised [N]) -> claimed adjacency [N, N] of a topology liar."""

    name: str
    compromised: np.ndarray  # [N] bool
    apply: Callable
    trains_locally: bool = False
    data_poison_fn: Optional[Callable] = field(default=None)
    claims_fn: Optional[Callable] = field(default=None)
