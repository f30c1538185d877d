"""Attack interface and compromised-node selection (the PyTorch
counterpart of murmura_tpu/attacks/base.py).

An attack transforms the *outgoing* broadcast states only:
``apply(flat[N, P], compromised[N], generator, noise=None) -> flat'``.
Compromised nodes also skip local training; that mask lives in the round.
"""

import random
from dataclasses import dataclass
from typing import Callable

import numpy as np


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


@dataclass(frozen=True)
class Attack:
    """A named attack with its compromised set and broadcast transform."""

    name: str
    compromised: np.ndarray  # [N] bool
    apply: Callable
    trains_locally: bool = False
