"""Label-flipping data poisoning (the PyTorch counterpart of
murmura_tpu/attacks/label_flip.py).

The broadcast is untouched; the compromised nodes train
(``trains_locally``) on labels rotated y -> (y + 1) % num_classes for a
seeded ``flip_fraction`` of their real samples.  The flip runs once, at
build time, on the numpy labels (``poison_labels`` is the JAX package's,
so the poisoned labels are the same bits); the eval split stays clean.
"""

import numpy as np

from murmura_tpu_torch.attacks.base import Attack, select_compromised


def _check_fraction(flip_fraction: float) -> None:
    if not 0.0 < flip_fraction <= 1.0:
        raise ValueError(f"flip_fraction must be in (0, 1], got {flip_fraction}")


def poison_labels(
    y: np.ndarray,
    sample_mask: np.ndarray,
    compromised: np.ndarray,
    num_classes: int,
    flip_fraction: float = 1.0,
    seed: int = 42,
) -> np.ndarray:
    """Rotated-label copy of ``y`` [N, S] on the compromised rows: a seeded
    choice (without replacement) of ``flip_fraction`` of each compromised
    node's real samples (``sample_mask`` [N, S] > 0)."""
    _check_fraction(flip_fraction)
    out = np.array(y, copy=True)
    rng = np.random.default_rng(seed)
    for i in np.flatnonzero(compromised):
        real = np.flatnonzero(np.asarray(sample_mask[i]) > 0)
        if real.size == 0:
            continue
        k = max(1, int(round(flip_fraction * real.size)))
        chosen = rng.choice(real, size=min(k, real.size), replace=False)
        out[i, chosen] = (out[i, chosen] + 1) % num_classes
    return out


def make_label_flip(
    num_nodes: int,
    attack_percentage: float,
    flip_fraction: float = 1.0,
    seed: int = 42,
) -> Attack:
    _check_fraction(flip_fraction)
    compromised = select_compromised(num_nodes, attack_percentage, seed)

    def apply(flat, compromised_mask, generator=None, noise=None):
        return flat

    def data_poison_fn(y, sample_mask, num_classes):
        return poison_labels(y, sample_mask, compromised, num_classes,
                             flip_fraction=flip_fraction, seed=seed)

    return Attack(
        name="label_flip",
        compromised=compromised,
        apply=apply,
        trains_locally=True,
        data_poison_fn=data_poison_fn,
    )
