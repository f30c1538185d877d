# Copy of murmura_tpu/data/synthetic.py: the port imports nothing from the JAX package.
"""Synthetic classification data for smoke tests and benchmarks.

Counterpart of the reference's synthetic ``TensorDataset`` walkthrough
(murmura/examples/simple_programmatic.py:24-40): well-separated Gaussian
class clusters so learning progress is visible within a few FL rounds.
Supports flat feature vectors and image-shaped tensors (for CNN models).
"""

from typing import Optional, Sequence, Tuple

import numpy as np


def make_synthetic(
    num_samples: int = 2000,
    input_shape: Sequence[int] = (32,),
    num_classes: int = 10,
    cluster_std: float = 1.0,
    seed: int = 0,
    separation: Optional[float] = None,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian class clusters: x ~ N(mu_c, std), y = c.

    ``separation`` controls difficulty: when set, centers are scaled so the
    *expected pairwise center distance* is ``separation * cluster_std``
    (along the discriminant between two classes the projected noise std is
    ``cluster_std``, so Bayes pairwise error ~ Phi(-separation/2) regardless
    of dimensionality).  When ``None``, the legacy smoke-test behavior is
    kept — centers ~ N(0, 2) per dim, which in high dimension is trivially
    separable (round-1 weakness: every paper-matrix experiment saturated at
    accuracy 1.0000 and could not distinguish the aggregation rules).

    ``label_noise`` flips that fraction of labels to a uniformly random
    *other* class, setting an irreducible error floor the way real sensor
    datasets have one.
    """
    rng = np.random.default_rng(seed)
    input_shape = tuple(input_shape)
    dim = int(np.prod(input_shape))
    centers = rng.normal(0.0, 1.0, size=(num_classes, dim))
    if separation is None:
        centers *= 2.0
    else:
        # E||c_i - c_j|| for N(0, s^2) coords is s*sqrt(2*dim); solve for s.
        centers *= float(separation) * cluster_std / np.sqrt(2.0 * dim)
    y = rng.integers(0, num_classes, size=num_samples)
    x = centers[y] + rng.normal(0.0, cluster_std, size=(num_samples, dim))
    if label_noise > 0.0:
        flip = rng.random(num_samples) < label_noise
        shift = rng.integers(1, num_classes, size=num_samples)
        y = np.where(flip, (y + shift) % num_classes, y)
    return x.reshape((num_samples,) + input_shape).astype(np.float32), y.astype(
        np.int32
    )


def make_synthetic_sequences(
    num_samples: int = 2000,
    seq_len: int = 80,
    vocab_size: int = 81,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic next-char prediction data for the Shakespeare-style LSTM.

    Sequences follow a learnable periodic pattern with noise; the target is
    the next token (LEAF Shakespeare task shape: seq_len 80, vocab ~81 —
    reference: leaf/models/shakespeare/stacked_lstm.py:19-27).
    """
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab_size, size=num_samples)
    steps = rng.integers(1, 4, size=num_samples)
    t = np.arange(seq_len + 1)
    seqs = (starts[:, None] + steps[:, None] * t[None, :]) % vocab_size
    noise = rng.random(size=seqs.shape) < 0.05
    seqs = np.where(noise, rng.integers(0, vocab_size, size=seqs.shape), seqs)
    return seqs[:, :-1].astype(np.int32), seqs[:, -1].astype(np.int32)
