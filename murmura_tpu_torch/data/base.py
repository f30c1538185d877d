# Copy of murmura_tpu/data/base.py: the port imports nothing from the JAX package.
"""Stacked federated array containers.

Replaces the reference's per-node ``Subset``/``DataLoader`` machinery
(murmura/data/adapters.py:7-57, murmura/core/network.py:275-294) with padded
device-friendly arrays: node i's shard occupies row i, padded to the network
max and tagged with a validity mask.  ``effective_batch`` reproduces the
reference's per-node batch-size rule ``min(batch, max(2, n_samples))``
(murmura/core/network.py:278-287).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

# Fraction of each node's shard carved off for held-out evaluation by every
# loader that has no dataset-provided test split.  The reference evaluates
# on training data (murmura/core/network.py:289-294);
# ``data.params.holdout_fraction: 0.0`` restores that behavior.
DEFAULT_HOLDOUT_FRACTION = 0.2


@dataclass
class FederatedArrays:
    """One network's worth of per-node training (and optional test) data.

    Attributes:
        x: [N, S, ...] padded features.
        y: [N, S] padded int labels.
        mask: [N, S] validity mask (1.0 = real sample, 0.0 = padding).
        num_samples: [N] count of real samples per node.
        x_test / y_test / mask_test: optional separate held-out arrays; when
            None, evaluation reuses the training shard exactly as the
            reference does (murmura/core/network.py:289-294).
    """

    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    num_samples: np.ndarray
    x_test: Optional[np.ndarray] = None
    y_test: Optional[np.ndarray] = None
    mask_test: Optional[np.ndarray] = None
    num_classes: int = field(default=0)

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def max_samples(self) -> int:
        return self.x.shape[1]

    @property
    def eval_arrays(self):
        """(x, y, mask) used for evaluation — test split if present else train."""
        if self.x_test is not None:
            return self.x_test, self.y_test, self.mask_test
        return self.x, self.y, self.mask

    def effective_batch(self, batch_size: int) -> np.ndarray:
        """Per-node effective batch size b_i = min(B, max(2, n_i))
        (reference: murmura/core/network.py:278-287)."""
        return np.minimum(batch_size, np.maximum(2, self.num_samples)).astype(np.int32)

    def steps_per_epoch(self, batch_size: int) -> np.ndarray:
        """Per-node batches per epoch with the reference's drop_last rule:
        drop the ragged tail only when n_i > b_i (murmura/core/network.py:286)."""
        b = self.effective_batch(batch_size)
        n = self.num_samples
        return np.where(n > b, n // b, 1).astype(np.int32)

    def get_client_data(self, node_id: int):
        """Unpadded (x, y) view of one node's shard — reference
        ``DatasetAdapter.get_client_data`` parity (murmura/data/adapters.py:30-52)."""
        n = int(self.num_samples[node_id])
        return self.x[node_id, :n], self.y[node_id, :n]

    def get_client_eval_data(self, node_id: int):
        """Unpadded held-out (x, y) view for one node, falling back to its
        training shard when no test split exists (reference behavior,
        murmura/core/network.py:289-294)."""
        if self.x_test is None:
            return self.get_client_data(node_id)
        n = int(self.mask_test[node_id].sum())
        if n == 0:
            return self.get_client_data(node_id)
        return self.x_test[node_id, :n], self.y_test[node_id, :n]


def split_holdout(
    partitions: Sequence[Sequence[int]],
    fraction: float,
    seed: int,
    min_train: int = 2,
):
    """Split each node's index list into paired (train, test) lists.

    The reference evaluates on training data for most adapters
    (murmura/core/network.py:289-294); the paired per-node split mirrors its
    LEAF per-user train/test pairing (murmura/examples/leaf/
    datasets.py:300-377) for every loader, so held-out accuracy keeps the
    node's own (non-IID) label distribution.  Nodes keep at least
    ``min_train`` training samples (the reference's effective-batch floor,
    network.py:278-287); a node too small to spare any test samples
    evaluates on its training shard (reference behavior) so its accuracy
    row stays meaningful instead of dividing by an empty mask.
    """
    rng = np.random.default_rng(seed)
    train: List[List[int]] = []
    test: List[List[int]] = []
    for p in partitions:
        p = list(p)
        n_test = int(round(len(p) * fraction))
        n_test = min(n_test, max(0, len(p) - min_train))
        order = rng.permutation(len(p))
        if n_test == 0:
            train.append(p)
            test.append(p)
        else:
            test.append([p[i] for i in order[:n_test]])
            train.append([p[i] for i in order[n_test:]])
    return train, test


def stack_partitions(
    x: np.ndarray,
    y: np.ndarray,
    partitions: Sequence[Sequence[int]],
    max_samples: Optional[int] = None,
    num_classes: Optional[int] = None,
    test_partitions: Optional[Sequence[Sequence[int]]] = None,
    x_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
) -> FederatedArrays:
    """Pad per-node index lists into stacked [N, S, ...] arrays.

    Args:
        x, y: full dataset arrays.
        partitions: per-node sample index lists (ragged).
        max_samples: optional per-node truncation (reference:
            murmura/examples/leaf/adapter.py:12-16 "for quick tests").
        test_partitions: optional per-node index lists into (x_test, y_test)
            — defaults to evaluation on the training shard.
    """
    x = np.asarray(x)
    y = np.asarray(y)

    def _stack(xs, ys, parts):
        parts = [list(p) for p in parts]
        if max_samples is not None:
            parts = [p[:max_samples] for p in parts]
        n_nodes = len(parts)
        counts = np.array([len(p) for p in parts], dtype=np.int32)
        cap = max(1, int(counts.max()))
        fx = np.zeros((n_nodes, cap) + xs.shape[1:], dtype=xs.dtype)
        fy = np.zeros((n_nodes, cap), dtype=np.int32)
        fm = np.zeros((n_nodes, cap), dtype=np.float32)
        for i, p in enumerate(parts):
            if p:
                fx[i, : len(p)] = xs[p]
                fy[i, : len(p)] = ys[p]
                fm[i, : len(p)] = 1.0
        return fx, fy, fm, counts

    fx, fy, fm, counts = _stack(x, y, partitions)
    k = int(num_classes) if num_classes else int(y.max()) + 1 if y.size else 0

    tx = ty = tm = None
    if test_partitions is not None:
        xs = x if x_test is None else np.asarray(x_test)
        ys = y if y_test is None else np.asarray(y_test)
        tx, ty, tm, _ = _stack(xs, ys, test_partitions)

    return FederatedArrays(
        x=fx, y=fy, mask=fm, num_samples=counts,
        x_test=tx, y_test=ty, mask_test=tm, num_classes=k,
    )
