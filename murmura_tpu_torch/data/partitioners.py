# Copy of murmura_tpu/data/partitioners.py: the port imports nothing from the JAX package.
"""Client partitioning strategies (reference: murmura/data/partitioners.py:7-223).

Host-side numpy; same statistical semantics as the reference: per-class
Dirichlet proportions with remainder assignment and min-samples
redistribution, shuffled IID splits, natural grouping by subject/user id,
and Dirichlet re-partitioning of natural groups.  Uses an explicit
``np.random.default_rng`` generator instead of the reference's global
``np.random.seed`` state.
"""

from typing import List, Optional, Tuple

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.5,
    min_samples_per_client: int = 1,
    seed: Optional[int] = None,
) -> List[List[int]]:
    """Non-IID partition via per-class Dirichlet proportions
    (reference: partitioners.py:7-77).

    Lower ``alpha`` = more heterogeneous label distributions per client.
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)

    client_indices: List[List[int]] = [[] for _ in range(num_clients)]

    for c in classes:
        indices = np.flatnonzero(labels == c)
        proportions = rng.dirichlet(np.full(num_clients, alpha))
        counts = (proportions * len(indices)).astype(int)
        remaining = len(indices) - counts.sum()
        if remaining > 0:
            extra = rng.choice(num_clients, remaining, replace=False)
            counts[extra] += 1
        rng.shuffle(indices)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for i in range(num_clients):
            client_indices[i].extend(indices[offsets[i] : offsets[i + 1]].tolist())

    _ensure_minimum_samples(client_indices, min_samples_per_client)

    for idx in client_indices:
        rng.shuffle(idx)
    return client_indices


def _ensure_minimum_samples(client_indices: List[List[int]], min_samples: int) -> None:
    """Move samples from surplus clients to deficit clients in place
    (reference: partitioners.py:80-124)."""
    if min_samples <= 0:
        return
    deficits = [
        i for i, idx in enumerate(client_indices) if len(idx) < min_samples
    ]
    for d in deficits:
        needed = min_samples - len(client_indices[d])
        for s, idx in enumerate(client_indices):
            if needed <= 0:
                break
            surplus = len(idx) - min_samples
            if s == d or surplus <= 0:
                continue
            take = min(needed, surplus)
            client_indices[d].extend(idx[-take:])
            client_indices[s] = idx[:-take]
            needed -= take


def iid_partition(
    num_samples: int,
    num_clients: int,
    seed: Optional[int] = None,
) -> List[List[int]]:
    """Uniform shuffled split (reference: partitioners.py:127-150)."""
    rng = np.random.default_rng(seed)
    indices = rng.permutation(num_samples)
    return [split.tolist() for split in np.array_split(indices, num_clients)]


def natural_partition(
    client_ids: np.ndarray,
    num_clients: Optional[int] = None,
) -> Tuple[List[List[int]], int]:
    """Group samples by their natural subject/user id
    (reference: partitioners.py:153-181)."""
    client_ids = np.asarray(client_ids)
    unique_clients = np.unique(client_ids)
    if num_clients is not None and num_clients < len(unique_clients):
        unique_clients = unique_clients[:num_clients]
    partitions = [
        np.flatnonzero(client_ids == cid).tolist() for cid in unique_clients
    ]
    return partitions, len(unique_clients)


def combine_partitions_with_dirichlet(
    natural_partitions: List[List[int]],
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.5,
    seed: Optional[int] = None,
) -> List[List[int]]:
    """Dirichlet re-partition of naturally grouped data
    (reference: partitioners.py:184-223)."""
    all_indices = [i for part in natural_partitions for i in part]
    sub = dirichlet_partition(
        labels=np.asarray(labels)[all_indices],
        num_clients=num_clients,
        alpha=alpha,
        seed=seed,
    )
    return [[all_indices[i] for i in part] for part in sub]
