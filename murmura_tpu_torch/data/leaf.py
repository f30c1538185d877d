# Copy of the FEMNIST part of murmura_tpu/data/leaf.py.
"""LEAF FEMNIST from the LEAF JSON layout, or its shape-identical synthetic
stand-in when no ``data_path`` is given (or ``synthetic: true``).

Natural user partitioning as in the JAX package: a seeded user shuffle,
round-robin users -> nodes, and paired per-user train/test partitions.
"""

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from murmura_tpu_torch.data.base import (
    DEFAULT_HOLDOUT_FRACTION,
    FederatedArrays,
    split_holdout,
    stack_partitions,
)
from murmura_tpu_torch.data.partitioners import dirichlet_partition, iid_partition
from murmura_tpu_torch.data.synthetic import make_synthetic

FEMNIST_CLASSES = 62


def _load_leaf_json_dir(split_dir: Path) -> Tuple[List[str], Dict[str, Dict]]:
    """Merge all JSON shards in a LEAF split dir into (users, user_data)."""
    users: List[str] = []
    user_data: Dict[str, Dict] = {}
    for shard in sorted(split_dir.glob("*.json")):
        with open(shard) as f:
            blob = json.load(f)
        users.extend(blob.get("users", []))
        user_data.update(blob.get("user_data", {}))
    return users, user_data


def _round_robin_users(
    users: List[str], num_nodes: int, seed: int
) -> List[List[str]]:
    """Seeded user shuffle then round-robin users -> nodes."""
    rng = np.random.default_rng(seed)
    order = list(users)
    rng.shuffle(order)
    groups: List[List[str]] = [[] for _ in range(num_nodes)]
    for i, u in enumerate(order):
        groups[i % num_nodes].append(u)
    return groups


def _decode_users(users: List[str], load_user):
    """Decode users via ``load_user(u) -> (ux, uy)`` into pooled arrays plus
    per-user (start, end) offsets."""
    xs, ys = [], []
    offsets: Dict[str, Tuple[int, int]] = {}
    cursor = 0
    for u in users:
        ux, uy = load_user(u)
        xs.append(ux)
        ys.append(uy)
        offsets[u] = (cursor, cursor + len(uy))
        cursor += len(uy)
    return np.concatenate(xs), np.concatenate(ys), offsets


def _femnist_from_json(
    data_path: Path, num_nodes: int, seed: int, max_samples: Optional[int],
    holdout_fraction: float,
) -> FederatedArrays:
    train_users, train_data = _load_leaf_json_dir(data_path / "train")
    test_dir = data_path / "test"
    test_users, test_data = (
        _load_leaf_json_dir(test_dir) if test_dir.exists() else ([], {})
    )
    groups = _round_robin_users(train_users, num_nodes, seed)

    def decode(user_data):
        def load_user(u):
            ux = np.asarray(user_data[u]["x"], dtype=np.float32).reshape(-1, 28, 28, 1)
            uy = np.asarray(user_data[u]["y"], dtype=np.int32)
            return ux, uy

        return load_user

    x, y, offsets = _decode_users(train_users, decode(train_data))
    partitions = [
        [i for u in group for i in range(*offsets[u])] for group in groups
    ]
    have = []
    if test_users and holdout_fraction > 0.0:
        in_test = set(test_users)
        have = [u for u in train_users if u in in_test]
    if have:
        x_t, y_t, offsets_t = _decode_users(have, decode(test_data))
        test_partitions = [
            [i for u in group if u in offsets_t for i in range(*offsets_t[u])]
            for group in groups
        ]
        # A node whose users all lack test samples evaluates on its train
        # shard instead of on an empty mask.
        extra_x, extra_y = [], []
        cursor = len(y_t)
        for i, tp in enumerate(test_partitions):
            if not tp and partitions[i]:
                tr = partitions[i]
                test_partitions[i] = list(range(cursor, cursor + len(tr)))
                extra_x.append(x[tr])
                extra_y.append(y[tr])
                cursor += len(tr)
        if extra_x:
            x_t = np.concatenate([x_t] + extra_x)
            y_t = np.concatenate([y_t] + extra_y)
        return stack_partitions(
            x, y, partitions, max_samples=max_samples,
            num_classes=FEMNIST_CLASSES, test_partitions=test_partitions,
            x_test=x_t, y_test=y_t,
        )
    test_partitions = None
    if holdout_fraction > 0.0:
        partitions, test_partitions = split_holdout(
            partitions, holdout_fraction, seed
        )
    return stack_partitions(
        x, y, partitions, max_samples=max_samples,
        num_classes=FEMNIST_CLASSES, test_partitions=test_partitions,
    )


def load_femnist_federated(
    params: Dict[str, Any],
    num_nodes: int,
    seed: int = 42,
    max_samples: Optional[int] = None,
) -> FederatedArrays:
    """Load LEAF FEMNIST, from disk or as synthetic 28x28x1 / 62-class data."""
    params = dict(params or {})
    data_path = params.get("data_path")
    use_synthetic = bool(params.get("synthetic", data_path is None))
    holdout = float(params.get("holdout_fraction", DEFAULT_HOLDOUT_FRACTION))

    if not use_synthetic:
        root = Path(data_path)
        if not root.exists():
            raise FileNotFoundError(
                f"LEAF data path not found: {root}. Pass data.params.synthetic: true "
                "for shape-identical synthetic data."
            )
        return _femnist_from_json(root, num_nodes, seed, max_samples, holdout)

    n_total = int(params.get("num_samples", max(2000, 200 * num_nodes)))
    x, y = make_synthetic(
        num_samples=n_total,
        input_shape=(28, 28, 1),
        num_classes=FEMNIST_CLASSES,
        cluster_std=float(params.get("cluster_std", 2.0)),
        seed=seed,
    )
    if params.get("partition_method", "dirichlet") == "dirichlet":
        parts = dirichlet_partition(
            y, num_nodes, alpha=float(params.get("alpha", 0.5)), seed=seed
        )
    else:
        parts = iid_partition(len(y), num_nodes, seed=seed)
    test_parts = None
    if holdout > 0.0:
        parts, test_parts = split_holdout(parts, holdout, seed)
    return stack_partitions(
        x, y, parts, max_samples=max_samples, num_classes=FEMNIST_CLASSES,
        test_partitions=test_parts,
    )
