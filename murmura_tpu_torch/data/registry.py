# Copy of murmura_tpu/data/registry.py, cut to the adapters the port runs.
"""Dataset adapter registry: config adapter strings -> FederatedArrays.

``synthetic`` and ``leaf.femnist`` (on-disk LEAF JSON or its
shape-identical synthetic stand-in) are ported; the other adapters are
refused by name.
"""

from typing import Any, Dict, Optional

from murmura_tpu_torch.data.base import (
    DEFAULT_HOLDOUT_FRACTION,
    FederatedArrays,
    split_holdout,
    stack_partitions,
)
from murmura_tpu_torch.data.partitioners import dirichlet_partition, iid_partition
from murmura_tpu_torch.data.synthetic import make_synthetic


def _partition(labels, num_nodes: int, params: Dict[str, Any], seed: int):
    method = params.get("partition_method", "iid")
    if method == "dirichlet":
        return dirichlet_partition(
            labels,
            num_nodes,
            alpha=float(params.get("alpha", 0.5)),
            seed=seed,
        )
    if method == "iid":
        return iid_partition(len(labels), num_nodes, seed=seed)
    raise ValueError(f"Unknown partition_method: {method}")


def _with_holdout(parts, params: Dict[str, Any], seed: int):
    """(train_partitions, test_partitions|None) per data.params.holdout_fraction."""
    frac = float(params.get("holdout_fraction", DEFAULT_HOLDOUT_FRACTION))
    if frac <= 0.0:
        return parts, None
    return split_holdout(parts, frac, seed)


def build_federated_data(
    adapter: str,
    params: Dict[str, Any],
    num_nodes: int,
    seed: int = 42,
    max_samples: Optional[int] = None,
) -> FederatedArrays:
    """Resolve a config ``data.adapter`` string to stacked federated arrays."""
    params = dict(params or {})

    if adapter == "synthetic":
        x, y = make_synthetic(
            num_samples=int(params.get("num_samples", 2000)),
            input_shape=tuple(params.get("input_shape", [params.get("input_dim", 32)])),
            num_classes=int(params.get("num_classes", 10)),
            cluster_std=float(params.get("cluster_std", 1.0)),
            seed=seed,
        )
        parts = _partition(y, num_nodes, params, seed)
        parts, test_parts = _with_holdout(parts, params, seed)
        return stack_partitions(
            x, y, parts, max_samples=max_samples,
            num_classes=int(params.get("num_classes", 10)),
            test_partitions=test_parts,
        )

    if adapter == "leaf.femnist":
        from murmura_tpu_torch.data.leaf import load_femnist_federated

        return load_femnist_federated(params, num_nodes, seed, max_samples)

    raise ValueError(
        f"dataset adapter '{adapter}' is not ported to the PyTorch package "
        "yet (ported: synthetic, leaf.femnist)"
    )
