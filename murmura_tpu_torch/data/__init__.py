"""Federated data layer: stacked, padded per-node arrays (numpy)."""

from murmura_tpu_torch.data.base import FederatedArrays, stack_partitions
from murmura_tpu_torch.data.registry import build_federated_data

__all__ = ["FederatedArrays", "stack_partitions", "build_federated_data"]
