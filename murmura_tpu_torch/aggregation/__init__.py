"""Aggregation rules.  The port has Krum; the other rules of the JAX
package are refused by name until their slice lands."""

from typing import Any, Dict

from murmura_tpu_torch.aggregation.base import AggContext, AggregatorDef
from murmura_tpu_torch.aggregation.krum import make_krum

AGGREGATORS = {"krum": make_krum}
NOT_PORTED = (
    "fedavg", "balance", "sketchguard", "ubar", "evidential_trust",
    "median", "trimmed_mean", "geometric_median",
)


def build_aggregator(name: str, params: Dict[str, Any]) -> AggregatorDef:
    """Resolve ``aggregation.algorithm`` to a rule (Krum only for now)."""
    if name in AGGREGATORS:
        return AGGREGATORS[name](**dict(params or {}))
    if name in NOT_PORTED:
        raise ValueError(
            f"aggregation rule '{name}' is not ported to the PyTorch package "
            "yet (ported: krum)"
        )
    raise ValueError(f"Unknown aggregation algorithm: {name}")


__all__ = ["AggContext", "AggregatorDef", "build_aggregator", "make_krum"]
