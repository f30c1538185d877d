"""Aggregation rules (the PyTorch counterpart of
murmura_tpu/aggregation/__init__.py): all nine of the JAX package's."""

from dataclasses import replace
from typing import Any, Dict

from murmura_tpu_torch.aggregation.balance import make_balance
from murmura_tpu_torch.aggregation.base import AggContext, AggregatorDef
from murmura_tpu_torch.aggregation.evidential_trust import make_evidential_trust
from murmura_tpu_torch.aggregation.fedavg import make_fedavg
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.aggregation.robust_stats import (
    make_coordinate_median,
    make_geometric_median,
    make_trimmed_mean,
)
from murmura_tpu_torch.aggregation.sketchguard import make_sketchguard
from murmura_tpu_torch.aggregation.ubar import make_ubar

AGGREGATORS = {
    "fedavg": make_fedavg,
    "krum": make_krum,
    "balance": make_balance,
    "sketchguard": make_sketchguard,
    "median": make_coordinate_median,
    "trimmed_mean": make_trimmed_mean,
    "geometric_median": make_geometric_median,
    "ubar": make_ubar,
    "evidential_trust": make_evidential_trust,
}


def build_aggregator(name: str, params: Dict[str, Any], model_dim: int = 0) -> AggregatorDef:
    """Resolve ``aggregation.algorithm`` to a rule.  Krum takes ``f`` as an
    alias of ``num_compromised``; Sketchguard gets ``model_dim`` for its
    tables; ``total_rounds`` reaches the schedule rules through
    ``AggContext`` (core/rounds.py), so a ``total_rounds`` param is
    dropped.  A rule built with ``exchange_offsets`` carries them
    (``AggregatorDef.exchange_offsets``), for a node group's exchange."""
    algo = name.lower()
    if algo not in AGGREGATORS:
        raise ValueError(f"Unknown aggregation algorithm: {name}")
    params = dict(params or {})
    params.pop("total_rounds", None)
    if algo == "krum" and "f" in params:
        # Reference configs name Krum's Byzantine tolerance "f".
        f = params.pop("f")
        if "num_compromised" in params and params["num_compromised"] != f:
            raise ValueError(
                f"krum config supplies both f={f} and "
                f"num_compromised={params['num_compromised']} with different "
                "values; they are aliases — set exactly one"
            )
        params.setdefault("num_compromised", f)
    if algo == "sketchguard":
        params.setdefault("model_dim", model_dim)
    agg = AGGREGATORS[algo](**params)
    offsets = params.get("exchange_offsets")
    return replace(agg, exchange_offsets=tuple(int(o) for o in offsets)) if offsets else agg


__all__ = [
    "AGGREGATORS",
    "AggContext",
    "AggregatorDef",
    "build_aggregator",
    "make_balance",
    "make_coordinate_median",
    "make_evidential_trust",
    "make_fedavg",
    "make_geometric_median",
    "make_krum",
    "make_sketchguard",
    "make_trimmed_mean",
    "make_ubar",
]
