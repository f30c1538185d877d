# Copy of the refusal_reason part of murmura_tpu/levers.py, as a static table.
"""Refusal messages of the lever composition grid.

The JAX package assembles these from the ``LEVER_MANIFEST`` of each lever
module, which imports JAX.  The configuration schema only needs the
messages, so the port keeps them as a table keyed by the same
``(a, b, constraint)`` triple the schema's guard sites cite.
"""

from typing import Dict, Optional, Tuple

_REFUSALS: Dict[Tuple[str, str, Optional[str]], str] = {
    ("adaptive", "dmtt", None): "adaptive attacks do not compose with dmtt (the claims channel is a second feedback path the adaptation state does not model)",
    ("mobility", "sparse", None): "sparse topologies do not compose with mobility (G^t is a dense per-round graph); drop the mobility block or use a dense topology",
    ("dmtt", "sparse", None): "sparse topologies do not compose with dmtt (claim verification needs the dense exchange graph)",
    ("population", "sweep", None): "population does not compose with sweep (gang batching) yet — run cohort-streaming experiments unganged",
    ("dmtt", "population", None): "population does not compose with dmtt (trust state is keyed by node identity, which cohort swaps reassign)",
    ("compression", "dmtt", None): "compression does not compose with dmtt (claim cross-evaluation consumes the uncompressed broadcast)",
    ("compression", "population", "carried_state"): "compression with carried state (error_feedback, or algorithm: topk) does not compose with population (cohort swaps reassign node slots); use stateless int8 or disable the population block",
    ("faults", "staleness", "requires_faults"): "exchange.max_staleness requires faults.enabled: true — without the fault model nothing ever misses a round, so the stale cache would be dead state in every program",
    ("dmtt", "staleness", None): "bounded staleness does not compose with dmtt (the exchange graph is trust-gated per round; a cached row would bypass the round's claim verification)",
    ("mobility", "staleness", None): "bounded staleness does not compose with mobility: an edge leaving G^t is topology change, not a fault, and the re-add layer needs a static base graph baked at trace time",
    ("sparse", "staleness", "one_peer"): "bounded staleness does not compose with the one_peer topology (its active offset varies per round as mask values, so there is no static base edge mask to re-add from); use the exponential sparse family or a dense topology",
    ("population", "staleness", None): "bounded staleness does not compose with population (the payload cache is per-slot [N, P] carried state; cohort swaps reassign node slots, so a cached row would be served into the wrong user's stream — the compression carried-state rationale)",
    ("dmtt", "pipeline", None): "exchange.pipeline does not compose with dmtt (claim verification gates each round's exchange between production and aggregation; delaying the aggregation would verify claims against a different round's graph)",
    ("adaptive", "pipeline", None): "exchange.pipeline does not compose with attack.adaptive: the acceptance feedback would observe round r-1's aggregation after round r's production already ran, changing the closed loop's timing semantics — run adaptive experiments serialized",
    ("pipeline", "population", None): "exchange.pipeline does not compose with population (the pipeline buffer is per-slot [N, P] carried state; cohort swaps reassign node slots, so a buffered row would be aggregated into the wrong user's stream — the compression/staleness carried-state rationale)",
    ("dmtt", "sharding", None): "tpu.param_shards does not compose with dmtt (the N x N claim cross-evaluation unravels every broadcast row into a full model per pair — there is no sharded formulation of that sweep)",
    ("compression", "sharding", "topk"): "tpu.param_shards does not compose with compression.algorithm: topk (the per-row global top-k needs the full [P] row resident on one device, defeating the shard); use the int8 codec — its per-block scales shard with P",
    ("population", "sharding", None): "tpu.param_shards does not compose with population yet (the memmapped user bank stages full [P] rows per cohort swap; a sharded bank is ROADMAP item 5's sharded-bank leg)",
    ("dmtt", "mobility", "requires_mobility"): "dmtt requires a mobility section (claim verification needs the deterministic G^t); set dmtt.allow_static: true to verify claims against the static topology instead",
}


def refusal_reason(a: str, b: str, constraint: Optional[str] = None) -> str:
    """The refusal message for the unordered lever pair ``{a, b}``."""
    earlier, later = sorted((a, b))
    return _REFUSALS[(earlier, later, constraint)]
