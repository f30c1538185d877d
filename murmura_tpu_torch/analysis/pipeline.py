# Counterpart of murmura_tpu/analysis/pipeline.py (MUR1200, MUR1201).
"""Pipelined-rounds contracts (``check --pipeline``).

- **MUR1200 — pipeline-state registry bijection.**  ``PIPELINE_STATE_KEYS``
  is distinct and ``pipe_``-prefixed, registered in the MUR900 snapshot
  registry under core/pipeline.py; ``pipeline_state_keys(stale=True)``
  drops exactly ``pipe_bcast`` (the stale cache is the broadcast buffer);
  ``init_pipeline_state`` seeds exactly the reservation, with a
  node-leading buffered adjacency ([N, N] zero-diagonal dense, [N, k]
  sparse) and ``pipe_valid`` a scalar 0.
- **MUR1201 — build-free pipelining.**  Under churn, 3 pipelined rounds
  after warmup build nothing, and the buffer reports valid
  (``agg_pipe_valid`` > 0, else the check is vacuous).

The collective parity with the serialized program (MUR1202) runs over a
param group in analysis/sharded.py; the jaxpr taint half (MUR1203) has no
torch counterpart.
"""

from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from murmura_tpu_torch.analysis.cells import (
    base_raw,
    build_network,
    family_registry,
    rule_anchor,
    run_families,
    with_exchange,
)
from murmura_tpu_torch.analysis.lint import Finding

PIPELINE_CHECK_FAMILIES, _family = family_registry()

_PIPE_PATH = str(Path(__file__).resolve().parent.parent / "core" / "pipeline.py")

PIPELINE_MODES: Tuple[str, ...] = ("dense", "sparse")


@_family
def check_pipeline_state_registry(device=None) -> List[Finding]:
    """MUR1200: PIPELINE_STATE_KEYS <-> init_pipeline_state <-> MUR900."""
    try:
        from murmura_tpu_torch.core import pipeline
        from murmura_tpu_torch.durability.snapshot import RESERVED_AGG_STATE_KEY_GROUPS
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        return [Finding(
            "MUR1200", _PIPE_PATH, 1,
            f"the pipeline module failed to import ({type(e).__name__}: {e}) "
            "— the MUR1200 bijection cannot be checked",
        )]
    return pipeline_state_findings(pipeline, RESERVED_AGG_STATE_KEY_GROUPS)


def pipeline_state_findings(pipeline, registry) -> List[Finding]:
    """MUR1200 over a pipeline module (the tests plant one whose stale key
    set keeps the broadcast buffer)."""
    findings: List[Finding] = []
    keys = tuple(pipeline.PIPELINE_STATE_KEYS)
    if len(set(keys)) != len(keys) or any(not k.startswith("pipe_") for k in keys):
        findings.append(Finding(
            "MUR1200", _PIPE_PATH, 1,
            f"PIPELINE_STATE_KEYS must be distinct 'pipe_'-prefixed agg_state "
            f"keys, got {keys}",
        ))
    reg = registry.get("PIPELINE_STATE_KEYS")
    if reg != "murmura_tpu_torch.core.pipeline":
        findings.append(Finding(
            "MUR1200", _PIPE_PATH, 1,
            "PIPELINE_STATE_KEYS is not registered in durability.snapshot."
            f"RESERVED_AGG_STATE_KEY_GROUPS under its defining module (got "
            f"{reg!r}) — a resumed run would discard the in-flight exchange",
        ))
    stale_keys = pipeline.pipeline_state_keys(stale=True)
    if pipeline.BCAST_KEY in stale_keys or set(stale_keys) != set(keys) - {pipeline.BCAST_KEY}:
        findings.append(Finding(
            "MUR1200", _PIPE_PATH, 1,
            f"pipeline_state_keys(stale=True) returned {stale_keys} — with "
            "bounded staleness armed the broadcast buffer is the stale cache "
            "and exactly pipe_bcast must drop from the carried set",
        ))
    if tuple(pipeline.pipeline_state_keys(stale=False)) != keys:
        findings.append(Finding(
            "MUR1200", _PIPE_PATH, 1,
            "pipeline_state_keys(stale=False) must return the full "
            "PIPELINE_STATE_KEYS reservation",
        ))
    for n, p, offsets, stale in ((5, 7, (), False), (8, 3, (1, 2, 4), False), (6, 4, (), True)):
        init = pipeline.init_pipeline_state(n, p, torch.float32, sparse_offsets=offsets,
                                            stale=stale)
        want = set(pipeline.pipeline_state_keys(stale))
        if set(init) != want:
            findings.append(Finding(
                "MUR1200", _PIPE_PATH, 1,
                f"init_pipeline_state keys {sorted(init)} != "
                f"pipeline_state_keys({stale}) {sorted(want)} — the round "
                "program seeds agg_state from the reservation",
            ))
            continue
        adj = init[pipeline.ADJ_KEY].cpu().numpy()
        want_adj = (n, len(offsets)) if offsets else (n, n)
        if adj.shape != want_adj:
            findings.append(Finding(
                "MUR1200", _PIPE_PATH, 1,
                f"init pipe_adj is shape {adj.shape}, not {want_adj} — the "
                "buffered adjacency must be node-leading ([N, N] dense, "
                "[N, k] sparse)",
            ))
        if not offsets and np.diagonal(adj).any():
            findings.append(Finding(
                "MUR1200", _PIPE_PATH, 1,
                "init pipe_adj has a non-zero diagonal — the warm-up "
                "placeholder graph must respect MUR301 (no self-loops)",
            ))
        valid = init[pipeline.VALID_KEY]
        if tuple(valid.shape) != () or float(valid) != 0.0:
            findings.append(Finding(
                "MUR1200", _PIPE_PATH, 1,
                f"init pipe_valid is {valid!r}, not a scalar 0.0 — the "
                "buffer must start invalid so round 0's placeholder "
                "aggregation is discarded",
            ))
    return findings


def cell_raw(rule: str, mode: str, pipeline: bool = True) -> Dict[str, Any]:
    """One (rule, mode) cell: the tiny cell, 5 rounds, under churn (the
    buffered adjacency varies round to round), pipelined."""
    raw = with_exchange(base_raw(f"pipe-{rule}-{mode}", rule, rounds=5), mode)
    raw["faults"] = {"enabled": True, "straggler_prob": 0.4, "link_drop_prob": 0.2,
                     "seed": 11}
    if pipeline:
        raw["exchange"] = {"pipeline": True}
    return raw


def recompile_cell_findings(rule: str, mode: str = "dense", device="cuda") -> List[Finding]:
    """ONE MUR1201 cell: 2 warmup rounds, 3 under CompileTracker."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles

    path, line = rule_anchor(rule)
    net = build_network(cell_raw(rule, mode), device)
    net.train(rounds=2)
    with track_compiles() as tracker:
        net.train(rounds=3)
    findings: List[Finding] = []
    if tracker.total:
        findings.append(Finding(
            "MUR1201", path, line,
            f"[{rule}/{mode}] 3 pipelined rounds after warmup built "
            f"{tracker.total} program(s) or kernel(s) — pipelining must be "
            "value-only over one round program",
        ))
    valid = net.history.get("agg_pipe_valid") or []
    if not any(np.asarray(v).sum() > 0 for v in valid):
        findings.append(Finding(
            "MUR1201", path, line,
            f"[{rule}/{mode}] agg_pipe_valid never reported a valid buffer "
            "across 5 pipelined rounds — the build check is vacuous (the "
            "pipeline stage is not wired into this rule's round program)",
        ))
    return findings


@_family
def check_pipeline_recompile(device) -> List[Finding]:
    """MUR1201 over ``AGGREGATORS x PIPELINE_MODES``."""
    from murmura_tpu_torch.aggregation import AGGREGATORS

    findings: List[Finding] = []
    for rule in sorted(AGGREGATORS):
        for mode in PIPELINE_MODES:
            try:
                findings.extend(recompile_cell_findings(rule, mode, device))
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                path, line = rule_anchor(rule)
                findings.append(Finding(
                    "MUR1201", path, line,
                    f"[{rule}/{mode}] pipeline build probe crashed: "
                    f"{type(e).__name__}: {e}",
                ))
    return findings


def check_pipeline(device="cuda") -> List[Finding]:
    """MUR1200/1201."""
    return run_families(PIPELINE_CHECK_FAMILIES, "MUR1200", __file__, device)
