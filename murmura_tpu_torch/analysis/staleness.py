# Counterpart of murmura_tpu/analysis/staleness.py (MUR1100, MUR1101).
"""Bounded-staleness contracts (``check --staleness``).

- **MUR1100 — stale-state registry bijection.**  ``STALE_STATE_KEYS`` is
  distinct and ``stale_``-prefixed, registered in the MUR900 snapshot
  registry under core/stale.py, and ``init_stale_state`` seeds exactly it:
  an ``[N, P]`` cache and ``[N]`` float32 ages that start past the bound
  (a round-0 disruption drops the edge instead of serving zeros).
  ``StalenessSpec`` refuses what the schema refuses.
- **MUR1101 — build-free staleness.**  Under a 40% straggler / 20% link
  drop schedule, 3 rounds after warmup build nothing, and the cell serves
  stale edges (``agg_stale_used`` > 0, else the check is vacuous).

The collective parity with the drop-sync program (MUR1102) runs over a
param group in analysis/sharded.py; the jaxpr taint half (MUR1103) has no
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

STALENESS_CHECK_FAMILIES, _family = family_registry()

_STALE_PATH = str(Path(__file__).resolve().parent.parent / "core" / "stale.py")

# The layouts the grid sweeps: the dense [N, N] fold and the sparse [k, N]
# edge-mask fold (mobility and one_peer are refused at the schema).
STALE_MODES: Tuple[str, ...] = ("dense", "sparse")


@_family
def check_stale_state_registry(device=None) -> List[Finding]:
    """MUR1100: STALE_STATE_KEYS <-> init_stale_state <-> MUR900 registry."""
    try:
        from murmura_tpu_torch.core import stale
        from murmura_tpu_torch.durability.snapshot import RESERVED_AGG_STATE_KEY_GROUPS
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        return [Finding(
            "MUR1100", _STALE_PATH, 1,
            f"the staleness module failed to import ({type(e).__name__}: {e}) "
            "— the MUR1100 bijection cannot be checked",
        )]
    return stale_state_findings(tuple(stale.STALE_STATE_KEYS), stale.StalenessSpec,
                                stale.init_stale_state, RESERVED_AGG_STATE_KEY_GROUPS)


def stale_state_findings(keys, spec_cls, init_fn, registry) -> List[Finding]:
    """MUR1100 over the given reservation, spec and initialiser (the tests
    plant an initialiser that drops a key)."""
    findings: List[Finding] = []
    if len(set(keys)) != len(keys) or any(not k.startswith("stale_") for k in keys):
        findings.append(Finding(
            "MUR1100", _STALE_PATH, 1,
            f"STALE_STATE_KEYS must be distinct 'stale_'-prefixed agg_state "
            f"keys, got {keys}",
        ))
    reg = registry.get("STALE_STATE_KEYS")
    if reg != "murmura_tpu_torch.core.stale":
        findings.append(Finding(
            "MUR1100", _STALE_PATH, 1,
            "STALE_STATE_KEYS is not registered in durability.snapshot."
            f"RESERVED_AGG_STATE_KEY_GROUPS under its defining module (got "
            f"{reg!r}) — a resumed run would start with a cold cache",
        ))
    try:
        spec = spec_cls(max_staleness=2, discount=0.5)
    except Exception as e:  # noqa: BLE001 — a crash IS the finding
        findings.append(Finding(
            "MUR1100", _STALE_PATH, 1,
            f"StalenessSpec(2, 0.5) crashed: {type(e).__name__}: {e}",
        ))
        return findings
    for n, p in ((4, 7), (9, 3)):
        init = init_fn(spec, n, p, torch.float32)
        if set(init) != set(keys):
            findings.append(Finding(
                "MUR1100", _STALE_PATH, 1,
                f"init_stale_state keys {sorted(init)} != STALE_STATE_KEYS "
                f"{sorted(keys)} — the round program seeds agg_state from "
                "the reservation",
            ))
            continue
        cache, age = init["stale_cache"], init["stale_age"]
        if tuple(cache.shape) != (n, p):
            findings.append(Finding(
                "MUR1100", _STALE_PATH, 1,
                f"init stale_cache is shape {tuple(cache.shape)}, not ({n}, {p}) "
                "— the cache must mirror the exchanged [N, P] tensor",
            ))
        if tuple(age.shape) != (n,) or age.dtype != torch.float32:
            findings.append(Finding(
                "MUR1100", _STALE_PATH, 1,
                f"init stale_age is {age.dtype}{tuple(age.shape)}, not "
                f"float32 ({n},) — ages are per-sender [N] float32 rows",
            ))
        elif not bool((age > spec.max_staleness).all()):
            findings.append(Finding(
                "MUR1100", _STALE_PATH, 1,
                "init stale_age starts within the staleness bound — a "
                "round-0 disruption would serve the all-zeros cache as a "
                "real payload instead of dropping the edge",
            ))
    for bad in ({"max_staleness": 0}, {"max_staleness": 2, "discount": 0.0}):
        try:
            spec_cls(**bad)
        except ValueError:
            pass
        else:
            findings.append(Finding(
                "MUR1100", _STALE_PATH, 1,
                f"StalenessSpec accepted invalid parameters {bad} — the spec "
                "must refuse what the schema refuses",
            ))
    return findings


def cell_raw(rule: str, mode: str, max_staleness: int = 2) -> Dict[str, Any]:
    """One (rule, mode) cell: the tiny cell, 5 rounds, under churn, with
    the stale fold armed."""
    raw = with_exchange(base_raw(f"stale-{rule}-{mode}", rule, rounds=5), mode)
    raw["faults"] = {"enabled": True, "straggler_prob": 0.4, "link_drop_prob": 0.2,
                     "seed": 11}
    raw["exchange"] = {"max_staleness": max_staleness, "staleness_discount": 0.5}
    return raw


def recompile_cell_findings(rule: str, mode: str = "dense", device="cuda") -> List[Finding]:
    """ONE MUR1101 cell: 2 warmup rounds, 3 under CompileTracker."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles

    path, line = rule_anchor(rule)
    net = build_network(cell_raw(rule, mode), device)
    net.train(rounds=2)
    with track_compiles() as tracker:
        net.train(rounds=3)
    findings: List[Finding] = []
    if tracker.total:
        findings.append(Finding(
            "MUR1101", path, line,
            f"[{rule}/{mode}] 3 stale-enabled rounds after warmup built "
            f"{tracker.total} program(s) or kernel(s) — staleness variation "
            "must be value-only over one round program",
        ))
    used = net.history.get("agg_stale_used") or []
    if not any(np.asarray(u).sum() > 0 for u in used):
        findings.append(Finding(
            "MUR1101", path, line,
            f"[{rule}/{mode}] a 40% straggler / 20% link-drop schedule served "
            "zero stale edges across 5 rounds — the build check is vacuous "
            "(the stale fold is not wired into this rule's round program)",
        ))
    return findings


@_family
def check_stale_recompile(device) -> List[Finding]:
    """MUR1101 over ``AGGREGATORS x STALE_MODES``."""
    from murmura_tpu_torch.aggregation import AGGREGATORS

    findings: List[Finding] = []
    for rule in sorted(AGGREGATORS):
        for mode in STALE_MODES:
            try:
                findings.extend(recompile_cell_findings(rule, mode, device))
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                path, line = rule_anchor(rule)
                findings.append(Finding(
                    "MUR1101", path, line,
                    f"[{rule}/{mode}] stale build probe crashed: "
                    f"{type(e).__name__}: {e}",
                ))
    return findings


def check_staleness(device="cuda") -> List[Finding]:
    """MUR1100/1101."""
    return run_families(STALENESS_CHECK_FAMILIES, "MUR1100", __file__, device)
