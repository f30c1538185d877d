# Counterpart of murmura_tpu/analysis/__init__.py.
"""Static analysis, executable contracts and runtime sanitizers of the port.

``python -m murmura_tpu_torch check [PATHS] [--device cuda|cpu]`` runs the
torch-aware lint (:mod:`~murmura_tpu_torch.analysis.lint`) over PATHS (the
package by default), the static cross-layer contracts
(:mod:`~murmura_tpu_torch.analysis.contracts`), and — for the package
check, each behind its ``--<family>/--no-<family>`` flag — the executable
families, which build and run tiny networks on ``device``:

========== ============ ====================================================
family     rules        what it holds
========== ============ ====================================================
lint       MUR000-006   no host sync, tensor branch or assert in a round
                        scope; no build in a loop; no CUDA at import; no
                        float32-default constructor against round state
contracts  MUR100-103,  registries <-> schema enums <-> the port's tests;
           MUR300/301,  zero-diagonal topologies and fault masks; sparse
           MUR401,      families and samplers; the telemetry migration
           MUR602,      note; snapshot completeness
           MUR900
durability MUR901/902   save -> restore -> replay bit-equal, no build on
                        restore, every rule x {dense, circulant, sparse}
adaptive   MUR1000/1001 attack-state registry; build-free adaptation
staleness  MUR1100/1101 stale-state registry; build-free staleness
pipeline   MUR1200/1201 pipeline-state registry; build-free pipelining
sharded    MUR1300-1303 a gloo group of 2: two all_to_all turns a round, no
           MUR1002,     [N, P] all_reduce, no build after the first round,
           MUR1102,     param_shards 1 bit-equal, the group within rtol
           MUR1202      5e-5 of one process; the levers add no collective
compose    MUR1400-1402 levers.py <-> guard sites <-> refusal census; every
                        compatible pair builds and trains build-free; the
                        composed state and stage order
serve      MUR1600-1603 bucket keys <-> program descriptions; build-free
                        admission; frozen lanes; daemon kill and recover
observe    MUR1700-1703 scrape <-> ledger replay; scrapes inert; spans well
                        formed; schema discipline
========== ============ ====================================================

The JAX package's IR, budget, flow and memory families (MUR200-206,
MUR302/303, MUR400/402, MUR500/501, MUR600/601, MUR700-702, MUR800-804,
MUR1500-1503) and the jaxpr taint halves (MUR1003/1103/1203/1403) read
jaxprs, HLO or XLA's AOT analyses, which torch has no counterpart of;
``check`` refuses ``--ir``, ``--flow``, ``--memory``, ``--update-budgets``
and ``--update-memory`` by name.

Suppression: ``# murmura: ignore[MUR003]`` on the flagged line (for the
executable families, on the line a finding anchors at).

The runtime sanitizers (:mod:`~murmura_tpu_torch.analysis.sanitizers`) are
the guards behind ``tpu.recompile_guard`` / ``tpu.transfer_guard``.
"""

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from murmura_tpu_torch.analysis.contracts import check_contracts
from murmura_tpu_torch.analysis.lint import Finding, lint_file, lint_paths
from murmura_tpu_torch.analysis.sanitizers import (
    CompileTracker,
    RecompileError,
    track_compiles,
    transfer_sanitizer,
)

# The executable families, in the order they run: name -> (module, entry).
FAMILIES: Tuple[Tuple[str, str, str], ...] = (
    ("durability", "durability", "check_durability"),
    ("adaptive", "adaptive", "check_adaptive"),
    ("staleness", "staleness", "check_staleness"),
    ("pipeline", "pipeline", "check_pipeline"),
    ("sharded", "sharded", "check_sharded"),
    ("compose", "composition", "check_composition"),
    ("serve", "serve", "check_serve"),
    ("observe", "observe", "check_observe"),
)


def run_check_detailed(
    paths: Optional[Sequence] = None,
    contracts: bool = True,
    device="cuda",
    lint: bool = True,
    timings: Optional[Dict[str, Tuple[int, float]]] = None,
    **families: Optional[bool],
) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Run the lint over ``paths`` (default: the package; off with
    ``lint=False``), the static contracts, and each executable family on
    ``device``; returns ``(findings, records)``.

    ``families`` maps a family name of :data:`FAMILIES` to True/False;
    None (the default) means on for the package check and off for explicit
    paths (the families exercise the live package, not the files named).
    ``timings``, when given, receives ``{family: (findings, seconds)}``
    (the lint's and the contracts' too, where they run).  ``records`` carries the
    composition grid's ``compose_summary`` rows for ``check --json``.
    """
    import importlib
    import time

    unknown = set(families) - {name for name, _, _ in FAMILIES}
    if unknown:
        raise TypeError(f"unknown check families {sorted(unknown)}")
    run = {name: (families.get(name) if families.get(name) is not None else not paths)
           for name, _, _ in FAMILIES}
    if not paths:
        paths = [Path(__file__).resolve().parent.parent]
    timings = {} if timings is None else timings

    findings: List[Finding] = []
    if lint:
        t0 = time.perf_counter()
        findings.extend(lint_paths(paths))
        timings["lint"] = (len(findings), time.perf_counter() - t0)
    if contracts:
        t0 = time.perf_counter()
        found = check_contracts()
        timings["contracts"] = (len(found), time.perf_counter() - t0)
        findings.extend(found)
    records: List[Dict[str, Any]] = []
    for name, module, entry in FAMILIES:
        if not run[name]:
            continue
        t0 = time.perf_counter()
        mod = importlib.import_module(f"murmura_tpu_torch.analysis.{module}")
        found = getattr(mod, entry)(device)
        timings[name] = (len(found), time.perf_counter() - t0)
        findings.extend(found)
        if name == "compose":
            records.extend(mod.compose_summaries())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, records


def run_check(paths: Optional[Sequence] = None, contracts: bool = True, device="cuda",
              **families: Optional[bool]) -> List[Finding]:
    """Findings-only wrapper of :func:`run_check_detailed` (empty = clean)."""
    return run_check_detailed(paths, contracts=contracts, device=device, **families)[0]


def format_findings(findings: Iterable[Finding]) -> str:
    """One greppable line per finding: ``path:line: RULE [name] message``."""
    return "\n".join(f"{f.path}:{f.line}: {f.rule} [{f.name}] {f.message}" for f in findings)


def format_findings_json(findings: Iterable[Finding],
                         records: Optional[Iterable[Dict[str, Any]]] = None) -> str:
    """JSON lines (``check --json``): one ``{"kind": "finding", ...}`` object
    per finding, then the records (a record without a ``kind`` defaults to
    ``budget_delta``, as in the JAX package)."""
    lines = [
        json.dumps({
            "kind": "finding",
            "rule": f.rule,
            "name": f.name,
            "path": f.path,
            "line": f.line,
            "message": f.message,
            **({"data": f.data} if f.data else {}),
        })
        for f in findings
    ]
    for rec in records or ():
        lines.append(json.dumps({"kind": "budget_delta", **rec}))
    return "\n".join(lines)


__all__ = [
    "FAMILIES",
    "Finding",
    "lint_file",
    "lint_paths",
    "check_contracts",
    "run_check",
    "run_check_detailed",
    "format_findings",
    "format_findings_json",
    "CompileTracker",
    "RecompileError",
    "track_compiles",
    "transfer_sanitizer",
]
