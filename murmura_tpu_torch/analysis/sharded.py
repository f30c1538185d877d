# Counterpart of murmura_tpu/analysis/sharded.py (MUR1300-1303), with the
# collective parities of murmura_tpu/analysis/{adaptive,staleness,pipeline}.py.
"""Param-axis sharding contracts (``check --sharded``).

Every collective of the port goes through ``parallel/mesh.py``'s
``_dist()``.  The checks spawn one gloo group of 2 ranks
(parallel/launch.py; on the card both ranks share cuda:0, staged through
host memory as phase 4 of chip_smoke.py runs them), record each call
through ``_dist()`` during one round of a sharded Network, and hold:

- **MUR1300 — sharded collective inventory.**  A round turns the trained
  rows into column blocks in exactly one ``all_to_all_single``
  (``rows_to_columns``; a faulted program turns the pre-round rows too,
  which a node that misses the round keeps) and back in exactly one
  (``columns_to_rows``), and no ``all_reduce`` moves more than ``N * max(N, k, S)`` elements (the
  distance matrices, the circulant distances, a Count-Sketch): a
  full-width [N, P] reduction is the resident copy the axis exists to
  remove.
- **MUR1301 — build-free sharded rounds.**  No program or kernel is built
  after a cell's first round.
- **MUR1302 — ``param_shards: 1`` bit-parity.**  In one process, a config
  at ``tpu.param_shards: 1`` is bit-equal to the same config without it:
  no pad, the same initial state, the same history and parameters.
- **MUR1303 — sharded execution parity.**  The group's parameters after 3
  rounds match the one-process run of the same config within rtol 5e-5,
  atol 5e-6.
- **MUR1002 / MUR1102 / MUR1202 — a lever adds no communication.**  The
  adaptive attack's round (against the static attack's), the stale fold's
  (against the drop-sync round under the same faults) and the pipelined
  round's (against the serialized one) make the same set of (collective,
  mesh function) calls.

UBAR and evidential trust are exempt from MUR1300's two-turn count, as the
JAX package exempts them: their probe sweeps turn each column block back
into whole rows (``pairwise_probe_eval``, ``circulant_probe_eval``), by
construction.
"""

import copy
import sys
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from murmura_tpu_torch.analysis.cells import (
    base_raw,
    family_registry,
    rule_anchor,
    run_families,
)
from murmura_tpu_torch.analysis.lint import Finding

SHARDED_CHECK_FAMILIES, _family = family_registry()

_PKG = Path(__file__).resolve().parent.parent
_MESH_SUFFIX = str(Path("parallel") / "mesh.py")

WORLD = 2
SHARDED_MODES: Tuple[str, ...] = ("circulant", "sparse")
SHARDED_EXEMPT: Dict[str, str] = {
    "ubar": "the probe sweep turns each column block back into whole rows "
    "for a full model's forward pass",
    "evidential_trust": "the trust probe sweep turns each column block back "
    "into whole rows for a full model's forward pass",
}
# Each lever's sharded parity: (rule id, the lever's config patch, the plain
# round's patch it is held against).
_FAULTS = {"faults": {"enabled": True, "straggler_prob": 0.4, "link_drop_prob": 0.2,
                      "seed": 11}}
LEVER_PARITY: Dict[str, Tuple[str, Dict[str, Any], Dict[str, Any]]] = {
    "adaptive": (
        "MUR1002",
        {"attack": {"enabled": True, "type": "gaussian", "percentage": 0.3,
                    "params": {"noise_std": 5.0}, "adaptive": {"enabled": True}}},
        {"attack": {"enabled": True, "type": "gaussian", "percentage": 0.3,
                    "params": {"noise_std": 5.0}}},
    ),
    "stale": (
        "MUR1102",
        {**_FAULTS, "exchange": {"max_staleness": 2, "staleness_discount": 0.5}},
        dict(_FAULTS),
    ),
    "pipeline": ("MUR1202", {"exchange": {"pipeline": True}}, {}),
}
_PARITY_RTOL, _PARITY_ATOL = 5e-5, 5e-6
# The collectives parallel/mesh.py calls.
_RECORDED = ("all_reduce", "all_to_all_single", "all_gather", "gather", "barrier")


def sharded_raw(rule: str, mode: str, shards: int = WORLD, patch=None) -> Dict[str, Any]:
    """One sharded cell: the tiny cell on backend tpu at ``tpu.param_shards``
    ``shards`` (the MLP's 99 parameters padded to 100 over 2), circulant on
    the ring or sparse on the exponential graph."""
    raw = base_raw(f"sharded-{rule}-{mode}", rule)
    raw["backend"] = "tpu"
    raw["tpu"] = {"param_shards": shards, "param_dtype": "float32"}
    if mode == "circulant":
        raw["tpu"]["exchange"] = "ppermute"
    elif mode == "sparse":
        raw["topology"] = {"type": "exponential", "num_nodes": 8}
    elif mode != "dense":
        raise ValueError(f"unknown sharded mode {mode!r}")
    for k, v in (patch or {}).items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) and isinstance(raw.get(k), dict) else v
    return raw


def all_reduce_bound(raw: Dict[str, Any]) -> int:
    """``N * max(N, k, S)``: the largest all_reduce a cell may make."""
    from murmura_tpu_torch.topology.generators import create_topology

    n = raw["topology"]["num_nodes"]
    topo = create_topology(raw["topology"]["type"], num_nodes=n)
    offsets = getattr(topo, "offsets", None)
    k = len(offsets) if offsets is not None else int(np.asarray(topo.adjacency).sum(1).max())
    s = int(raw["aggregation"]["params"].get("sketch_size", 0))
    return n * max(n, k, s)


# --------------------------------------------------------------------------
# What runs in the ranks
# --------------------------------------------------------------------------


class _Recorder:
    """``torch.distributed`` with each collective call recorded as (op,
    elements of its first tensor, the outermost mesh.py function on the
    stack) while ``on``."""

    def __init__(self, dist):
        self._dist = dist
        self.on = False
        self.calls: List[Dict[str, Any]] = []

    def __getattr__(self, name):
        real = getattr(self._dist, name)
        if name not in _RECORDED:
            return real

        def call(*args, **kwargs):
            if self.on:
                import torch

                tensors = [a for a in list(args) + list(kwargs.values())
                           if isinstance(a, torch.Tensor)]
                self.calls.append({"op": name,
                                   "numel": int(tensors[0].numel()) if tensors else 0,
                                   "caller": _mesh_caller()})
            return real(*args, **kwargs)

        return call


def _mesh_caller() -> str:
    """The outermost parallel/mesh.py function of the current stack."""
    frame = sys._getframe(2)
    caller = "?"
    while frame is not None:
        if frame.f_code.co_filename.endswith(_MESH_SUFFIX):
            caller = frame.f_code.co_name
        frame = frame.f_back
    return caller


def sharded_rank_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """In each rank of the group: every case's sharded Network, one warm
    round, one recorded round, one more; then its whole parameters
    (gathered on every rank), its history, and its builds after the warm
    round."""
    import torch.distributed as dist

    from murmura_tpu_torch.analysis.cells import build_network
    from murmura_tpu_torch.analysis.sanitizers import compile_count
    from murmura_tpu_torch.parallel import mesh
    from murmura_tpu_torch.parallel.mesh import gather_rows, process_group

    group = process_group()
    recorder = _Recorder(dist)
    real_dist = mesh._dist
    mesh._dist = lambda: recorder
    out = []
    try:
        for case in cases:
            net = build_network(case["raw"], group.device)
            net.train(rounds=1)
            builds = compile_count()
            recorder.calls, recorder.on = [], True
            net.train(rounds=1)
            recorder.on = False
            net.train(rounds=1)
            calls = recorder.calls
            out.append({
                "label": case["label"],
                "calls": calls,
                "builds": compile_count() - builds,
                "flat": gather_rows(net.flat, net.program.group).float().cpu().numpy(),
                "history": net.history,
            })
    finally:
        mesh._dist = real_dist
    return out


# --------------------------------------------------------------------------
# The verdicts (pure functions over the recorded calls)
# --------------------------------------------------------------------------


def oversized_all_reduces(calls: List[Dict[str, Any]], max_elements: int) -> List[int]:
    """Element counts of the recorded all_reduces above ``max_elements``."""
    return [c["numel"] for c in calls if c["op"] == "all_reduce" and c["numel"] > max_elements]


def inventory_cell_findings(rule: str, label: str, calls: List[Dict[str, Any]],
                            max_elements: int, faulted: bool = False) -> List[Finding]:
    """MUR1300 over one cell's recorded round."""
    path, line = rule_anchor(rule)
    findings: List[Finding] = []
    if rule not in SHARDED_EXEMPT:
        turns = Counter(c["caller"] for c in calls if c["op"] == "all_to_all_single")
        want = Counter({"rows_to_columns": 1 + int(faulted), "columns_to_rows": 1})
        if turns != want:
            findings.append(Finding(
                "MUR1300", path, line,
                f"[{label}] a sharded round made the all_to_all turns "
                f"{dict(turns)}, not {dict(want)} — one rows_to_columns (and "
                "one of the pre-round rows on a faulted program) and one "
                "columns_to_rows a round",
            ))
    big = oversized_all_reduces(calls, max_elements)
    if big:
        findings.append(Finding(
            "MUR1300", path, line,
            f"[{label}] all_reduce of {big} elements exceeds N * max(N, k, S) "
            f"= {max_elements} — a full-width [N, P] reduction in a sharded "
            "round",
        ))
    return findings


def inventory_parity_findings(rule_id: str, rule: str, label: str, plain, lever) -> List[Finding]:
    """MUR1002/1102/1202: the lever's round makes the plain round's set of
    (collective, mesh function) calls."""
    path, line = rule_anchor(rule)
    a = {(c["op"], c["caller"]) for c in plain}
    b = {(c["op"], c["caller"]) for c in lever}
    if a == b:
        return []
    return [Finding(
        rule_id, path, line,
        f"[{label}] the lever's sharded round adds {sorted(b - a)} and drops "
        f"{sorted(a - b)} against the plain round's collectives — the lever "
        "must not change the round's communication",
    )]


def warm_build_findings(rule: str, label: str, builds: int) -> List[Finding]:
    """MUR1301: builds after the first round."""
    if not builds:
        return []
    path, line = rule_anchor(rule)
    return [Finding(
        "MUR1301", path, line,
        f"[{label}] {builds} program or kernel build(s) after the sharded "
        "cell's first round — shard layout is program structure, round data "
        "is values",
    )]


def execution_parity_findings(rule: str, label: str, sharded: np.ndarray,
                              single: np.ndarray) -> List[Finding]:
    """MUR1303: the group's parameters against one process's."""
    path, line = rule_anchor(rule)
    if sharded.shape == single.shape and np.allclose(sharded, single, rtol=_PARITY_RTOL,
                                                    atol=_PARITY_ATOL):
        return []
    err = (float(np.abs(sharded - single).max()) if sharded.shape == single.shape
           else f"shape {sharded.shape} vs {single.shape}")
    return [Finding(
        "MUR1303", path, line,
        f"[{label}] the group's parameters after 3 rounds differ from the "
        f"one-process run (max |delta| {err}, rtol {_PARITY_RTOL}, atol "
        f"{_PARITY_ATOL}) — the shard-local partial sums may regroup float32 "
        "sums, not change the math",
    )]


# --------------------------------------------------------------------------
# The families
# --------------------------------------------------------------------------


def group_cases() -> List[Dict[str, Any]]:
    """Every cell the group runs: each rule in both sharded modes, and each
    non-exempt rule's lever and plain rounds (circulant)."""
    from murmura_tpu_torch.aggregation import AGGREGATORS

    cases = []
    for rule in sorted(AGGREGATORS):
        for mode in SHARDED_MODES:
            cases.append({"label": f"{rule}/{mode}", "rule": rule, "kind": "cell",
                          "raw": sharded_raw(rule, mode)})
        if rule in SHARDED_EXEMPT:
            continue
        for lever, (_, on, off) in LEVER_PARITY.items():
            for side, patch in (("lever", on), ("plain", off)):
                if side == "plain" and not patch:
                    continue  # the circulant cell above is the plain round
                cases.append({"label": f"{rule}/{lever}/{side}", "rule": rule,
                              "kind": side, "lever": lever,
                              "raw": sharded_raw(rule, "circulant", patch=patch)})
    return cases


def run_group(device):
    """The ranks' results for :func:`group_cases`, one list a rank: the
    cells in a group of :data:`WORLD` on ``device``."""
    import torch

    from murmura_tpu_torch.parallel.launch import launch

    dev = torch.device(device)
    return launch(sharded_rank_cases, (group_cases(),), world=WORLD, device_type=dev.type,
                  one_device=dev.type == "cuda")


def inventory_findings(cases, ranks) -> List[Finding]:
    """MUR1300, MUR1301 and the lever parities over each rank's record of
    ``cases``."""
    findings: List[Finding] = []
    for rank, results in enumerate(ranks):
        by_label = {r["label"]: r for r in results}
        for case, res in zip(cases, results):
            label = f"{case['label']} rank {rank}"
            findings += warm_build_findings(case["rule"], label, res["builds"])
            faulted = case["raw"].get("faults", {}).get("enabled", False)
            findings += inventory_cell_findings(case["rule"], label, res["calls"],
                                                all_reduce_bound(case["raw"]), faulted)
            if case["kind"] == "lever":
                rule_id, _, off = LEVER_PARITY[case["lever"]]
                plain = (f"{case['rule']}/{case['lever']}/plain" if off
                         else f"{case['rule']}/circulant")
                findings += inventory_parity_findings(rule_id, case["rule"], label,
                                                      by_label[plain]["calls"], res["calls"])
    return findings


def group_parity_findings(cases, ranks, device) -> List[Finding]:
    """MUR1303: each sharded cell's parameters (rank 0's gather) against
    the same config run in this process, unsharded on the padded vector."""
    from murmura_tpu_torch.analysis.cells import build_network

    findings: List[Finding] = []
    for case, res in zip(cases, ranks[0]):
        if case["kind"] != "cell":
            continue
        net = build_network(case["raw"], device)
        net.train(rounds=3)
        findings += execution_parity_findings(case["rule"], case["label"], res["flat"],
                                              net.flat.float().cpu().numpy())
    return findings


@_family
def check_sharded_group(device) -> List[Finding]:
    """MUR1300-1301, MUR1303 and the lever parities over one group's run of
    :func:`group_cases`."""
    cases = group_cases()
    ranks = run_group(device)
    return inventory_findings(cases, ranks) + group_parity_findings(cases, ranks, device)


def shards1_findings(rule: str, one, ref) -> List[Finding]:
    """MUR1302 over two trained networks: ``one`` at ``param_shards: 1``,
    ``ref`` without it."""
    from murmura_tpu_torch.analysis.durability import bits_equal, history_equal

    problems = []
    if one.program.flat_dim != one.program.model_dim:
        problems.append(f"flat_dim {one.program.flat_dim} != model_dim "
                        f"{one.program.model_dim} (a pad at 1 shard)")
    if not bits_equal(one.flat, ref.flat):
        problems.append("parameters differ")
    if set(one.agg_state) != set(ref.agg_state) or not all(
            bits_equal(one.agg_state[k], ref.agg_state[k]) for k in ref.agg_state):
        problems.append("carried state differs")
    if not history_equal(one.history, ref.history):
        problems.append("history differs")
    if not problems:
        return []
    path, line = rule_anchor(rule)
    return [Finding(
        "MUR1302", path, line,
        f"[{rule}] tpu.param_shards: 1 is not bit-equal to the unsharded "
        f"program: {'; '.join(problems)}",
    )]


@_family
def check_shards1_bit_parity(device) -> List[Finding]:
    """MUR1302: ``tpu.param_shards: 1`` against no param_shards at all,
    every rule, 2 rounds."""
    from murmura_tpu_torch.aggregation import AGGREGATORS
    from murmura_tpu_torch.analysis.cells import build_network

    findings: List[Finding] = []
    for rule in sorted(AGGREGATORS):
        raw = sharded_raw(rule, "circulant", shards=1)
        plain = copy.deepcopy(raw)
        plain["tpu"].pop("param_shards")
        nets = [build_network(r, device) for r in (raw, plain)]
        for net in nets:
            net.train(rounds=2)
        findings += shards1_findings(rule, *nets)
    return findings


def check_sharded(device="cuda") -> List[Finding]:
    """MUR1300-1303 and the lever parities."""
    return run_families(SHARDED_CHECK_FAMILIES, "MUR1300", __file__, device)
