# Counterpart of murmura_tpu/analysis/durability.py.
"""MUR901/902: the resume-determinism contract (``check --durability``).

MUR900 (analysis/contracts.py) proves the snapshot payload is complete;
this module proves it is sufficient.  Per (rule, exchange mode) cell:

- **MUR901 — crash-equivalence**: train 2 rounds, snapshot, train 2 more
  (the uninterrupted tail), restore the snapshot into the same network and
  replay the tail.  History, parameters and the whole ``agg_state`` must
  match bit for bit.
- **MUR902 — build-free restore**: the restore and the replay run under
  :class:`~murmura_tpu_torch.analysis.sanitizers.CompileTracker`: a
  restore that builds a round program or starts an nvcc build is a
  finding (the restored tensors must land with the shapes and dtypes the
  warm program was built for).

The grid is ``AGGREGATORS x (dense, circulant, sparse)``: on the card the
dense cells launch the pairwise distance kernel (Krum, BALANCE, UBAR, the
geometric median), the circulant cells the circulant distance kernel and
the candidate select (median, trimmed mean), and Sketchguard's cells the
Count-Sketch kernel.  Findings anchor at the rule's factory ``def``.
"""

import tempfile
from typing import Any, Dict, List, Optional

import torch

from murmura_tpu_torch.analysis.cells import (
    EXCHANGE_MODES,
    base_raw,
    build_network,
    family_registry,
    rule_anchor,
    run_families,
    with_exchange,
)
from murmura_tpu_torch.analysis.lint import Finding

DURABILITY_CHECK_FAMILIES, _family = family_registry()


def history_equal(a: Any, b: Any) -> bool:
    """Recursive equality over json-able history values, with NaN == NaN
    (a metric that is legitimately NaN must not read as divergence)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(history_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(history_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    return a == b


def bits_equal(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> bool:
    """Same dtype, shape and bytes (NaN payloads included)."""
    if a is None or b is None:
        return a is b
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def cell_raw(rule: str, mode: str) -> Dict[str, Any]:
    """The (rule, mode) cell: the tiny cell, 4 rounds, under ``mode``."""
    return with_exchange(base_raw(f"durability-{rule}-{mode}", rule), mode)


def resume_cell_findings(rule: str, mode: str, device="cuda", network=None) -> List[Finding]:
    """ONE (rule, mode) cell of the contract (empty = crash-equivalent).
    ``network`` replaces the cell's network (the tests plant a snapshot
    that drops a key)."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles

    path, line = rule_anchor(rule)
    net = network if network is not None else build_network(cell_raw(rule, mode), device)
    with tempfile.TemporaryDirectory() as snap:
        net.train(rounds=2)
        net.save_checkpoint(snap)
        net.train(rounds=2)
        full_hist = {k: list(v) for k, v in net.history.items()}
        full_flat = net.flat.clone()
        full_agg = {k: v.clone() for k, v in net.agg_state.items()}
        with track_compiles() as tracker:
            restored_round = net.restore_checkpoint(snap)
            if restored_round != 2:
                return [Finding(
                    "MUR901", path, line,
                    f"[{rule}/{mode}] snapshot saved at round 2 restored to "
                    f"round {restored_round} — the round counter did not "
                    "survive the roundtrip",
                )]
            net.train(rounds=2)
        compiles = tracker.total

    findings: List[Finding] = []
    resumed_hist = {k: list(v) for k, v in net.history.items()}
    if not history_equal(resumed_hist, full_hist):
        diverged = sorted(
            k for k in set(full_hist) | set(resumed_hist)
            if not history_equal(full_hist.get(k), resumed_hist.get(k))
        )
        findings.append(Finding(
            "MUR901", path, line,
            f"[{rule}/{mode}] resumed history diverges from the "
            f"uninterrupted run in {diverged} — save->restore->round is not "
            "bit-equal to the uninterrupted round; some round-crossing "
            "state is missing from the snapshot",
        ))
    if not bits_equal(full_flat, net.flat):
        findings.append(Finding(
            "MUR901", path, line,
            f"[{rule}/{mode}] resumed parameters diverge bit-wise from the "
            "uninterrupted run — the parameter section does not reproduce "
            "the interrupted trajectory",
        ))
    for key in sorted(set(full_agg) | set(net.agg_state)):
        if not bits_equal(full_agg.get(key), net.agg_state.get(key)):
            findings.append(Finding(
                "MUR901", path, line,
                f"[{rule}/{mode}] carried agg_state key '{key}' diverges "
                "after resume — the round-crossing state is not "
                "crash-equivalent",
            ))
    if compiles:
        findings.append(Finding(
            "MUR902", path, line,
            f"[{rule}/{mode}] a warm restore and its 2 replayed rounds built "
            f"{compiles} program(s) or kernel(s) — restore must be "
            "value-only into the already-built round program",
        ))
    return findings


@_family
def check_resume_determinism(device) -> List[Finding]:
    """MUR901/902 over ``AGGREGATORS x EXCHANGE_MODES``; a cell that
    crashes is itself a MUR901 finding."""
    from murmura_tpu_torch.aggregation import AGGREGATORS

    findings: List[Finding] = []
    for rule in sorted(AGGREGATORS):
        for mode in EXCHANGE_MODES:
            try:
                findings.extend(resume_cell_findings(rule, mode, device))
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                path, line = rule_anchor(rule)
                findings.append(Finding(
                    "MUR901", path, line,
                    f"[{rule}/{mode}] resume-determinism probe crashed: "
                    f"{type(e).__name__}: {e}",
                ))
    return findings


def check_durability(device="cuda") -> List[Finding]:
    """MUR901/902 over the grid."""
    return run_families(DURABILITY_CHECK_FAMILIES, "MUR901", __file__, device)
