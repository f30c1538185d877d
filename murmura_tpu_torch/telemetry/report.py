# Copy of build_report, render_frontier, render_grid and their helpers from
# murmura_tpu/telemetry/report.py, rendered as plain text.
"""``python -m murmura_tpu_torch report <run_dir>``: read a run manifest and
event stream back.

Reads only the telemetry schema (schema.py), so it renders a run directory
either package wrote.  Sections appear only when their data exists.
``render_report`` prints plain text (the JAX package's renderer draws
``rich`` tables; the port's CLI prints plain lines); ``render_frontier``
and ``render_grid`` do the same for a frontier artifact and a grid
manifest (``report --frontier``, ``report --grid``), with the JAX tables'
rows (``grid_tables``).
"""

import math
from typing import Any, Dict, List, Optional

from murmura_tpu_torch.telemetry.schema import KIND_BENCH
from murmura_tpu_torch.telemetry.writer import iter_events, read_manifest


def _fmt(v: Any, nd: int = 4) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        return f"{v:.{nd}f}"
    return str(v)


def _mean(xs: List[float]) -> float:
    finite = [x for x in xs if isinstance(x, (int, float)) and math.isfinite(x)]
    return sum(finite) / len(finite) if finite else float("nan")


def build_report(run_dir) -> Dict[str, Any]:
    """Machine-readable report dict (the renderer's one source)."""
    manifest = read_manifest(run_dir)
    if manifest is None:
        raise FileNotFoundError(
            f"no readable manifest.json under {run_dir} — not a telemetry run directory"
        )
    events = list(iter_events(run_dir))
    report: Dict[str, Any] = {"manifest": manifest, "run_dir": str(run_dir)}

    history = manifest.get("history") or {}
    if history.get("round"):
        finite_acc = [
            a for a in history["mean_accuracy"]
            if isinstance(a, (int, float)) and math.isfinite(a)
        ]
        acc: Dict[str, Any] = {
            "rounds_recorded": len(history["round"]),
            "final_round": history["round"][-1],
            "final_mean_accuracy": history["mean_accuracy"][-1],
            # Over finite entries only: one NaN row must not poison the best.
            "best_mean_accuracy": max(finite_acc, default=float("nan")),
            "final_mean_loss": history["mean_loss"][-1],
        }
        if history.get("honest_accuracy"):
            acc["final_honest_accuracy"] = history["honest_accuracy"][-1]
        if history.get("compromised_accuracy"):
            acc["final_compromised_accuracy"] = history["compromised_accuracy"][-1]
        report["accuracy"] = acc

        robustness = {
            k: {"mean": _mean(v), "last": v[-1] if v else None}
            for k, v in history.items()
            if k.startswith("agg_") and not k.startswith("agg_tap_")
        }
        for k in ("skipped_nodes", "reporting_nodes"):
            if history.get(k):
                robustness[k] = {"mean": _mean(history[k]), "last": history[k][-1]}
        if robustness:
            report["robustness"] = robustness

    # ---- time breakdown -------------------------------------------------
    phase = [e for e in events if e.get("type") == "phase_times"]
    if phase:
        by_mode: Dict[str, List[float]] = {}
        for e in phase:
            by_mode.setdefault(e.get("mode", "?"), []).append(e.get("wall_s", 0.0))
        report["time"] = {
            "rounds_timed": len(phase),
            "total_s": sum(sum(v) for v in by_mode.values()),
            "by_mode": {
                m: {"rounds": len(v), "mean_s": _mean(v), "max_s": max(v)}
                for m, v in by_mode.items()
            },
        }
        # Pipelined rounds (a JAX package run dir): each wall_s is the
        # round's critical path, its train and delayed aggregate overlap.
        overlapped = [e for e in phase if e.get("overlap")]
        if overlapped:
            walls = [e.get("wall_s", 0.0) for e in overlapped]
            report["time"]["critical_path"] = {
                "overlap": overlapped[0].get("overlap"),
                "rounds": len(overlapped),
                "mean_s": _mean(walls),
                "total_s": sum(walls),
                "concurrent_phases": [
                    "murmura.train",
                    "murmura.aggregate (delayed, round r-1)",
                ],
                "note": (
                    "wall_s is the per-round critical path; the "
                    "exchange+aggregate bracket runs concurrently with "
                    "training and must not be added to it (see "
                    "bench_breakdown's pipeline hidden-fraction cells "
                    "for the overlapped segment's size)"
                ),
            }
    ckpt = [e for e in events if e.get("type") == "checkpoint"]
    if ckpt:
        saves = [e for e in ckpt if e.get("action") == "save"]
        report["checkpoints"] = {
            "saves": len(saves),
            "restores": len(ckpt) - len(saves),
            "total_save_s": sum(e.get("duration_s", 0.0) for e in saves),
        }
    mem = [
        e for e in events
        if e.get("type") == "memory" and isinstance(e.get("stats"), dict)
    ]
    if mem:
        peaks = [
            e["stats"].get("peak_bytes_in_use") or e["stats"].get("bytes_in_use")
            for e in mem
        ]
        peaks = [p for p in peaks if isinstance(p, (int, float))]
        if peaks:
            report["memory"] = {
                "samples": len(mem),
                "peak_bytes_in_use": max(peaks),
                "device_kind": mem[-1].get("device_kind"),
            }
    prof = [e for e in events if e.get("type") == "profile"]
    if prof:
        report["profile"] = prof

    # ---- faults (per-node quarantine/alive from round events) -----------
    rounds = [e for e in events if e.get("type") == "round"]
    faults: Dict[str, Any] = {}
    for key, out in (
        ("agg_tap_quarantined", "quarantined_rounds"),
        ("agg_tap_attack_scrubbed", "scrubbed_rounds"),
        ("agg_tap_alive", "alive_rounds"),
    ):
        per_node = _per_node_sum(rounds, key)
        if per_node is not None:
            faults[out] = per_node
    if faults:
        report["faults"] = faults

    # ---- audit taps: per-node acceptance/rejection ----------------------
    taps = _tap_report(rounds)
    if taps:
        report["taps"] = taps

    # ---- bounded staleness: per-node stale in-edges, served ages --------
    stale = _stale_report(rounds)
    if stale:
        report["staleness"] = stale

    # ---- the rule's declared influence contract -------------------------
    influence = _declared_influence(manifest)
    if influence:
        report["influence"] = influence

    counters = manifest.get("counters") or {}
    if counters:
        report["counters"] = counters
    if manifest.get("kind") == KIND_BENCH:
        report["bench"] = manifest.get("summary") or {}
    return report


def _declared_influence(manifest: dict) -> Optional[Dict[str, Any]]:
    """The configured rule's declared influence contract, from the
    manifest's config snapshot through the port's rule registry; None for
    a manifest without a usable aggregation config."""
    cfg = manifest.get("config") or {}
    agg_cfg = cfg.get("aggregation") or {}
    algo = agg_cfg.get("algorithm")
    if not algo:
        return None
    from murmura_tpu_torch.aggregation import build_aggregator

    try:
        agg = build_aggregator(algo, dict(agg_cfg.get("params") or {}), model_dim=1)
    except (ValueError, TypeError):  # an old snapshot stays renderable
        return None
    decl = agg.influence
    if decl is None:
        return None
    return {
        "rule": algo,
        "kind": decl.kind,
        "declared": decl.describe(),
        "note": decl.note,
    }


def _per_node_sum(rounds: List[dict], key: str) -> Optional[List[float]]:
    rows = [
        e["metrics"][key] for e in rounds
        if isinstance(e.get("metrics"), dict)
        and isinstance(e["metrics"].get(key), list)
    ]
    if not rows:
        return None
    n = max(len(r) for r in rows)
    out = [0.0] * n
    for r in rows:
        for i, v in enumerate(r):
            if isinstance(v, (int, float)) and math.isfinite(v):
                out[i] += v
    return out


def _stale_report(rounds: List[dict]) -> Optional[Dict[str, Any]]:
    """Per-node stale in-edge totals and the histogram of served ages
    (``agg_tap_stale_used`` / ``agg_tap_stale_age``, core/stale.py)."""
    used = _per_node_sum(rounds, "agg_tap_stale_used")
    if used is None:
        return None
    out: Dict[str, Any] = {
        "stale_in_edges": used,
        "total_stale_edges": sum(used),
    }
    hist: Dict[str, int] = {}
    for e in rounds:
        metrics = e.get("metrics")
        row = metrics.get("agg_tap_stale_age") if isinstance(metrics, dict) else None
        if not isinstance(row, list):
            continue
        for a in row:
            if isinstance(a, (int, float)) and math.isfinite(a) and a > 0:
                hist[str(int(a))] = hist.get(str(int(a)), 0) + 1
    if hist:
        out["age_histogram"] = dict(sorted(hist.items(), key=lambda kv: int(kv[0])))
    return out


def _tap_report(rounds: List[dict]) -> Optional[Dict[str, Any]]:
    """Per-node selection/rejection totals from the audit taps:
    ``agg_tap_selected_by`` (how many peers selected node i's broadcast),
    ``agg_tap_considered_by`` (how many had it as a candidate), and their
    difference, the rejections, summed over the recorded rounds."""
    selected = _per_node_sum(rounds, "agg_tap_selected_by")
    if selected is None:
        return None
    considered = _per_node_sum(rounds, "agg_tap_considered_by")
    out: Dict[str, Any] = {"selected_by": selected}
    if considered is not None:
        out["considered_by"] = considered
        out["rejections"] = [max(0.0, c - s) for c, s in zip(considered, selected)]
    return out


# ----------------------------------------------------------------------
# rendering


def _table(title: str, header: List[str], rows: List[List[str]], out) -> None:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    out(title)
    out("  " + "  ".join(h.rjust(w) for h, w in zip(header, widths)))
    for r in rows:
        out("  " + "  ".join(c.rjust(w) for c, w in zip(r, widths)))


def render_report(run_dir, out=print) -> Dict[str, Any]:
    """Print the report as plain text through ``out``; returns its dict."""
    report = build_report(run_dir)
    m = report["manifest"]
    cfg = m.get("config") or {}
    exp = cfg.get("experiment") or {}
    out(
        f"murmura report — run {exp.get('name', m.get('run_id'))} "
        f"(kind={m.get('kind')}, schema=v{m.get('schema_version')}, "
        f"run_id={m.get('run_id')}, "
        f"{'finalized' if m.get('finalized') else 'IN PROGRESS'})"
    )

    def kv_table(title: str, mapping: Dict[str, Any]) -> None:
        _table(title, ["metric", "value"], [[k, _fmt(v)] for k, v in mapping.items()], out)

    if "accuracy" in report:
        kv_table("Accuracy", report["accuracy"])
    if "robustness" in report:
        _table("Robustness / rule statistics (over recorded rounds)", ["stat", "mean", "last"],
               [[k, _fmt(v["mean"]), _fmt(v["last"])]
                for k, v in sorted(report["robustness"].items())], out)
    if "time" in report:
        _table("Time breakdown", ["dispatch mode", "rounds", "mean s/round", "max s"],
               [[mode, str(v["rounds"]), _fmt(v["mean_s"]), _fmt(v["max_s"])]
                for mode, v in report["time"]["by_mode"].items()], out)
        out(f"  total timed: {_fmt(report['time']['total_s'], 2)}s over "
            f"{report['time']['rounds_timed']} round records")
        cp = report["time"].get("critical_path")
        if cp:
            out(f"  critical path ({cp['overlap']}): {cp['rounds']} rounds at "
                f"{_fmt(cp['mean_s'])}s/round — {' + '.join(cp['concurrent_phases'])} run "
                "concurrently; per-phase brackets must not be summed")
    if "checkpoints" in report:
        kv_table("Checkpoints", report["checkpoints"])
    if "memory" in report:
        kv_table("Device memory", report["memory"])
    for e in report.get("profile", []):
        out(f"  profile {e.get('status')} at round {e.get('round')}: {e.get('trace_dir')}")
    if "influence" in report:
        inf = report["influence"]
        out(f"  declared influence ({inf['rule']}): {inf['declared']}")
    if "staleness" in report:
        stale = report["staleness"]
        hist = stale.get("age_histogram") or {}
        hist_txt = ("  ages " + "  ".join(f"{a}r:{c}" for a, c in hist.items())) if hist else ""
        out(f"  bounded staleness: {_fmt(stale['total_stale_edges'], 0)} stale edge-serves "
            f"over recorded rounds{hist_txt}")
    if "taps" in report or "faults" in report or "staleness" in report:
        taps = report.get("taps") or {}
        faults = report.get("faults") or {}
        stale_cols = {
            k: v for k, v in (report.get("staleness") or {}).items() if k == "stale_in_edges"
        }
        n = max(
            [len(v) for v in taps.values()]
            + [len(v) for v in faults.values()]
            + [len(v) for v in stale_cols.values()]
        )
        header, cols = ["node"], []
        for key, src in (
            ("selected_by", taps), ("considered_by", taps),
            ("rejections", taps), ("quarantined_rounds", faults),
            ("scrubbed_rounds", faults), ("alive_rounds", faults),
            ("stale_in_edges", stale_cols),
        ):
            if key in src:
                header.append(key)
                cols.append(src[key])
        _table("Per-node audit (totals over recorded rounds)", header,
               [[str(i), *[_fmt(c[i], 1) if i < len(c) else "-" for c in cols]]
                for i in range(n)], out)
    if "counters" in report:
        kv_table("Counters", report["counters"])
    if "bench" in report:
        flat = {
            k: v for k, v in report["bench"].items()
            if isinstance(v, (int, float, str)) or v is None
        }
        kv_table("Bench summary", {k: "null" if v is None else v for k, v in flat.items()})
    extra = [e for e in iter_events(run_dir) if e.get("type") == "extra"]
    if extra:
        out(f"{len(extra)} forward-compat 'extra' event(s) — keys this version does not "
            "understand were preserved, not dropped")
    return report


def _bar(frac: float, width: int = 16) -> str:
    """An accuracy-fraction bar for the curve rows."""
    if not math.isfinite(frac):
        return "?" * width
    filled = int(round(max(0.0, min(1.0, frac)) * width))
    return "█" * filled + "·" * (width - filled)


def render_frontier(artifact: Dict[str, Any], out=print) -> None:
    """Print a frontier artifact (frontier.py) as plain text through
    ``out``: one table of each cell's empirical breaking point beside its
    declared influence bound, then each cell's honest-accuracy curve over
    attack strength, with the attacker's converged state.

    Read ``declared`` and ``broken at`` together: the first is what the
    rule's contract admits a coordinate, the second where an adversary
    that adapts pushed the rule off its honest-accuracy cliff."""
    from murmura_tpu_torch.frontier import frontier_break_summary

    grid = artifact.get("grid") or {}
    out(f"murmura frontier — {artifact.get('experiment', '?')} "
        f"(nodes={grid.get('num_nodes', '?')}, rounds={grid.get('rounds', '?')}, "
        f"seeds={grid.get('seeds', '?')}, break < {grid.get('break_fraction', '?')} x benign)")
    rows = []
    for row in frontier_break_summary(artifact):
        held, broken, kind = row["last_held"], row["first_broken"], row["declared_kind"]
        declared = ("undeclared" if kind is None
                    else f"bounded ≤ {row['declared_bound']}" if kind == "bounded"
                    else str(kind))
        pct = row.get("percentage")
        rows.append([
            str(row["rule"]), str(row["attack"]), str(row["topology"]),
            "-" if pct is None else f"{pct:g}", str(row["degree"]),
            _fmt(row["benign_accuracy"], 3),
            "-" if held is None else f"{held:.3g}",
            "never" if broken is None else f"{broken:.3g}",
            declared, str(row["compiles"]),
        ])
    _table("Breaking point vs declared influence bound (per cell)",
           ["rule", "attack", "topology", "pct", "deg", "benign acc", "held ≤", "broken at",
            "declared", "compiles"], rows, out)
    for cell in artifact.get("cells", []):
        benign = cell.get("benign_accuracy") or float("nan")
        curve = []
        for row in cell.get("curve", []):
            frac = (row["mean"] / benign if benign and math.isfinite(benign) and benign > 0
                    else float("nan"))
            adaptive = row.get("adaptive") or {}
            summary = ""
            if adaptive:
                # The mean converged state over the seeds.
                keys = sorted({k for d in adaptive.values() for k in d})
                summary = "  ".join(
                    f"{k}={_fmt(_mean([d.get(k, float('nan')) for d in adaptive.values()]), 2)}"
                    for k in ("atk_lo", "atk_z", "atk_accept_ema") if k in keys)
            curve.append([f"{row['strength']:.3g}", _fmt(row["mean"], 3),
                          _fmt(row.get("std", float("nan")), 3), _bar(frac), summary])
        _table(f"{cell['rule']} x {cell['attack']} x {cell['topology']} — honest accuracy vs "
               f"strength (benign {_fmt(benign, 3)})",
               ["strength", "mean acc", "std", "vs benign", "attacker state"], curve, out)


def grid_tables(artifact: Dict[str, Any]):
    """A grid manifest's two tables as (title, header, rows) triples: the
    buckets (cells, lanes, compiles, wall), then the cells (accuracy and
    seconds a round); each row's cells are the strings the JAX package's
    ``render_grid`` puts in its table."""
    buckets = []
    for b in artifact.get("buckets", []):
        buckets.append([
            str(b.get("key")), str(b.get("rule")), str(b.get("attack")),
            str(b.get("topology")), str(len(b.get("cells", []))),
            f"{b.get('gang_size', '?')}/{b.get('batch', '?')}",
            str(b.get("compiles")), _fmt(b.get("wall_s", float("nan")), 2),
        ])
    cells = []
    for c in artifact.get("cells", []):
        phase = c.get("phase_times") or {}
        cells.append([
            str(c.get("id")), str(c.get("bucket")),
            f"{c.get('strength', float('nan')):g}", str(c.get("seed")),
            _fmt(c.get("final_accuracy"), 3),
            _fmt(c.get("honest_accuracy"), 3),
            _fmt(phase.get("mean_round_s", float("nan")), 3),
        ])
    return [
        ("Buckets (one gang each)",
         ["bucket", "rule", "attack", "topology", "cells", "lanes", "compiles", "wall s"],
         buckets),
        ("Cells (accuracy by rule x attack x strength x seed)",
         ["cell", "bucket", "strength", "seed", "final acc", "honest acc", "mean round s"],
         cells),
    ]


def render_grid(artifact: Dict[str, Any], out=print) -> None:
    """Print a grid manifest (serve/scheduler.py) as plain text through
    ``out``: the headline, the bucket table, then the cell table.

    Read ``total_compiles`` against ``total_cells`` first: the scheduler's
    job is to make the first much smaller than the second (1 chunk program
    a bucket, plus each kernel's one ``nvcc`` build in a fresh process)."""
    grid = artifact.get("grid") or {}
    out(f"murmura grid — {artifact.get('experiment', '?')} "
        f"(nodes={grid.get('num_nodes', '?')}, rounds={grid.get('rounds', '?')}, "
        f"seeds={grid.get('seeds', '?')}): {artifact.get('total_cells', '?')} cells in "
        f"{len(artifact.get('buckets', []))} buckets, "
        f"{artifact.get('total_compiles', '?')} compiles")
    for title, header, rows in grid_tables(artifact):
        _table(title, header, rows, out)
