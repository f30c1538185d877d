# Copy of murmura_tpu/telemetry/registry.py.
"""The cross-run registry: one index over every run under some roots.

``runs [roots...]`` walks telemetry roots (default: the working
directory) and the serve state dirs it finds, and emits one
row per run directory / ledger submission: kind, run id, schema
version, config fingerprint (the serve scheduler's structural
fingerprint, so "which runs shared a compiled bucket" is answerable
offline), platform stamp, rounds, best accuracy, and terminal state —
with torn event streams flagged instead of hidden.  ``report --latest``
is sugar over :func:`find_latest`.

Read-only by construction: the index opens manifests/ledgers/streams
and never writes.
"""

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from murmura_tpu_torch.telemetry.schema import EVENTS_FILE, MANIFEST_FILE


def _torn_tail(run_dir: Path) -> bool:
    """Whether events.jsonl ends in a torn (unparseable) line."""
    path = run_dir / EVENTS_FILE
    try:
        raw = path.read_bytes()
    except OSError:
        return False
    if not raw.strip():
        return False
    last = raw.strip().rsplit(b"\n", 1)[-1]
    try:
        json.loads(last.decode("utf-8"))
        return False
    except (UnicodeDecodeError, json.JSONDecodeError):
        return True


def _best_accuracy(history: Optional[Dict[str, Any]]) -> Optional[float]:
    if not isinstance(history, dict):
        return None
    series = history.get("honest_accuracy") or history.get("mean_accuracy")
    try:
        return max(float(v) for v in series) if series else None
    except (TypeError, ValueError):
        return None


def _fingerprint(config: Optional[Dict[str, Any]]) -> Optional[str]:
    if not isinstance(config, dict):
        return None
    try:
        from murmura_tpu_torch.config.schema import Config
        from murmura_tpu_torch.serve.scheduler import structural_fingerprint

        return structural_fingerprint(Config.model_validate(config))
    except Exception:  # noqa: BLE001 — old/partial configs index as None
        return None


def index_run_dir(run_dir) -> Dict[str, Any]:
    """One index row for one run directory."""
    from murmura_tpu_torch.telemetry.writer import iter_events, read_manifest

    run_dir = Path(run_dir)
    manifest = read_manifest(run_dir)
    events = list(iter_events(run_dir))
    rounds = sum(1 for e in events if e.get("type") == "round")
    if manifest is None:
        status = "no-manifest"
    elif manifest.get("finalized"):
        status = "finalized"
    else:
        status = "in-progress"
    manifest = manifest or {}
    return {
        "path": str(run_dir),
        "kind": manifest.get("kind"),
        "run_id": manifest.get("run_id"),
        "schema_version": manifest.get("schema_version"),
        "created_unix": manifest.get("created_unix"),
        "platform": (
            (manifest.get("summary") or {}).get("platform")
            or (manifest.get("config") or {}).get("backend")
        ),
        "fingerprint": _fingerprint(manifest.get("config")),
        "rounds": rounds,
        "best_accuracy": _best_accuracy(manifest.get("history")),
        "status": status,
        "torn_tail": _torn_tail(run_dir),
        "num_events": len(events),
    }


def index_submission(record_path) -> Dict[str, Any]:
    """One index row for one serve-ledger submission record."""
    record_path = Path(record_path)
    try:
        rec = json.loads(record_path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return {
            "path": str(record_path), "kind": "submission",
            "status": "unreadable", "torn_tail": True,
        }
    return {
        "path": str(record_path),
        "kind": "submission",
        "run_id": rec.get("id"),
        "schema_version": None,
        "created_unix": rec.get("submitted_at"),
        "platform": (rec.get("config") or {}).get("backend"),
        "fingerprint": rec.get("fingerprint"),
        "rounds": rec.get("rounds"),
        "best_accuracy": _best_accuracy(rec.get("history")),
        "status": rec.get("state"),
        "torn_tail": False,
        "num_events": None,
    }


def index_runs(roots) -> List[Dict[str, Any]]:
    """Walk ``roots`` and index every run directory and serve ledger.

    A run directory is any directory holding a manifest or event stream;
    a serve state dir is recognized by its ``submissions/`` ledger.
    Rows sort newest-first (unknown creation time last)."""
    rows: List[Dict[str, Any]] = []
    seen: set = set()
    for root in roots:
        root = Path(root)
        if not root.exists():
            continue
        candidates = [root] + [p for p in root.rglob("*") if p.is_dir()]
        for d in candidates:
            if d in seen:
                continue
            if (d / MANIFEST_FILE).exists() or (d / EVENTS_FILE).exists():
                seen.add(d)
                rows.append(index_run_dir(d))
            if d.name == "submissions" and d.is_dir():
                for rec in sorted(d.glob("*.json")):
                    if rec in seen:
                        continue
                    seen.add(rec)
                    rows.append(index_submission(rec))
    rows.sort(
        key=lambda r: (r.get("created_unix") is None,
                       -(r.get("created_unix") or 0.0), r["path"])
    )
    return rows


def find_latest(roots) -> Optional[Dict[str, Any]]:
    """The newest indexed run DIRECTORY (submissions are ledger rows,
    not reportable dirs): ``report --latest``."""
    for row in index_runs(roots):
        if row["kind"] != "submission" and row.get("created_unix"):
            return row
    return None


def render_rows(rows: List[Dict[str, Any]]) -> str:
    """Plain-text table of index rows (the --json twin is the raw list)."""
    headers = ("run_id", "kind", "status", "rounds", "best_acc",
               "platform", "schema", "torn", "path")
    table: List[List[str]] = [list(headers)]
    for r in rows:
        acc = r.get("best_accuracy")
        table.append([
            str(r.get("run_id") or "-"),
            str(r.get("kind") or "-"),
            str(r.get("status") or "-"),
            str(r.get("rounds") if r.get("rounds") is not None else "-"),
            f"{acc:.4f}" if isinstance(acc, float) else "-",
            str(r.get("platform") or "-"),
            str(r.get("schema_version") or "-"),
            "TORN" if r.get("torn_tail") else "",
            str(r.get("path")),
        ])
    widths = [max(len(row[i]) for row in table) for i in range(len(headers))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in table
    ]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
