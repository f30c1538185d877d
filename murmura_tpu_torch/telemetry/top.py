# Copy of murmura_tpu/telemetry/top.py.
"""``top``: a refreshing live view of a serve daemon, built entirely on
the read-only protocol ops (ping, list, metrics).  No new daemon state:
everything the dashboard shows is a projection of responses the ops
already serve, so a top session is a polling loop a tenant cannot
observe (no build, the same histories under scrape).
"""

import time
from typing import Any, Dict, List, Optional

from murmura_tpu_torch.telemetry.metrics import parse_openmetrics


def gather(socket_path: str) -> Dict[str, Any]:
    """One snapshot: ping + list + metrics over the socket."""
    from murmura_tpu_torch.serve.protocol import send_request

    snap: Dict[str, Any] = {"t": time.time()}
    snap["ping"] = send_request(str(socket_path), {"op": "ping"})
    snap["list"] = send_request(str(socket_path), {"op": "list"})
    metrics = send_request(str(socket_path), {"op": "metrics"})
    snap["metrics"] = (
        parse_openmetrics(metrics["text"]) if metrics.get("ok") else {}
    )
    return snap


def _tenant_metric(metrics: Dict, name: str, tenant: str) -> Optional[float]:
    for (sample, labels), value in metrics.items():
        if sample == name and ("tenant", tenant) in labels:
            return value
    return None


def render_snapshot(snap: Dict[str, Any]) -> str:
    """The dashboard as plain text (one frame; the CLI loop redraws).

    Header: daemon liveness + the satellite counters (uptime, version,
    schema, cumulative admissions/evictions/resumes/compiles).  Body:
    the tenant table (state / rounds / accuracy / mean round seconds)
    and the bucket occupancy census."""
    ping = snap.get("ping") or {}
    rows: List[Dict[str, Any]] = (snap.get("list") or {}).get(
        "submissions", []
    )
    metrics = snap.get("metrics") or {}
    counters = ping.get("counters") or {}
    lines: List[str] = []
    uptime = ping.get("uptime_s")
    lines.append(
        "murmura top — pid {pid}  up {up}  v{ver} schema v{schema}  "
        "queued {queued}".format(
            pid=ping.get("pid", "?"),
            up=f"{uptime:.0f}s" if isinstance(uptime, (int, float)) else "?",
            ver=ping.get("version", "?"),
            schema=ping.get("schema_version", "?"),
            queued=ping.get("queued", "?"),
        )
    )
    lines.append(
        "admissions {a}  evictions {e}  resumes {r}  compiles {c}  "
        "generations {g}".format(
            a=counters.get("admissions", 0),
            e=counters.get("evictions", 0),
            r=counters.get("resumes", 0),
            c=counters.get("compiles", 0),
            g=counters.get("generations", 0),
        )
    )
    lines.append("")
    header = ("id", "state", "bucket", "rounds", "acc", "round_s")
    table = [list(header)]
    for row in rows:
        tenant = str(row.get("id"))
        rounds = _tenant_metric(metrics, "murmura_rounds_total", tenant)
        wall_sum = _tenant_metric(
            metrics, "murmura_round_wall_seconds_sum", tenant
        )
        wall_n = _tenant_metric(
            metrics, "murmura_round_wall_seconds_count", tenant
        )
        acc = row.get("final_accuracy")
        table.append([
            tenant,
            str(row.get("state", "-")),
            str(row.get("bucket", "-"))[:12],
            str(int(rounds)) if rounds is not None else "-",
            f"{acc:.4f}" if isinstance(acc, float) else "-",
            f"{wall_sum / wall_n:.3f}" if wall_sum and wall_n else "-",
        ])
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    for i, row in enumerate(table):
        lines.append(
            "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
        )
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    lines.append("")
    buckets = ping.get("buckets") or {}
    if buckets:
        lines.append("buckets:")
        for fp, b in sorted(buckets.items()):
            lines.append(
                f"  {fp[:16]}  gen {b.get('gen')}  lanes "
                f"{b.get('running')}/{b.get('batch')}"
            )
    else:
        lines.append("buckets: (none warm)")
    age = snap.get("t")
    if age is not None:
        lines.append(f"snapshot age: {time.time() - age:.1f}s")
    return "\n".join(lines)


def run_top(
    socket_path: str,
    *,
    interval_s: float = 1.0,
    iterations: Optional[int] = None,
    echo=print,
    clear: bool = True,
) -> None:
    """The polling loop. ``iterations=None`` runs until interrupted;
    tests pass a bound (and ``clear=False``) to capture frames."""
    n = 0
    while iterations is None or n < iterations:
        snap = gather(socket_path)
        frame = render_snapshot(snap)
        if clear:
            echo("\033[2J\033[H" + frame)
        else:
            echo(frame)
        n += 1
        if iterations is not None and n >= iterations:
            break
        time.sleep(interval_s)
