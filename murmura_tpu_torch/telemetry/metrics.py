# Copy of murmura_tpu/telemetry/metrics.py.
"""The one metrics registry: counters, gauges and histograms with labels,
rendered as OpenMetrics text.

Batch runs and the serve daemon share this registry: everything a scrape
can see is a *fold* of durable state — the event stream (events.jsonl),
the manifest counters, and the daemon's submission ledger — so a metrics
snapshot never invents numbers the artifacts cannot reproduce: a scraped
counter that a replay of the stream and the ledger cannot reconstruct is
a fault.

Consumers:

- the daemon's ``{"op": "metrics"}`` protocol op
  (:meth:`serve.daemon.ServeDaemon.metrics_registry` -> :func:`render_openmetrics`);
- ``metrics <socket|run_dir>`` (cli.py): the offline twin folds a run
  directory's stream through :func:`fold_run_events`;
- :func:`write_openmetrics_snapshot` drops a ``metrics.prom`` snapshot
  next to a manifest, scrapeable by stock Prometheus tooling.

Read path only: rendering takes the registry lock and touches no tensor,
and the daemon's handler never mutates gang state.
"""

import math
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

# Default histogram buckets: wall-time seconds spanning a 2ms fused CPU
# round to a multi-minute TPU generation.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0,
)

_TYPES = ("counter", "gauge", "histogram")

LabelDict = Optional[Mapping[str, Any]]
_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: LabelDict) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = key + extra
    if not pairs:
        return ""
    body = ",".join(
        f'{k}="{v}"'.replace("\n", " ")
        for k, v in pairs
    )
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """A minimal, dependency-free metric registry.

    Families are created lazily on first touch; each family is one
    OpenMetrics ``# TYPE`` block holding one sample (or one
    bucket/sum/count triple) per distinct label set.  Thread-safe: the
    daemon's listener thread scrapes while the main thread trains.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type", "help", "samples": {label_key: value|hist}}
        self._families: Dict[str, Dict[str, Any]] = {}

    def _family(self, name: str, mtype: str, help_text: str) -> Dict[str, Any]:
        fam = self._families.get(name)
        if fam is None:
            fam = {"type": mtype, "help": help_text, "samples": {}}
            self._families[name] = fam
        elif fam["type"] != mtype:
            raise ValueError(
                f"metric {name!r} already registered as {fam['type']}, "
                f"not {mtype}"
            )
        return fam

    def inc(self, name: str, value: float = 1.0, labels: LabelDict = None,
            help: str = "") -> None:
        """Add ``value`` to counter ``name`` (created at 0 on first inc)."""
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease ({value})")
        with self._lock:
            samples = self._family(name, "counter", help)["samples"]
            key = _label_key(labels)
            samples[key] = samples.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, labels: LabelDict = None,
                  help: str = "") -> None:
        with self._lock:
            self._family(name, "gauge", help)["samples"][_label_key(labels)] = (
                float(value)
            )

    def max_gauge(self, name: str, value: float, labels: LabelDict = None,
                  help: str = "") -> None:
        """Gauge that keeps the maximum seen (peak-memory folds)."""
        with self._lock:
            samples = self._family(name, "gauge", help)["samples"]
            key = _label_key(labels)
            samples[key] = max(float(value), samples.get(key, float("-inf")))

    def observe(self, name: str, value: float, labels: LabelDict = None,
                help: str = "",
                buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        with self._lock:
            samples = self._family(name, "histogram", help)["samples"]
            key = _label_key(labels)
            hist = samples.get(key)
            if hist is None:
                hist = {"buckets": dict.fromkeys(buckets, 0), "sum": 0.0,
                        "count": 0}
                samples[key] = hist
            for le in hist["buckets"]:
                if value <= le:
                    hist["buckets"][le] += 1
            hist["sum"] += float(value)
            hist["count"] += 1

    def value(self, name: str, labels: LabelDict = None) -> Optional[float]:
        """A counter/gauge sample's current value (None when absent)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam["type"] == "histogram":
                return None
            return fam["samples"].get(_label_key(labels))

    def families(self) -> List[str]:
        with self._lock:
            return sorted(self._families)


def render_openmetrics(registry: MetricsRegistry) -> str:
    """The registry as OpenMetrics text (terminated by ``# EOF``).

    Counter samples carry the ``_total`` suffix; histogram samples
    expand to ``_bucket{le=...}`` / ``_sum`` / ``_count``."""
    lines: List[str] = []
    with registry._lock:
        for name in sorted(registry._families):
            fam = registry._families[name]
            lines.append(f"# TYPE {name} {fam['type']}")
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            samples = fam["samples"]
            if fam["type"] == "counter":
                for key in sorted(samples):
                    lines.append(
                        f"{name}_total{_render_labels(key)} "
                        f"{_fmt_value(samples[key])}"
                    )
            elif fam["type"] == "gauge":
                for key in sorted(samples):
                    lines.append(
                        f"{name}{_render_labels(key)} "
                        f"{_fmt_value(samples[key])}"
                    )
            else:  # histogram
                for key in sorted(samples):
                    hist = samples[key]
                    # ``observe`` already stores cumulative counts (every
                    # bucket >= the value is bumped) — render verbatim.
                    for le in sorted(hist["buckets"]):
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(key, (('le', _fmt_value(le)),))}"
                            f" {hist['buckets'][le]}"
                        )
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels(key, (('le', '+Inf'),))} "
                        f"{hist['count']}"
                    )
                    lines.append(
                        f"{name}_sum{_render_labels(key)} "
                        f"{_fmt_value(hist['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_render_labels(key)} "
                        f"{hist['count']}"
                    )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> Dict[Tuple[str, _LabelKey], float]:
    """Parse rendered OpenMetrics text back into ``{(sample_name,
    label_key): value}``, to hold a scrape against an independent replay."""
    out: Dict[Tuple[str, _LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            body, value_part = rest.rsplit("}", 1)
            labels: List[Tuple[str, str]] = []
            for pair in _split_label_pairs(body):
                k, v = pair.split("=", 1)
                labels.append((k.strip(), v.strip().strip('"')))
            key = tuple(sorted(labels))
        else:
            name, value_part = line.split(None, 1)
            key = ()
        value = value_part.strip()
        out[(name.strip(), key)] = (
            float("inf") if value == "+Inf"
            else float("-inf") if value == "-Inf"
            else float(value)
        )
    return out


def _split_label_pairs(body: str) -> Iterable[str]:
    """Split ``k="v",k2="v2"`` on commas outside quotes."""
    depth_quote = False
    start = 0
    for i, ch in enumerate(body):
        if ch == '"':
            depth_quote = not depth_quote
        elif ch == "," and not depth_quote:
            if body[start:i]:
                yield body[start:i]
            start = i + 1
    if body[start:]:
        yield body[start:]


# ----------------------------------------------------------------------
# Folds: events.jsonl / manifest -> registry (the offline scrape)


def fold_run_events(
    registry: MetricsRegistry,
    run_dir,
    labels: LabelDict = None,
) -> MetricsRegistry:
    """Replay one run directory's durable telemetry into the registry.

    This is the whole offline scrape: every metric below is a pure
    function of the manifest and the event stream, so a dropped event
    shows as a fold that disagrees with a scrape that saw it."""
    from murmura_tpu_torch.telemetry.writer import iter_events, read_manifest

    base = dict(labels or {})
    manifest = read_manifest(run_dir) or {}
    if manifest:
        registry.set_gauge(
            "murmura_run_finalized", 1.0 if manifest.get("finalized") else 0.0,
            labels=base, help="1 when the manifest is finalized",
        )
        registry.set_gauge(
            "murmura_run_schema_version",
            float(manifest.get("schema_version") or 0),
            labels=base, help="telemetry manifest schema version",
        )
        for cname, cval in (manifest.get("counters") or {}).items():
            try:
                registry.inc(
                    "murmura_run_counter", float(cval),
                    labels={**base, "counter": cname},
                    help="manifest counter totals (compiles, distributed "
                         "node counters, dispatch retries)",
                )
            except (TypeError, ValueError):
                continue
    for event in iter_events(run_dir):
        etype = event.get("type")
        if etype == "round":
            registry.inc(
                "murmura_rounds", labels=base,
                help="recorded FL rounds",
            )
        elif etype == "phase_times":
            registry.observe(
                "murmura_round_wall_seconds", float(event.get("wall_s", 0.0)),
                labels={**base, "mode": str(event.get("mode"))},
                help="per-round wall time by dispatch mode (fused entries "
                     "are elapsed/k amortized; pipelined entries are the "
                     "round's critical path)",
            )
        elif etype == "checkpoint":
            action = str(event.get("action", "save"))
            registry.inc(
                "murmura_checkpoints", labels={**base, "action": action},
                help="checkpoint saves/restores",
            )
            registry.observe(
                "murmura_checkpoint_seconds",
                float(event.get("duration_s", 0.0)),
                labels={**base, "action": action},
                help="checkpoint save/restore durations",
            )
        elif etype == "memory":
            stats = event.get("stats") or {}
            in_use = stats.get("bytes_in_use")
            if in_use is not None:
                registry.max_gauge(
                    "murmura_memory_peak_bytes", float(in_use),
                    labels={**base,
                            "device_kind": str(event.get("device_kind"))},
                    help="peak sampled device bytes_in_use",
                )
        elif etype == "backend_degraded":
            registry.inc(
                "murmura_degradations",
                labels={**base, "kind": str(event.get("kind", "retry"))},
                help="dispatch-envelope degradations (transient retries, "
                     "frozen lanes, CPU fallbacks)",
            )
            if event.get("delay_s") is not None:
                registry.inc(
                    "murmura_backoff_seconds", float(event["delay_s"]),
                    labels=base,
                    help="cumulative dispatch backoff sleep",
                )
        elif etype == "serve":
            registry.inc(
                "murmura_serve_events",
                labels={**base, "event": str(event.get("event"))},
                help="serve lifecycle events (submitted/admitted/"
                     "generation_start/generation_done/evicted/resumed)",
            )
        elif etype == "run_resumed":
            registry.inc(
                "murmura_resumes", labels=base,
                help="durability restores that continued this run",
            )
    return registry


def fold_bench_payload(
    registry: MetricsRegistry, name: str, payload: Mapping[str, Any],
) -> MetricsRegistry:
    """Flatten a bench payload's numeric leaves into labelled gauges.

    Scalar leaves become
    ``murmura_bench{bench=..., key="a.b.c"}`` gauges; non-numeric leaves
    are skipped (the manifest keeps full fidelity — the snapshot is the
    scrapeable projection, not the artifact of record)."""

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(node, bool):
            return
        elif isinstance(node, (int, float)) and math.isfinite(node):
            registry.set_gauge(
                "murmura_bench", float(node),
                labels={"bench": name, "key": prefix},
                help="bench payload scalar leaves (see the adjacent "
                     "manifest for full structure)",
            )

    walk("", payload)
    return registry


METRICS_SNAPSHOT_FILE = "metrics.prom"


def write_openmetrics_snapshot(run_dir, registry: MetricsRegistry) -> Path:
    """Durably write the registry next to a manifest as
    ``metrics.prom`` (atomic via the checkpoint durability path)."""
    from murmura_tpu_torch.utils.checkpoint import durable_replace

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    durable_replace(
        run_dir, METRICS_SNAPSHOT_FILE,
        render_openmetrics(registry).encode("utf-8"),
    )
    return run_dir / METRICS_SNAPSHOT_FILE


def scrape_socket(socket_path: str) -> str:
    """One ``{"op": "metrics"}`` scrape of a live daemon."""
    from murmura_tpu_torch.serve.protocol import send_request

    response = send_request(str(socket_path), {"op": "metrics"})
    if not response.get("ok"):
        raise RuntimeError(
            f"metrics scrape failed: {response.get('error')}"
        )
    return response["text"]
