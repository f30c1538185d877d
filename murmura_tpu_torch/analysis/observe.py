# Counterpart of murmura_tpu/analysis/observe.py (MUR1700-1703).
"""The observability contracts (``check --observe``): a scrape is honest
(it never shows numbers the durable artifacts cannot reproduce) and inert
(watching a daemon cannot perturb its tenants).

- **MUR1700 — metrics <-> ledger parity.**  Scrape an in-process daemon
  after a drained generation and replay the durable state independently
  (ledger records re-read from disk, event streams re-counted line by
  line): every scraped counter equals the replay.
- **MUR1701 — scrape non-interference.**  A warm bucket's second
  generation runs while a thread polls metrics/ping/list: no program or
  kernel build, and every tenant history bit-equal to an unscraped
  daemon's.
- **MUR1702 — span well-formedness.**  Spans built from a drained
  tenant's stream are closed, parented, non-overlapping per lane, one
  round span per ``phase_times`` event, their round lane summing to the
  stream's ``phase_times`` total; the serve lifecycle spans are there.
- **MUR1703 — schema discipline.**  The schema version has its migration
  note in docs/OBSERVABILITY.md, and a hand-built v1 stream (no per-event
  ``t``) still renders through the report, the span builder and the
  metrics fold.
"""

import json
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from murmura_tpu_torch.analysis.cells import anchor, family_registry, run_families
from murmura_tpu_torch.analysis.durability import history_equal
from murmura_tpu_torch.analysis.lint import Finding
from murmura_tpu_torch.analysis.serve import serve_daemon, tenant_raw

OBSERVE_CHECK_FAMILIES, _family = family_registry()


def metrics_ledger_parity(daemon, text: Optional[str] = None) -> List[str]:
    """Compare a scrape against an independent replay of durable state;
    returns the discrepancies (empty = parity).  ``text`` checks a scrape
    taken earlier (the tests scrape, drop an event, and check again)."""
    from murmura_tpu_torch.telemetry.metrics import parse_openmetrics, render_openmetrics

    if text is None:
        text = render_openmetrics(daemon.metrics_registry())
    parsed = parse_openmetrics(text)
    problems: List[str] = []

    def scraped(name: str, **labels) -> Optional[float]:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        return parsed.get((name, key))

    records = [json.loads(p.read_text(encoding="utf-8"))
               for p in sorted((daemon.state_dir / "submissions").glob("*.json"))]
    got = scraped("murmura_serve_lifetime_total", counter="admissions")
    if got != len(records):
        problems.append(f"scraped admissions={got} but the durable ledger holds "
                        f"{len(records)} submission records")
    states: Dict[str, int] = {}
    for rec in records:
        states[rec["state"]] = states.get(rec["state"], 0) + 1
    for state, count in sorted(states.items()):
        got = scraped("murmura_serve_submissions", state=state)
        if got != count:
            problems.append(f"scraped submissions{{state={state}}}={got} but the ledger "
                            f"replay counts {count}")
    for rec in records:
        events_path = daemon.state_dir / "telemetry" / rec["id"] / "events.jsonl"
        if not events_path.exists():
            continue
        rounds = 0
        lifecycle: Dict[str, int] = {}
        for line in events_path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail: the valid prefix is the stream
            if event.get("type") == "round":
                rounds += 1
            elif event.get("type") == "serve":
                name = str(event.get("event"))
                lifecycle[name] = lifecycle.get(name, 0) + 1
        got = scraped("murmura_rounds_total", tenant=rec["id"])
        if (got or 0) != rounds:
            problems.append(f"scraped rounds_total{{tenant={rec['id']}}}={got} but the "
                            f"stream replay counts {rounds} round events")
        for name, count in sorted(lifecycle.items()):
            got = scraped("murmura_serve_events_total", tenant=rec["id"], event=name)
            if (got or 0) != count:
                problems.append(f"scraped serve_events{{tenant={rec['id']}, event={name}}}="
                                f"{got} but the stream replay counts {count}")
    return problems


def _drained_daemon(state: Path, device):
    daemon = serve_daemon(state, device)
    daemon.submit_config(tenant_raw(seed=5))
    daemon.submit_config(tenant_raw(seed=6))
    daemon.drain()
    return daemon


@_family
def check_metrics_parity(device) -> List[Finding]:
    """MUR1700: a drained daemon's scrape equals the durable replay."""
    path, line = anchor("serve/daemon.py", "def metrics_registry")
    tmp = Path(tempfile.mkdtemp(prefix="murmura-observe-1700-"))
    try:
        daemon = _drained_daemon(tmp / "state", device)
        daemon.close()
        return [Finding(
            "MUR1700", path, line,
            f"metrics scrape disagrees with the durable replay: {problem} — a "
            "scraped counter must be reconstructible from the ledger and the "
            "event streams alone",
        ) for problem in metrics_ledger_parity(daemon)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def interference_problems(compiles: int, history_pairs: List[Tuple[str, dict, dict]]) -> List[str]:
    """The MUR1701 verdict over the builds seen during the scraped
    generation and (sub_id, scraped history, reference history) pairs."""
    problems: List[str] = []
    if compiles:
        problems.append(f"{compiles} program or kernel build(s) during the scraped "
                        "generation — the read ops must not touch the round programs")
    for sub_id, scraped_hist, ref_hist in history_pairs:
        if not history_equal(scraped_hist, ref_hist):
            problems.append(f"tenant {sub_id}'s history diverges from the unscraped "
                            "reference — observation perturbed the computation")
    return problems


@_family
def check_scrape_noninterference(device) -> List[Finding]:
    """MUR1701: polling metrics/ping/list against a running daemon builds
    nothing and leaves tenant histories bit-equal to an unscraped run."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles

    path, line = anchor("serve/daemon.py", "def handle_request")
    tmp = Path(tempfile.mkdtemp(prefix="murmura-observe-1701-"))
    try:
        def run(state: Path, scrape: bool) -> dict:
            daemon = _drained_daemon(state, device)  # generation 1 warms the bucket
            gen2_ids = [daemon.submit_config(tenant_raw(seed=7))["id"],
                        daemon.submit_config(tenant_raw(seed=8))["id"]]
            stop = threading.Event()

            def poll():
                while not stop.is_set():
                    daemon.handle_request({"op": "metrics"})
                    daemon.handle_request({"op": "ping"})
                    daemon.handle_request({"op": "list"})

            poller = threading.Thread(target=poll, daemon=True) if scrape else None
            if poller is not None:
                poller.start()
            try:
                with track_compiles() as tracker:
                    daemon.drain()
            finally:
                stop.set()
                if poller is not None:
                    poller.join(timeout=10.0)
                daemon.close()
            return {"compiles": tracker.total,
                    "ledger": {i: daemon._ledger[i] for i in gen2_ids}}

        ref = run(tmp / "ref", scrape=False)
        scraped = run(tmp / "scraped", scrape=True)
        pairs = [(i, scraped["ledger"][i].get("history"), ref["ledger"][i].get("history"))
                 for i in sorted(ref["ledger"])]
        return [Finding(
            "MUR1701", path, line,
            f"scrape non-interference violated: {problem} (polling "
            "metrics/ping/list mid-generation must be invisible to tenants)",
        ) for problem in interference_problems(scraped["compiles"], pairs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def span_findings(run_dir: Path, sub_id: str, path: str, line: int) -> List[Finding]:
    """MUR1702 over one tenant's run directory."""
    from murmura_tpu_torch.telemetry.spans import LANE_ROUNDS, build_spans, validate_spans
    from murmura_tpu_torch.telemetry.writer import events_of_type

    findings: List[Finding] = []
    spans = build_spans(run_dir)
    phase_events = events_of_type(run_dir, "phase_times")
    phase_total = sum(float(e.get("wall_s", 0.0)) for e in phase_events)
    for problem in validate_spans(spans, phase_total=phase_total):
        findings.append(Finding("MUR1702", path, line, f"tenant {sub_id}: {problem}"))
    round_spans = [s for s in spans if s["tid"] == LANE_ROUNDS]
    if len(round_spans) != len(phase_events):
        findings.append(Finding(
            "MUR1702", path, line,
            f"tenant {sub_id}: {len(round_spans)} round spans for "
            f"{len(phase_events)} phase_times events — every accounted round "
            "must appear in the trace",
        ))
    names = {s["name"] for s in spans}
    for required in ("run", "queued", "generation"):
        if required not in names:
            findings.append(Finding(
                "MUR1702", path, line,
                f"tenant {sub_id}: no {required!r} span — the serve lifecycle "
                "must be visible in the trace",
            ))
    return findings


@_family
def check_span_wellformedness(device) -> List[Finding]:
    """MUR1702 over a drained daemon's tenants."""
    path, line = anchor("telemetry/spans.py", "def build_spans")
    tmp = Path(tempfile.mkdtemp(prefix="murmura-observe-1702-"))
    try:
        daemon = _drained_daemon(tmp / "state", device)
        daemon.close()
        findings: List[Finding] = []
        for sub_id in sorted(daemon._ledger):
            findings += span_findings(daemon.state_dir / "telemetry" / sub_id, sub_id,
                                      path, line)
        return findings
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def schema_discipline_problems(version: int, docs_text: str) -> List[str]:
    """The static half of MUR1703."""
    problems: List[str] = []
    if version < 2:
        problems.append(
            f"MANIFEST_SCHEMA_VERSION is {version} but the v2 event additions "
            "(per-event `t`, `serve` lifecycle events) are in the stream — new "
            "event types require a schema bump")
    if f"### v{version}" not in docs_text:
        problems.append(f"docs/OBSERVABILITY.md has no '### v{version}' migration note "
                        "for the current schema (the MUR401 discipline)")
    return problems


def v1_stream_problems(run_dir: Path) -> List[str]:
    """Write a hand-built v1 run (no `t` anywhere) into ``run_dir`` and
    render it through the report, the span builder and the metrics fold."""
    from murmura_tpu_torch.telemetry.metrics import MetricsRegistry, fold_run_events
    from murmura_tpu_torch.telemetry.report import build_report
    from murmura_tpu_torch.telemetry.spans import build_spans, validate_spans

    run_dir.mkdir(parents=True)
    (run_dir / "manifest.json").write_text(json.dumps({
        "schema_version": 1, "kind": "run", "run_id": "v1-probe",
        "created_unix": 1000.0, "finalized": True, "finalized_unix": 1004.0,
        "counters": {},
        "history": {"round": [1, 2], "mean_accuracy": [0.5, 0.6], "mean_loss": [1.0, 0.9]},
    }))
    v1_events = [
        {"type": "run", "seq": 0, "status": "started"},
        {"type": "round", "seq": 1, "round": 1, "metrics": {"accuracy": [0.5]}},
        {"type": "phase_times", "seq": 2, "round": 0, "mode": "per_round", "wall_s": 0.5},
        {"type": "round", "seq": 3, "round": 2, "metrics": {"accuracy": [0.6]}},
        {"type": "phase_times", "seq": 4, "round": 1, "mode": "per_round", "wall_s": 0.5},
    ]
    (run_dir / "events.jsonl").write_text("".join(json.dumps(e) + "\n" for e in v1_events))
    problems: List[str] = []
    try:
        build_report(run_dir)
        span_problems = validate_spans(build_spans(run_dir), phase_total=1.0)
        if span_problems:
            problems.append("a v1 stream (no per-event `t`) builds malformed spans: "
                            f"{span_problems[0]}")
        reg = MetricsRegistry()
        fold_run_events(reg, run_dir)
        if reg.value("murmura_rounds") != 2:
            problems.append(f"the metrics fold miscounts a v1 stream "
                            f"({reg.value('murmura_rounds')} rounds for 2 round events)")
    except Exception as e:  # noqa: BLE001 — a crash IS the finding
        problems.append(f"rendering a v1 stream crashed ({type(e).__name__}: {e})")
    return problems


@_family
def check_schema_discipline(device=None) -> List[Finding]:
    """MUR1703: the migration note, and a v1 stream still renders."""
    from murmura_tpu_torch.telemetry.schema import MANIFEST_SCHEMA_VERSION

    path, line = anchor("telemetry/schema.py", "MANIFEST_SCHEMA_VERSION =")
    docs = Path(__file__).resolve().parents[2] / "docs" / "OBSERVABILITY.md"
    try:
        docs_text = docs.read_text(encoding="utf-8")
    except OSError:
        docs_text = ""
    problems = schema_discipline_problems(MANIFEST_SCHEMA_VERSION, docs_text)
    tmp = Path(tempfile.mkdtemp(prefix="murmura-observe-1703-"))
    try:
        problems += v1_stream_problems(tmp / "v1run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [Finding("MUR1703", path, line, p) for p in problems]


def check_observe(device="cuda") -> List[Finding]:
    """MUR1700-1703."""
    return run_families(OBSERVE_CHECK_FAMILIES, "MUR1700", __file__, device)
