# Copy of murmura_tpu/telemetry/spans.py.
"""Trace spans over the durable event stream.

A *span* is one closed interval on one lane of one run's timeline:
``trace_id`` is the run/submission id, lanes (``tid``) separate the
lifecycle, round, and checkpoint tracks, and every non-root span is
parented, so a whole multi-tenant daemon renders as one forest.  No new
work in a round: spans are rebuilt from the records the framework already
emits — the serve lifecycle events, the per-round ``phase_times``
accounting (whose semantics the span durations inherit: fused rounds
are elapsed/k amortized, pipelined rounds are the critical path), and
the checkpoint/profile events.  The export target is the Chrome
trace-event JSON that Perfetto (ui.perfetto.dev) opens directly:
``report <run_dir> --trace out.json``.

Timeline semantics: round spans are laid out on the *accounted*
timeline — each round occupies ``[max(cursor, t - wall_s), ... +
wall_s]`` so that (a) spans on a lane never overlap even when a fused
chunk reports k amortized rounds at one wall-clock instant, and (b) the
sum of round-span durations equals the summed ``phase_times`` exactly.
:func:`validate_spans` checks both.  v1 streams (no per-event ``t``
timestamp) still render: the timeline is synthesized from the manifest's
``created_unix`` plus cumulative wall time.
"""

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

Span = Dict[str, Any]  # {"name","trace_id","tid","start","end","parent","args"}

# Lane (tid) names, one per track of a run's timeline.
LANE_LIFECYCLE = "lifecycle"
LANE_ROUNDS = "rounds"
LANE_CHECKPOINTS = "checkpoints"


def _span(name: str, trace_id: str, tid: str, start: float, end: float,
          parent: Optional[str] = None, **args) -> Span:
    return {
        "name": name,
        "trace_id": trace_id,
        "tid": tid,
        "start": float(start),
        "end": float(end),
        "parent": parent,
        "args": {k: v for k, v in args.items() if v is not None},
    }


def build_spans(run_dir) -> List[Span]:
    """One run directory's event stream as a parented span list.

    Taxonomy:

    - ``run`` — the root, one per trace_id.
    - ``queued`` / ``generation`` — serve lifecycle (submitted->admitted,
      generation_start->generation_done), lane ``lifecycle``.
    - ``round <n>`` — one per phase_times event, lane ``rounds``; args
      carry mode/chunk/overlap so fused amortization and pipelined
      critical-path semantics stay visible in Perfetto.
    - ``checkpoint save/restore`` — lane ``checkpoints``.
    """
    from murmura_tpu_torch.telemetry.writer import iter_events, read_manifest

    manifest = read_manifest(run_dir) or {}
    trace_id = str(
        manifest.get("run_id") or Path(str(run_dir)).name or "run"
    )
    created = float(manifest.get("created_unix") or 0.0)
    root_id = f"{trace_id}/run"

    spans: List[Span] = []
    cursor = created      # accounted-timeline cursor for the rounds lane
    last_t = created      # latest real timestamp seen anywhere
    serve_marks: Dict[str, float] = {}

    for event in iter_events(run_dir):
        t = event.get("t")
        if t is not None:
            last_t = max(last_t, float(t))
        etype = event.get("type")
        if etype == "phase_times":
            wall = float(event.get("wall_s", 0.0))
            start = max(cursor, (float(t) - wall) if t is not None else cursor)
            end = start + wall
            cursor = end
            last_t = max(last_t, end)
            spans.append(_span(
                f"round {event.get('round')}", trace_id, LANE_ROUNDS,
                start, end, parent=root_id,
                round=event.get("round"), mode=event.get("mode"),
                chunk=event.get("chunk"), overlap=event.get("overlap"),
            ))
        elif etype == "checkpoint":
            dur = float(event.get("duration_s", 0.0))
            end = float(t) if t is not None else cursor
            spans.append(_span(
                f"checkpoint {event.get('action', 'save')}", trace_id,
                LANE_CHECKPOINTS, end - dur, end, parent=root_id,
                round=event.get("round"), path=event.get("path"),
            ))
        elif etype == "serve":
            name = str(event.get("event"))
            at = float(t) if t is not None else last_t
            serve_marks[name] = at
            if name == "admitted" and "submitted" in serve_marks:
                spans.append(_span(
                    "queued", trace_id, LANE_LIFECYCLE,
                    serve_marks["submitted"], at, parent=root_id,
                    bucket=event.get("bucket"),
                ))
            elif (name in ("generation_done", "evicted", "frozen")
                  and "generation_start" in serve_marks):
                spans.append(_span(
                    "generation", trace_id, LANE_LIFECYCLE,
                    serve_marks.pop("generation_start"), at, parent=root_id,
                    gen=event.get("gen"), lane=event.get("lane"),
                    outcome=name,
                ))

    end = float(manifest.get("finalized_unix") or 0.0) or last_t
    end = max(end, last_t, created)
    spans.insert(0, _span(
        "run", trace_id, LANE_LIFECYCLE, created, end,
        parent=None, kind=manifest.get("kind"),
        schema_version=manifest.get("schema_version"),
    ))
    spans[0]["id"] = root_id
    return spans


def validate_spans(
    spans: List[Span], phase_total: Optional[float] = None,
    tolerance: float = 1e-6,
) -> List[str]:
    """The spans' well-formedness predicate; returns problem strings.

    Checks: every span closed (finite start <= end), every non-root span
    parented at an existing root id, per-lane non-overlap (sorted by
    start, each span must not start before its predecessor ends), and —
    when ``phase_total`` is given — the round-lane durations summing to
    the phase_times total within tolerance."""
    problems: List[str] = []
    roots = {s.get("id") for s in spans if s.get("id")}
    by_lane: Dict[tuple, List[Span]] = {}
    for s in spans:
        if not (s["start"] <= s["end"]):
            problems.append(
                f"span {s['name']!r} is not closed: start {s['start']} > "
                f"end {s['end']}"
            )
        if s.get("parent") is None and not s.get("id"):
            problems.append(f"span {s['name']!r} has neither parent nor id")
        if s.get("parent") is not None and s["parent"] not in roots:
            problems.append(
                f"span {s['name']!r} parented at unknown id {s['parent']!r}"
            )
        if not s.get("id"):
            # Root spans enclose their whole trace by design; only
            # non-root spans owe their lane non-overlap.
            by_lane.setdefault((s["trace_id"], s["tid"]), []).append(s)
    for (trace_id, tid), lane in by_lane.items():
        lane.sort(key=lambda s: (s["start"], s["end"]))
        for prev, cur in zip(lane, lane[1:]):
            if cur["start"] < prev["end"] - tolerance:
                problems.append(
                    f"lane {trace_id}/{tid}: span {cur['name']!r} starts "
                    f"at {cur['start']} before {prev['name']!r} ends at "
                    f"{prev['end']}"
                )
    if phase_total is not None:
        round_total = sum(
            s["end"] - s["start"] for s in spans if s["tid"] == LANE_ROUNDS
        )
        if abs(round_total - phase_total) > max(tolerance,
                                                1e-3 * abs(phase_total)):
            problems.append(
                f"round spans sum to {round_total:.6f}s but phase_times "
                f"total {phase_total:.6f}s — the trace is inventing or "
                "losing accounted time"
            )
    return problems


# ----------------------------------------------------------------------
# Chrome trace-event export (Perfetto)


def to_chrome_trace(span_lists: List[List[Span]]) -> Dict[str, Any]:
    """Merge per-run span lists into one Chrome trace-event JSON object.

    Each run becomes one ``pid`` (named by trace_id via metadata events),
    each lane one ``tid``; spans are complete events (``ph: "X"``) with
    microsecond timestamps relative to the earliest span."""
    events: List[Dict[str, Any]] = []
    starts = [
        s["start"] for spans in span_lists for s in spans
    ]
    epoch = min(starts) if starts else 0.0
    for pid, spans in enumerate(span_lists, start=1):
        if not spans:
            continue
        tids: Dict[str, int] = {}
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": spans[0]["trace_id"]},
        })
        for s in spans:
            tid = tids.setdefault(s["tid"], len(tids) + 1)
            events.append({
                "name": s["name"],
                "cat": s["tid"],
                "ph": "X",
                "ts": (s["start"] - epoch) * 1e6,
                "dur": max(0.0, s["end"] - s["start"]) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {**s["args"], "trace_id": s["trace_id"]},
            })
        for lane_name, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": lane_name},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(out_path, run_dirs) -> int:
    """Build spans for every run dir and write one Chrome trace JSON;
    returns the number of spans exported."""
    span_lists = [build_spans(d) for d in run_dirs]
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(
        json.dumps(to_chrome_trace(span_lists)) + "\n", encoding="utf-8"
    )
    return sum(len(spans) for spans in span_lists)
