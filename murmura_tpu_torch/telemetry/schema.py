# Copy of the constants of murmura_tpu/telemetry/schema.py.
"""The telemetry run schema: one manifest, one event stream.

    <run_dir>/manifest.json   versioned envelope: schema_version, kind,
                              run_id, config snapshot, summary, counters,
                              history — replaced atomically
                              (utils/checkpoint.durable_replace), so a crash
                              leaves either the previous manifest or the new
                              complete one.
    <run_dir>/events.jsonl    append-only event stream, one JSON object a
                              line; a crash leaves a valid prefix.

Event types (the ``type`` field of each line) the port writes: ``run``
(started / resumed), ``round`` (per-node metric arrays, ``agg_tap_*``
audit taps included, and the host-side ``in_degree`` of the round's
adjacency), ``phase_times`` (``per_round`` wall times, ``fused``
``elapsed/k`` over a chunk of k, or a population run's ``population``
round with its ``cohort_draw``), ``cohort`` (a population run's swap: its
draw, the users swapped out, the activated users and ``swap_s``),
``memory`` (the card's allocator counters), ``profile`` (a profiler
window started / stopped), ``checkpoint`` and ``run_resumed`` (a snapshot
saved or restored), ``backend_degraded`` (a retry, a frozen gang lane) and
``serve`` (a serve daemon's lifecycle transition of the tenant).  Every
line carries ``t``, the host wall-clock time at emit (v2).
"""

MANIFEST_SCHEMA_VERSION = 2

MANIFEST_FILE = "manifest.json"
EVENTS_FILE = "events.jsonl"

# Manifest ``kind`` values: a training run, or a bench artifact.
KIND_RUN = "run"
KIND_BENCH = "bench"

# Copy of MONITOR_KNOWN_KEYS from murmura_tpu/telemetry/schema.py: the
# metric keys the distributed Monitor understands natively; anything else a
# node reports is forwarded under ``extra.*``, never silently dropped.
MONITOR_KNOWN_KEYS = frozenset({
    "round", "node", "skipped", "compromised",
    "accuracy", "loss", "vacuity", "entropy", "strength",
    "stats", "counters",
})
