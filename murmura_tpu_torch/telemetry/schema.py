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
adjacency), ``phase_times`` (``per_round`` wall times, or ``fused``
``elapsed/k`` over a chunk of k), ``memory`` (the card's allocator
counters) and ``profile`` (a profiler window started / stopped).  Every
line carries ``t``, the host wall-clock time at emit (v2).
"""

MANIFEST_SCHEMA_VERSION = 2

MANIFEST_FILE = "manifest.json"
EVENTS_FILE = "events.jsonl"

# Manifest ``kind`` values: a training run, or a bench artifact.
KIND_RUN = "run"
KIND_BENCH = "bench"
