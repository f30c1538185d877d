"""Telemetry (the PyTorch counterpart of murmura_tpu/telemetry/): one
versioned run manifest and one JSONL event stream a run writes through
(schema.py, writer.py), the ``report`` that reads them back (report.py),
and the observability plane over them: the OpenMetrics registry and folds
(metrics.py, ``metrics``), the daemon dashboard (top.py, ``top``), the
cross-run index (registry.py, ``runs``, ``report --latest``) and the trace
spans (spans.py, ``report --trace``).  The schema is the JAX package's v2,
so either package's readers read a run directory the other wrote."""

from murmura_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    fold_run_events,
    render_openmetrics,
)
from murmura_tpu_torch.telemetry.schema import (
    EVENTS_FILE,
    MANIFEST_FILE,
    MANIFEST_SCHEMA_VERSION,
)
from murmura_tpu_torch.telemetry.writer import (
    TelemetryWriter,
    events_of_type,
    iter_events,
    read_manifest,
)

__all__ = [
    "EVENTS_FILE",
    "MetricsRegistry",
    "fold_run_events",
    "render_openmetrics",
    "MANIFEST_FILE",
    "MANIFEST_SCHEMA_VERSION",
    "TelemetryWriter",
    "events_of_type",
    "iter_events",
    "read_manifest",
]
