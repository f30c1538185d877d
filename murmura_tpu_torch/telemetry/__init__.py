"""Telemetry (the PyTorch counterpart of murmura_tpu/telemetry/): one
versioned run manifest and one JSONL event stream a run writes through
(schema.py, writer.py), and the ``report`` that reads them back
(report.py).  The schema is the JAX package's v2, so either package's
``report`` reads a run directory the other wrote."""

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
    "MANIFEST_FILE",
    "MANIFEST_SCHEMA_VERSION",
    "TelemetryWriter",
    "events_of_type",
    "iter_events",
    "read_manifest",
]
