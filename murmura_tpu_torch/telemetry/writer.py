# Copy of TelemetryWriter and its readers from murmura_tpu/telemetry/writer.py.
"""Telemetry writer/reader: the one path a run emits through.

``TelemetryWriter`` owns a run directory holding the versioned manifest and
the append-only JSONL event stream (schema.py):

- **Crash-safe**: events append line at a time (a crash loses at most the
  line in flight); the manifest is only ever replaced atomically through
  :func:`murmura_tpu_torch.utils.checkpoint.durable_replace`.
- **One run a directory**: a fresh run into a directory that holds a
  stream rotates the old stream and manifest to ``*.prev`` (one generation
  kept), so a re-run never doubles the report's sums; a run resumed from
  its snapshot (``resume=True``) appends to its own stream instead, keeps
  its ``run_id`` and marks the manifest ``resumed``.

Left out against the JAX package: counters, the serve daemon's lifecycle
events and the bench manifest (serve, the bench), and the ``record_taps``
toggle (the port records every tap its round computes).
"""

import json
import os
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from murmura_tpu_torch.telemetry.schema import (
    EVENTS_FILE,
    KIND_RUN,
    MANIFEST_FILE,
    MANIFEST_SCHEMA_VERSION,
)
from murmura_tpu_torch.utils.checkpoint import durable_replace


def _jsonable(value: Any) -> Any:
    """Recursively convert numpy/torch leaves to plain JSON types."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, np.ndarray):
        return _jsonable(value.tolist())
    if isinstance(value, (np.floating, np.integer, np.bool_)):
        return value.item()
    if hasattr(value, "tolist") and not isinstance(value, (str, bytes)):
        return _jsonable(np.asarray(value).tolist())
    # Non-finite floats stay floats: Python's json writes and reads NaN and
    # Infinity, so a history round-trips whole.
    return value


def device_memory_stats(device) -> Optional[Dict[str, int]]:
    """The card's allocator counters under the keys the report reads
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``, as a JAX
    device's ``memory_stats()`` names them), or None on the CPU, which
    reports none (as JAX's CPU device).  A failure to read the card is not
    swallowed."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats["allocated_bytes.all.current"]),
        "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


def device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class TelemetryWriter:
    """Manifest + event-stream writer for one run directory.

    Args:
        run_dir: directory to create; one run a directory.
        config: optional validated Config, snapshotted (``model_dump``) into
            the manifest so that a report describes itself.
        phase_times: write one ``phase_times`` record a round.
        memory_stats: sample the device's memory into ``memory`` events.
        profile_dir / profile_start_round / profile_rounds: the profiler
            window (core/network.py opens and closes it at round
            boundaries).
        resume: the caller continues a prior run in this directory (a
            restore from its snapshot): append to the existing stream, keep
            its run_id and creation time, mark the manifest ``resumed`` and
            emit ``run`` with status ``resumed``.  False: a prior stream is a
            stale run and is rotated to ``*.prev``.
    """

    def __init__(
        self,
        run_dir,
        *,
        config=None,
        phase_times: bool = True,
        memory_stats: bool = False,
        profile_dir: Optional[str] = None,
        profile_start_round: int = 0,
        profile_rounds: int = 0,
        resume: bool = False,
    ):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.record_phase_times = phase_times
        self.memory_stats = memory_stats
        self.profile_dir = profile_dir
        self.profile_start_round = int(profile_start_round)
        self.profile_rounds = int(profile_rounds)

        events_path = self.run_dir / EVENTS_FILE
        has_prior = events_path.exists() and events_path.stat().st_size > 0
        if has_prior and not resume:
            os.replace(events_path, self.run_dir / (EVENTS_FILE + ".prev"))
            mpath = self.run_dir / MANIFEST_FILE
            if mpath.exists():
                os.replace(mpath, self.run_dir / (MANIFEST_FILE + ".prev"))
        resumed = has_prior and resume
        existing = (read_manifest(self.run_dir) if resumed else None) or {}
        self.run_id = existing.get("run_id") or uuid.uuid4().hex[:12]
        # Sequence numbers continue the stream's, so they stay unique in it.
        self._seq = sum(1 for _ in iter_events(self.run_dir)) if resumed else 0
        self._events = open(events_path, "a", encoding="utf-8")
        self._manifest: Dict[str, Any] = {
            "schema_version": MANIFEST_SCHEMA_VERSION,
            "kind": KIND_RUN,
            "run_id": self.run_id,
            "created_unix": existing.get("created_unix", time.time()),
            "finalized": False,
            "resumed": bool(resumed),
        }
        if config is not None:
            self._manifest["config"] = _jsonable(config.model_dump())
        self._write_manifest()
        self.emit("run", status="resumed" if resumed else "started")

    # ------------------------------------------------------------------
    # events

    def emit(self, etype: str, **fields) -> None:
        """Append one event line, flushed whole.  Every line carries ``t``,
        the emit wall-clock time (schema v2)."""
        rec = {"type": etype, "seq": self._seq, "t": time.time(), **_jsonable(fields)}
        self._seq += 1
        self._events.write(json.dumps(rec) + "\n")
        self._events.flush()

    def phase_times(self, round_idx: int, mode: str, wall_s: float, **extra) -> None:
        """One round's time record: ``per_round`` = the round's wall time,
        ``fused`` = the chunk's elapsed time over its k rounds."""
        if not self.record_phase_times:
            return
        self.emit("phase_times", round=int(round_idx), mode=mode, wall_s=float(wall_s), **extra)

    def round_event(self, round_num: int, metrics: Dict[str, Any], in_degree) -> None:
        """Per-node metric arrays of one recorded round (``agg_tap_*`` audit
        taps included) and the host-side in-degree of its adjacency."""
        self.emit("round", round=int(round_num), metrics=metrics, in_degree=in_degree)

    def memory_event(self, round_idx: int, device="cpu") -> None:
        """Sample ``device``'s memory (no-op unless enabled): the card's
        allocator counters (:func:`device_memory_stats`), or ``stats:
        null`` on the CPU."""
        if not self.memory_stats:
            return
        self.emit("memory", round=int(round_idx), device_kind=device_kind(device),
                  stats=device_memory_stats(device))

    def checkpoint_event(self, round_idx: int, duration_s: float, action: str = "save",
                         path: Optional[str] = None, **extra) -> None:
        """A snapshot saved or restored (``action``) at ``round_idx``;
        ``extra`` adds fields (the port records the snapshot's ``bytes``)."""
        self.emit("checkpoint", round=int(round_idx), action=action,
                  duration_s=float(duration_s), path=path, **extra)

    # ------------------------------------------------------------------
    # manifest

    def _write_manifest(self) -> None:
        blob = {**self._manifest, "counters": {}}
        durable_replace(
            self.run_dir, MANIFEST_FILE, json.dumps(_jsonable(blob), indent=2).encode("utf-8")
        )

    def finalize(self, history: Dict[str, list]) -> Path:
        """Atomically commit the manifest.  Callable more than once: each
        ``train`` call re-finalizes with the latest history."""
        self._manifest["history"] = history
        self._manifest["finalized"] = True
        self._manifest["finalized_unix"] = time.time()
        self._manifest["num_events"] = self._seq
        self._write_manifest()
        return self.run_dir / MANIFEST_FILE

    def close(self) -> None:
        self._events.close()


# ----------------------------------------------------------------------
# readers (report, tests)


def read_manifest(run_dir) -> Optional[Dict[str, Any]]:
    """Parsed manifest.json, or None when absent or unreadable."""
    path = Path(run_dir) / MANIFEST_FILE
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def iter_events(run_dir) -> Iterator[Dict[str, Any]]:
    """Yield event dicts in append order, tolerating a torn final line."""
    path = Path(run_dir) / EVENTS_FILE
    if not path.exists():
        return
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                # A crash mid-append leaves at most one torn line.
                return


def events_of_type(run_dir, etype: str) -> List[Dict[str, Any]]:
    return [e for e in iter_events(run_dir) if e.get("type") == etype]
