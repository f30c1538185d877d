# Copy of the exports of murmura_tpu/durability/__init__.py.
"""Run-level durability: exact checkpoint/resume and the dispatch envelope.

- :mod:`murmura_tpu_torch.durability.snapshot`: the run-state snapshot the
  Network saves and restores through (fsync'd, ``meta.json`` the commit
  point), and the registry of reserved carried-state keys.
- :mod:`murmura_tpu_torch.durability.dispatch`: transient-error
  classification, retry with exponential backoff and seeded jitter, and the
  ``require_tpu`` hard-fail (in the port: the run's device must be CUDA).
"""

from murmura_tpu_torch.durability.dispatch import (
    BackendRequirementError,
    RetryPolicy,
    classify_error,
    require_tpu,
    run_with_retry,
    tpu_required,
)
from murmura_tpu_torch.durability.snapshot import (
    RESERVED_AGG_STATE_KEY_GROUPS,
    SNAPSHOT_BASE_SECTIONS,
    restore_run_snapshot,
    save_run_snapshot,
)

__all__ = [
    "BackendRequirementError",
    "RetryPolicy",
    "classify_error",
    "require_tpu",
    "run_with_retry",
    "tpu_required",
    "RESERVED_AGG_STATE_KEY_GROUPS",
    "SNAPSHOT_BASE_SECTIONS",
    "restore_run_snapshot",
    "save_run_snapshot",
]
