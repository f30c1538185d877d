# Copy of murmura_tpu/durability/dispatch.py, require_tpu reading the port's device.
"""The elastic dispatch envelope: retry classification, backoff, and the
``require_tpu`` hard-fail.

- :func:`classify_error` — transient (device/tunnel/transport) vs fatal.
  Deliberately conservative: only errors that a reconnect or a re-dispatch
  can plausibly cure classify transient; everything else (shape errors,
  OOM, config errors) is fatal and re-raised immediately.  The tables are
  the JAX package's, unchanged.  A sticky CUDA error (an illegal address)
  kills the process's CUDA context; it matches none of the markers, so it
  is fatal, which is right: a retry in the same process could not cure it.
- :class:`RetryPolicy` / :func:`run_with_retry` — exponential backoff with
  deterministic seeded jitter (the same schedules as the JAX package's for
  the same seed).  The attempt callable receives the try index so the
  caller can restore from its last snapshot before re-dispatching; a retry
  runs on the device the run was given, never on another.
- :func:`require_tpu` / :func:`tpu_required` — the hard-fail, under the JAX
  package's names so the same configs and scripts work
  (``durability.require_tpu``, ``MURMURA_REQUIRE_TPU=1``,
  ``--require-tpu``).  In the port it demands the CUDA card: it raises
  unless the run's device is CUDA.  The port never falls back to the CPU
  on its own (cli.py), so its only effect is to refuse ``--device cpu``.
"""

import errno
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional


class BackendRequirementError(RuntimeError):
    """The run required the accelerator and did not get one."""


# Substrings that mark an exception message as transient: transport/tunnel
# deaths, device unavailability, and gRPC/PJRT deadline failures.  Matched
# case-insensitively against str(exc) and its type name.
TRANSIENT_ERROR_MARKERS = (
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "timed out",
    "timeout",
    "failed to connect",
    "transport",
    "tunnel",
    "heartbeat",
    "address already in use",
)

# Exception types that are transient by construction (transport layer).
# ConnectionResetError / BrokenPipeError / ConnectionRefusedError are
# ConnectionError subclasses and socket.timeout aliases TimeoutError, so
# a socket layer is covered wholesale.
TRANSIENT_ERROR_TYPES = (ConnectionError, TimeoutError)

# OSError errnos that mark a socket-layer transient even when the
# exception is a bare OSError (no ConnectionError subclass): a killed
# daemon's stale socket file (EADDRINUSE on rebind), a peer that died
# mid-write, a refused/aborted connect during restart.
TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EADDRINUSE",
        "ECONNRESET",
        "ECONNREFUSED",
        "ECONNABORTED",
        "EPIPE",
        "ETIMEDOUT",
        "EAGAIN",
    )
    if hasattr(errno, name)
)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` (retry may cure it) or ``"fatal"`` (re-raise).

    A :class:`BackendRequirementError` is always fatal — retrying cannot
    conjure a chip, and the whole point of ``--require-tpu`` is to stop.
    """
    if isinstance(exc, BackendRequirementError):
        return "fatal"
    if isinstance(exc, TRANSIENT_ERROR_TYPES):
        return "transient"
    if (
        isinstance(exc, OSError)
        and getattr(exc, "errno", None) in TRANSIENT_ERRNOS
    ):
        return "transient"
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(marker in text for marker in TRANSIENT_ERROR_MARKERS):
        return "transient"
    return "fatal"


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter.

    Delay before retry ``i`` (0-based) is
    ``min(max_delay_s, base_delay_s * 2**i) * (1 + U(-jitter, +jitter))``,
    with the uniform draw from a seeded stream so schedules are
    reproducible (``seed=None`` derives one from the PID — decorrelated
    across fleet processes, still loggable).
    """

    max_retries: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 60.0
    jitter: float = 0.25
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s, got "
                f"{self.base_delay_s}/{self.max_delay_s}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")


def backoff_delays(policy: RetryPolicy) -> Iterator[float]:
    """The policy's delay sequence (one entry per retry)."""
    rng = random.Random(
        policy.seed if policy.seed is not None else os.getpid()
    )
    for i in range(policy.max_retries):
        base = min(policy.max_delay_s, policy.base_delay_s * (2.0 ** i))
        yield base * (1.0 + rng.uniform(-policy.jitter, policy.jitter))


class RetryStats:
    """Mutable retry accounting for one dispatch envelope.

    Pass :meth:`hook` as ``run_with_retry(on_retry=...)`` (or chain it
    from an existing hook) and the envelope's transient retries and
    cumulative backoff are counted (:meth:`counters`)."""

    def __init__(self):
        self.retries = 0
        self.backoff_s = 0.0
        self.last_reason: Optional[str] = None

    def hook(self, exc: BaseException, try_idx: int, delay: float) -> None:
        self.retries += 1
        self.backoff_s += float(delay)
        self.last_reason = f"{type(exc).__name__}: {exc}"

    def counters(self) -> dict:
        """The accumulated totals."""
        return {
            "dispatch_retries": self.retries,
            "dispatch_backoff_s": self.backoff_s,
        }


def run_with_retry(
    attempt: Callable[[int], object],
    *,
    policy: RetryPolicy = RetryPolicy(),
    classify: Callable[[BaseException], str] = classify_error,
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``attempt(try_index)`` until it succeeds or retries exhaust.

    Fatal errors re-raise immediately; transient errors sleep the
    policy's backoff delay and retry (``on_retry(exc, next_try, delay)``
    fires first — the hook for ``backend_degraded`` telemetry and the
    caller's snapshot restore logging).  The final transient failure
    re-raises the original exception, so the caller's stack trace is the
    real one.
    """
    delays = backoff_delays(policy)
    try_idx = 0
    while True:
        try:
            return attempt(try_idx)
        except BaseException as exc:  # noqa: BLE001 — classified below
            if classify(exc) != "transient":
                raise
            delay = next(delays, None)
            if delay is None:
                raise
            try_idx += 1
            if on_retry is not None:
                on_retry(exc, try_idx, delay)
            sleep(delay)


# ----------------------------------------------------------------------
# require_tpu: the card the port runs on


def tpu_required(config=None) -> bool:
    """Whether this run demands the accelerator: the ``MURMURA_REQUIRE_TPU=1``
    env twin, or ``durability.require_tpu`` in the config."""
    if os.environ.get("MURMURA_REQUIRE_TPU") == "1":
        return True
    if config is not None:
        dur = getattr(config, "durability", None)
        if dur is not None and getattr(dur, "require_tpu", False):
            return True
    return False


def require_tpu(device, source: str = "--require-tpu") -> None:
    """Hard-fail unless ``device`` is a usable CUDA card.  ``source`` names
    the knob that demanded it, so the error explains itself."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise BackendRequirementError(
            f"{source}: the accelerator is required but this run's device is "
            f"'{device.type}'; refusing to run on the CPU — drop --device cpu or "
            "drop the requirement"
        )
    if not torch.cuda.is_available():
        raise BackendRequirementError(
            f"{source}: the accelerator is required but CUDA is not available"
        )
