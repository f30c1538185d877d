# Counterpart of murmura_tpu/analysis/sanitizers.py.
"""Runtime sanitizers of the round loop (``tpu.recompile_guard`` and
``tpu.transfer_guard``; core/network.py, core/gang.py and
population/engine.py wire them around their rounds).

Eager torch compiles no program a round, so the port's two analogues of an
XLA compile are what it does build: a new ``build_multi_round`` (or a
gang's ``build_gang_multi_round``) entry, counted here by
:func:`note_program_build`, and an ``nvcc`` build, which ops/_build.py
records in ``STARTED``.  :func:`compile_count` sums the two, and
:class:`CompileTracker` counts them over a block, as the JAX package's
tracker counts XLA compiles.

:func:`transfer_sanitizer` raises on any call that synchronises the card
with the host (``torch.cuda.set_sync_debug_mode("error")``), the
counterpart of ``jax.transfer_guard("disallow")``.
"""

import contextlib
from typing import Iterator

import torch

from murmura_tpu_torch.ops import _build

_program_builds = 0


def note_program_build() -> None:
    """Count one fused round program built (core/rounds.py, core/gang.py)."""
    global _program_builds
    _program_builds += 1


def compile_count() -> int:
    """Process-wide program builds plus nvcc builds started so far."""
    return _program_builds + len(_build.STARTED)


class RecompileError(RuntimeError):
    """tpu.recompile_guard: a program was rebuilt, or a kernel compiled,
    after its key's first chunk."""


class CompileTracker:
    """The builds since it was created (:func:`compile_count` is
    process-wide: any build counts, whoever started it)."""

    def __init__(self) -> None:
        self._baseline = compile_count()

    @property
    def total(self) -> int:
        """Builds since this tracker was created."""
        return compile_count() - self._baseline


@contextlib.contextmanager
def track_compiles() -> Iterator[CompileTracker]:
    """Context manager yielding a fresh :class:`CompileTracker`."""
    yield CompileTracker()


@contextlib.contextmanager
def transfer_sanitizer():
    """Raise on any call that synchronises the card with the host."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
