"""The group launcher (the JAX package needs no processes: GSPMD places its
collectives).

:func:`launch` runs ``fn(*args)`` in W spawned ranks of one
``torch.distributed`` group and returns every rank's return value; each
rank's process group is a :class:`ParamGroup` (``axis="param"``), a
:class:`NodeGroup` (``axis="nodes"``) or a :class:`SeedGroup`
(``axis="seed"``):

- the ``spawn`` start method and a ``file://`` rendezvous in a temporary
  directory, so no TCP port is taken;
- ``init_process_group(timeout=...)``, so that a rank that dies fails the
  others' collectives instead of leaving them waiting;
- a rank's exception ends the run: the other ranks are stopped and the
  parent raises with that rank's traceback (a :class:`ConfigError` as a
  ConfigError, which the CLI renders as a message);
- a rank dies with the process that launched it (:func:`_die_with_parent`:
  Linux's parent-death signal, else a thread that watches the parent), so
  that a killed ``serve`` leaves no rank holding its socket, its state
  directory or a card;
- on CUDA the kernels are built once, in the parent, before the ranks
  start (otherwise W ranks would run ``nvcc`` at once);
- each rank sets its card (``torch.cuda.set_device``) before its first
  kernel: the distance kernels lift their shared-memory cap once a process,
  on the card that is current then.

Rank r runs on ``cuda:r`` over NCCL, or on the CPU over gloo.  With
``one_device`` every rank shares ``cuda:0`` over gloo (a test seam: a check
of the collective code on CUDA tensors, not a layout the CLI picks).  Ranks
other than 0 print nothing.

The CLI's ``run`` launches its ranks (cli.py) when the config's layout has
a param axis above 1, or a node axis above 1 at ``tpu.param_shards: 1``;
``sweep``, ``run --seeds``, ``frontier``, ``grid`` and ``serve`` launch
theirs, once for the command (``serve``: for the daemon's lifetime), when
the gang plan's param axis or (at ``tpu.param_shards: 1``) its seed axis is
above 1; the tests and ``chip_smoke.py`` launch their own module-level
functions.

:func:`join` is the entry of a run started as P processes (``tpu.multihost``,
the JAX package's ``init_multihost``): process p of P runs the global ranks
``p L .. p L + L - 1`` of one group of ``W = P L`` ranks, which meet at
``tcp://<coordinator_address>`` instead of a rendezvous file.  At ``L = 1``
the rank runs in the calling process; above, the process spawns its local
ranks as :func:`launch` does, with the same promises (the group timeout, a
rank's failure ending the run with its traceback, ranks dying with their
launcher, the kernels built first, ``cuda:l`` for local rank l over NCCL,
gloo on the CPU, the ``one_device`` seam).  Process 0 gets every rank's
return value, gathered over the group before it closes; the others get their
own ranks'.  A process already in a group ignores a second join, as JAX
ignores a second ``init_multihost``.
"""

import ctypes
import os
import pickle
import signal
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from murmura_tpu_torch.parallel.mesh import (
    NodeGroup,
    ParamGroup,
    SeedGroup,
    process_group,
    set_process_group,
)

GROUPS = {"param": ParamGroup, "nodes": NodeGroup, "seed": SeedGroup}

# Seconds a collective may wait for the other ranks.
GROUP_TIMEOUT_S = 600
# What a rank must not have loaded (the port stands alone).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "murmura_tpu")


class GroupError(RuntimeError):
    """A rank of the group failed; the message carries its traceback."""


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


# prctl(2)'s option that arms the parent-death signal.
_PR_SET_PDEATHSIG = 1


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when ``parent`` (the launcher) dies: Linux's
    parent-death signal through ``prctl``, else a thread that polls the
    parent pid; and at once if the parent is already gone."""
    armed = False
    if sys.platform.startswith("linux"):
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            armed = libc.prctl(_PR_SET_PDEATHSIG, int(signal.SIGKILL), 0, 0, 0) == 0
        except (OSError, AttributeError):
            armed = False
    if not armed:
        def watch():
            while os.getppid() == parent:
                time.sleep(0.5)
            os.kill(os.getpid(), signal.SIGKILL)

        threading.Thread(target=watch, name="murmura-parent-watch", daemon=True).start()
    if os.getppid() != parent:
        # The parent died before the signal was armed.
        os.kill(os.getpid(), signal.SIGKILL)


def _rank_device(device_type: str, one_device: bool, local: int, local_world: int):
    """Set and return a rank's device: ``cuda:local`` (``cuda:0`` with
    ``one_device``), or the CPU with a share of its cores (``local_world``
    ranks of the machine's thread count would oversubscribe it)."""
    if device_type == "cuda":
        index = 0 if one_device else local
        torch.cuda.set_device(index)
        return torch.device("cuda", index)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    return torch.device("cpu")


def _record_error(tmp: str, rank: int, e: BaseException) -> None:
    with open(Path(tmp) / f"error.{rank}", "wb") as f:
        pickle.dump((time.time(), type(e).__name__, str(e), traceback.format_exc()), f)


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int, backend: str,
               device_type: str, one_device: bool, tmp: str, timeout_s: float,
               axis: str = "param", parent: Optional[int] = None) -> None:
    import torch.distributed as dist

    if parent is not None:
        _die_with_parent(parent)
    device = _rank_device(device_type, one_device, rank, world)
    if rank:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    set_process_group(GROUPS[axis](rank, world, backend, device))
    try:
        result = fn(*args)
    except BaseException as e:
        _record_error(tmp, rank, e)
        raise
    with open(Path(tmp) / f"result.{rank}", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def _prepare(axis: str, world: int, local_world: int, device_type: str,
             one_device: bool) -> str:
    """Check a group's request, build the kernels on CUDA (before any rank
    starts), and return the collective backend."""
    if axis not in GROUPS:
        raise ValueError(f"a group's axis is one of {sorted(GROUPS)}, got {axis!r}")
    if world < 2:
        raise ValueError(f"a {axis} group needs at least 2 ranks, got {world}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the group's ranks run on the card")
        if not one_device and local_world > torch.cuda.device_count():
            raise ValueError(f"Requested {local_world} devices but only "
                             f"{torch.cuda.device_count()} available")
        from murmura_tpu_torch.ops import _build

        _build.build_all()
    return "nccl" if device_type == "cuda" and not one_device else "gloo"


def launch(fn: Callable, args: Sequence = (), *, world: int, device_type: str = "cpu",
           one_device: bool = False, timeout_s: float = GROUP_TIMEOUT_S,
           axis: str = "param") -> List[Any]:
    """``fn(*args)`` in ``world`` ranks (module-level and picklable, as
    ``spawn`` needs) of a param, node or seed group (``axis``); returns the
    ranks' return values in rank order."""
    import torch.multiprocessing as mp

    backend = _prepare(axis, world, world, device_type, one_device)
    with tempfile.TemporaryDirectory(prefix="murmura-group-") as tmp:
        try:
            mp.start_processes(_rank_main, args=(fn, tuple(args), world, backend, device_type,
                                                 one_device, tmp, timeout_s, axis, os.getpid()),
                               nprocs=world, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise _rank_failure(Path(tmp), e, axis) from None
        return [pickle.loads((Path(tmp) / f"result.{r}").read_bytes()) for r in range(world)]


def _rank_failure(tmp: Path, exc: Exception, axis: str) -> Exception:
    """The exception the parent raises for a failed rank: the earliest a
    rank recorded (the others' are mostly their collectives failing after
    it; a ConfigError as itself), else the exit."""
    records = sorted((pickle.loads(p.read_bytes()), p.suffix[1:]) for p in tmp.glob("error.*"))
    if not records:
        return GroupError(f"a rank of the {axis} group failed: {exc}")
    (_, name, message, tb), rank = records[0]
    if name == "ConfigError":
        from murmura_tpu_torch.utils.factories import ConfigError

        return ConfigError(message)
    return GroupError(f"rank {rank} of the {axis} group failed:\n{tb}")


def _join_rank(local: int, fn: Callable, args: Sequence, coordinator: str, process_id: int,
               num_processes: int, local_world: int, backend: str, device_type: str,
               one_device: bool, timeout_s: float, axis: str) -> List[Any]:
    """Global rank ``process_id * local_world + local`` of a joined group:
    join at ``tcp://coordinator``, run ``fn(*args)``, gather every rank's
    value to global rank 0 (which returns them all, in rank order; the
    others their own, as a list of one), and leave the group."""
    import torch.distributed as dist

    world = num_processes * local_world
    rank = process_id * local_world + local
    device = _rank_device(device_type, one_device, local, local_world)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
    except (RuntimeError, OSError) as e:  # the store's timeout and connection errors
        raise GroupError(
            f"process {process_id} of {num_processes} could not join the {axis} group of "
            f"{world} ranks at tcp://{coordinator} within {timeout_s:g} s (is every "
            f"process started, with the same coordinator_address?): "
            f"{type(e).__name__}: {e}") from None
    stdout = sys.stdout
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        set_process_group(GROUPS[axis](rank, world, backend, device, processes=num_processes))
        result = fn(*args)
        values = [None] * world if rank == 0 else None
        dist.gather_object(result, values, dst=0)
        return values if rank == 0 else [result]
    finally:
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout
        set_process_group(None)
        dist.destroy_process_group()


def _join_spawned(local: int, fn: Callable, args: Sequence, coordinator: str, process_id: int,
                  num_processes: int, local_world: int, backend: str, device_type: str,
                  one_device: bool, timeout_s: float, axis: str, tmp: str,
                  parent: int) -> None:
    """A local rank that :func:`join` spawned: :func:`_join_rank`, its
    values or its error written for the launcher."""
    _die_with_parent(parent)
    try:
        values = _join_rank(local, fn, args, coordinator, process_id, num_processes,
                            local_world, backend, device_type, one_device, timeout_s, axis)
    except BaseException as e:
        _record_error(tmp, process_id * local_world + local, e)
        raise
    with open(Path(tmp) / f"result.{local}", "wb") as f:
        pickle.dump(values, f)


def join(fn: Callable, args: Sequence = (), *, coordinator: str, num_processes: int,
         process_id: int, local_world: int = 1, device_type: str = "cpu",
         one_device: bool = False, timeout_s: float = GROUP_TIMEOUT_S,
         axis: str = "param") -> List[Any]:
    """``fn(*args)`` in this process's ``local_world`` ranks of a param, node
    or seed group of ``num_processes * local_world`` ranks spread over
    ``num_processes`` processes that meet at ``tcp://coordinator`` (``host:port``
    of process 0, which holds the rendezvous store).  Returns, on process 0,
    every rank's return value in global rank order; elsewhere this process's
    ranks' values.  A peer that does not arrive within ``timeout_s`` fails
    the join with a :class:`GroupError` naming the coordinator.  In a
    process that is already a rank of a group the join is ignored: ``fn``
    runs there, and its value comes back alone."""
    if process_group() is not None:
        return [fn(*args)]
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    if local_world < 1:
        raise ValueError(f"a process runs at least 1 rank, got {local_world}")
    host, _, port = str(coordinator).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got {coordinator!r}")
    world = num_processes * local_world
    backend = _prepare(axis, world, local_world, device_type, one_device)
    common = (fn, tuple(args), coordinator, process_id, num_processes, local_world, backend,
              device_type, one_device, timeout_s, axis)
    if local_world == 1:
        return _join_rank(0, *common)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="murmura-join-") as tmp:
        try:
            mp.start_processes(_join_spawned, args=(*common, tmp, os.getpid()),
                               nprocs=local_world, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise _rank_failure(Path(tmp), e, axis) from None
        parts = [pickle.loads((Path(tmp) / f"result.{r}").read_bytes())
                 for r in range(local_world)]
    return parts[0] if process_id == 0 else [v for part in parts for v in part]
