"""Single-machine launcher of the ZMQ backend (the PyTorch counterpart of
murmura_tpu/distributed/runner.py; reference:
murmura/distributed/runner.py:33-213).

Computes a shared t_start = monotonic() + startup_grace, prints run_id and
t_start for multi-machine operators, spawns the monitor first and then one
process per node (module-level entry points, the ``spawn`` context: never a
fork of a process that may hold CUDA), then the fault injector; reads the
monitor's history, and stops every process it started.  On the card the
kernels are built once here, before the spawn, so that N children do not
run ``nvcc`` at once; each node runs on ``cuda:(node_id % device_count)``,
or on the CPU under ``device="cpu"``.
"""

import multiprocessing as mp
import queue as queue_mod
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.distributed.endpoints import Endpoints


def _monitor_main(config: Config, run_id: str, t_start: float,
                  compromised: List[int], queue) -> None:
    from murmura_tpu_torch.distributed.monitor import Monitor

    history = Monitor(
        config, run_id, t_start, compromised_ids=set(compromised)
    ).run()
    queue.put(history)


def _node_main(config: Config, node_id: int, run_id: str, t_start: float,
               compromised: List[int], resume: bool = False, device: str = "cuda",
               spawned_at: Optional[float] = None) -> None:
    from murmura_tpu_torch.distributed.node_process import node_class

    node_class(config)(
        config,
        node_id=node_id,
        run_id=run_id,
        t_start=t_start,
        compromised_ids=compromised,
        resume=resume,
        device=device,
        spawned_at=spawned_at,
    ).run()


class DistributedRunner:
    """Launches monitor + N node processes on this machine.

    ``run()`` is ``start()`` + ``wait()``.  The split lets callers reach the
    spawned processes mid-run (a test SIGKILLs a node between rounds and
    checks that the survivors degrade per the deadline semantics).
    """

    def __init__(self, config: Config, device: str = "cuda"):
        self.config = config
        self.device = device
        self.node_procs: List[Any] = []
        self.t_start: float = 0.0
        self._monitor = None
        self._queue = None
        # Fault injection (config.faults.enabled with churn): the injector
        # thread SIGKILLs scheduled nodes mid-round and respawns them
        # (resume-from-checkpoint) at their scheduled recovery.
        self.injector = None
        self._ctx = None
        self._run_id = None
        self._compromised: List[int] = []

    def run(self) -> Dict[str, List[Any]]:
        self.start()
        return self.wait()

    def start(self) -> None:
        import importlib.util

        from murmura_tpu_torch.data.registry import build_federated_data
        from murmura_tpu_torch.utils.factories import (
            build_attack,
            build_fault_schedule,
            resolve_model,
        )

        if self.config.dmtt is not None:
            # Fail fast in the parent rather than letting every child die
            # and the monitor idle until its hard deadline.
            if importlib.util.find_spec("murmura_tpu_torch.dmtt.node_process") is None:
                raise RuntimeError(
                    "config.dmtt is set but the DMTT protocol module is not "
                    "available in this build"
                )
        # The same fail-fast for the data/model wiring: a mismatch would
        # crash all N children while the parent idles for the whole time
        # budget.  max_samples=32 keeps the throwaway data cheap: the shape
        # check needs one sample's dimensionality.
        resolve_model(
            self.config,
            build_federated_data(
                self.config.data.adapter,
                self.config.data.params,
                num_nodes=self.config.topology.num_nodes,
                seed=self.config.experiment.seed,
                max_samples=min(32, self.config.training.max_samples or 32),
            ),
        )
        if self.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available: the distributed backend's nodes run on "
                    "the card by default; pass --device cpu to run on the CPU"
                )
            from murmura_tpu_torch.ops import _build

            _build.build_all()

        cfg = self.config
        attack = build_attack(cfg)
        compromised = sorted(np.flatnonzero(attack.compromised).tolist()) if attack else []

        run_id = uuid.uuid4().hex[:8]
        endpoints = Endpoints(cfg.distributed, run_id)
        endpoints.ensure_dirs()

        t_start = time.monotonic() + cfg.distributed.startup_grace_s
        print(
            f"[runner] run_id={run_id} t_start={t_start:.3f} "
            f"(grace {cfg.distributed.startup_grace_s}s, device {self.device}) — pass "
            "these to `python -m murmura_tpu_torch run-node` on other machines",
            flush=True,
        )

        ctx = mp.get_context("spawn")
        self._ctx = ctx
        self._run_id = run_id
        self._compromised = compromised
        self._queue = ctx.Queue()
        self._monitor = ctx.Process(
            target=_monitor_main,
            args=(cfg, run_id, t_start, compromised, self._queue),
            daemon=False,
        )
        self._monitor.start()

        self.t_start = t_start
        self.node_procs = []
        for node_id in range(cfg.topology.num_nodes):
            p = ctx.Process(
                target=_node_main,
                args=(cfg, node_id, run_id, t_start, compromised, False, self.device,
                      time.monotonic()),
                daemon=False,
            )
            p.start()
            self.node_procs.append(p)

        schedule = build_fault_schedule(cfg)
        if schedule is not None and cfg.faults.crash_prob > 0:
            from murmura_tpu_torch.faults.injector import FaultInjector

            self.injector = FaultInjector(
                schedule,
                rounds=cfg.experiment.rounds,
                round_duration=cfg.distributed.round_duration_s,
                t_start=t_start,
                kill=self._kill_node,
                respawn=self._respawn_node,
            )
            self.injector.start()

    def _kill_node(self, node_id: int) -> None:
        """SIGKILL a node's current process (FaultInjector callback)."""
        import os
        import signal

        p = self.node_procs[node_id]
        if p.is_alive():
            os.kill(p.pid, signal.SIGKILL)

    def _respawn_node(self, node_id: int) -> None:
        """Start a fresh resume-from-checkpoint process for a recovering
        node (FaultInjector callback)."""
        old = self.node_procs[node_id]
        if old.is_alive():  # pragma: no cover - schedule/kill race
            return
        p = self._ctx.Process(
            target=_node_main,
            args=(self.config, node_id, self._run_id, self.t_start,
                  self._compromised, True, self.device, time.monotonic()),
            daemon=False,
        )
        p.start()
        self.node_procs[node_id] = p

    def wait(self) -> Dict[str, List[Any]]:
        cfg = self.config
        history: Optional[Dict[str, List[Any]]] = None
        try:
            # generous budget: rounds * duration + grace + hard-deadline margin
            budget = (
                cfg.distributed.startup_grace_s
                + (cfg.experiment.rounds + 3) * cfg.distributed.round_duration_s
                + 60.0
            )
            deadline = time.monotonic() + budget
            # Read before joining: a monitor whose history fills the pipe
            # exits only once it has been read.
            while history is None:
                try:
                    history = self._queue.get(timeout=1.0)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        break
                    if not self._monitor.is_alive():
                        try:
                            history = self._queue.get(timeout=1.0)
                        except queue_mod.Empty:
                            pass
                        break
            self._monitor.join(timeout=5.0)
            if self._monitor.is_alive():
                self._monitor.terminate()
                self._monitor.join(timeout=5.0)
        finally:
            if self.injector is not None:
                self.injector.stop()
            for p in self.node_procs:
                p.join(timeout=5.0)
            for p in self.node_procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
        if cfg.telemetry.enabled:
            # The Monitor process owns the manifest (one writer per run).
            from murmura_tpu_torch.utils.factories import default_telemetry_dir

            print(
                f"[runner] telemetry run written to "
                f"{default_telemetry_dir(cfg)} — render it with "
                "`python -m murmura_tpu_torch report <dir>`",
                flush=True,
            )
        return history or {}
