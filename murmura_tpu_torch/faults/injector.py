"""Crash realism for the distributed backend: SIGKILL on schedule, respawn
on recovery (copy of murmura_tpu/faults/injector.py).

The :class:`FaultSchedule` *describes* churn; on the jitted backends the
orchestrator folds it into adjacency masks, but on the ZMQ backend a dead
node must actually BE dead — a killed OS process, not a masked tensor row.
:class:`FaultInjector` is the enforcement layer: a watcher thread in the
runner parent that, at each wall-clock round boundary, SIGKILLs the
processes of nodes the schedule crashes this round (mid-round, after
``kill_fraction`` of the window, so round-in-flight state is really lost)
and respawns recovering nodes one round *early* so the fresh process can
pay its import/compile boot cost during its last scheduled-dead round and
rejoin, restored from its per-node checkpoint, exactly at the scheduled
recovery round (node self-enforcement skips the still-dead boot round; see
distributed/node_process.py).

The injector never decides *who* dies: the schedule does, deterministically
from the seed, so survivors' expected-neighbor sets (re-resolved from the
same schedule) stay consistent with the kills without any control messages.
"""

import threading
import time
from typing import Callable, Optional

from murmura_tpu_torch.faults.schedule import FaultSchedule


class FaultInjector:
    """Watcher thread enacting a FaultSchedule on live node processes.

    Args:
        schedule: The shared deterministic schedule.
        rounds: Experiment horizon (no kills/respawns past it).
        round_duration: Wall-clock seconds per round.
        t_start: Shared monotonic round-0 start (the runner's t_start).
        kill: ``kill(node_id)`` — SIGKILL the node's current process.
        respawn: ``respawn(node_id)`` — start a fresh process for the node
            (with resume-from-checkpoint semantics).
        kill_fraction: Where inside the round window the kill lands
            (0.5 = mid-round: after training has typically started, before
            the exchange completes — the maximally disruptive point).
    """

    def __init__(
        self,
        schedule: FaultSchedule,
        rounds: int,
        round_duration: float,
        t_start: float,
        kill: Callable[[int], None],
        respawn: Callable[[int], None],
        kill_fraction: float = 0.5,
    ):
        self.schedule = schedule
        self.rounds = rounds
        self.round_duration = round_duration
        self.t_start = t_start
        self._kill = kill
        self._respawn = respawn
        self.kill_fraction = min(max(kill_fraction, 0.0), 0.95)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Telemetry for tests/post-mortems: (round, "kill"|"respawn", node).
        self.events = []

    # ------------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="murmura-fault-injector", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _sleep_until(self, target: float) -> bool:
        """Sleep until monotonic ``target``; False if stopped meanwhile."""
        while not self._stop.is_set():
            delay = target - time.monotonic()
            if delay <= 0:
                return True
            self._stop.wait(min(delay, 0.2))
        return False

    def _do_respawn(self, node_id: int, recovery_round: int) -> None:
        try:
            self._respawn(node_id)
            self.events.append((recovery_round, "respawn", node_id))
        except Exception as e:  # pragma: no cover - spawn races
            print(
                f"[injector] respawn of node {node_id} failed: {e}",
                flush=True,
            )

    def _run(self) -> None:
        import numpy as np

        for r in range(self.rounds):
            died = self.schedule.died_at(r)
            # Respawn one round early: nodes scheduled to recover at r+1
            # boot (imports, dataset load, jit warmup, checkpoint restore)
            # during round r — which they self-skip as still-dead — and are
            # ready at the r+1 window open.  A node down for exactly ONE
            # round (dying at r AND recovering at r+1) must wait for its
            # own kill first: its old process is still alive at window
            # start, so an early respawn would be skipped — and had it
            # succeeded, the r+0.5 kill would SIGKILL the replacement.
            recovering_next = (
                self.schedule.recovered_at(r + 1)
                if r + 1 < self.rounds
                else np.zeros(self.schedule.num_nodes, dtype=bool)
            )
            if not self._sleep_until(self.t_start + r * self.round_duration):
                return
            for node_id in map(int, (recovering_next & ~died).nonzero()[0]):
                self._do_respawn(node_id, r + 1)
            if died.any():
                if not self._sleep_until(
                    self.t_start + (r + self.kill_fraction) * self.round_duration
                ):
                    return
                for node_id in map(int, died.nonzero()[0]):
                    try:
                        self._kill(node_id)
                        self.events.append((r, "kill", node_id))
                    except Exception as e:  # pragma: no cover - kill races
                        print(
                            f"[injector] kill of node {node_id} failed: {e}",
                            flush=True,
                        )
                for node_id in map(int, (recovering_next & died).nonzero()[0]):
                    self._do_respawn(node_id, r + 1)
