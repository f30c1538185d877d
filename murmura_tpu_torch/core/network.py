"""Network orchestrator (the PyTorch counterpart of
murmura_tpu/core/network.py).

Drives the round program across rounds, per round or fused into chunks of
rounds (``rounds_per_dispatch``), folds the fault schedule into each
round's adjacency and alive mask, keeps the JAX package's history schema,
and records the per-node ``agg_*`` rule statistics exactly as the JAX
package does.  With a telemetry writer (telemetry/writer.py) it emits the
round, phase_times and memory events, finalizes the manifest when
``train`` returns, and opens the profiler window (a ``torch.profiler``
trace, written as Chrome trace JSON) over the configured rounds.
"""

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import Attack
from murmura_tpu_torch.core.rounds import RoundProgram, build_multi_round
from murmura_tpu_torch.faults.schedule import FaultSchedule
from murmura_tpu_torch.topology.base import Topology


def effective_adjacency(topology, fault_schedule, round_idx: int) -> np.ndarray:
    """One round's [N, N] adjacency: the static mask with the fault
    schedule's alive, link and straggler masks folded in (mobility, the
    JAX package's other source of a per-round graph, is not ported)."""
    adj = topology.mask()
    if fault_schedule is not None:
        adj = fault_schedule.masked_adjacency(adj, round_idx)
    return adj


def effective_alive(fault_schedule, num_nodes: int, round_idx: int) -> np.ndarray:
    """[N] float32 alive mask for a faulted program's extra input."""
    if fault_schedule is not None:
        return fault_schedule.alive_at(round_idx)
    return np.ones(num_nodes, dtype=np.float32)


def _host_rows(rows: List[Tuple[int, Dict[str, torch.Tensor]]]):
    """Evaluated rows (round number, metrics) on the host in one
    device-to-host copy: every metric widened to float64 (exact for
    float32, bfloat16 and indices below 2^53) and packed into one tensor,
    then given back its dtype, bfloat16 as float32 (numpy has none)."""
    tensors = [t.detach() for _, m in rows for t in m.values()]
    if not tensors:
        return []
    packed = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for round_num, metrics in rows:
        host = {}
        for k, t in metrics.items():
            dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
            host[k] = packed[off:off + t.numel()].astype(
                torch.empty((), dtype=dtype).numpy().dtype).reshape(tuple(t.shape))
            off += t.numel()
        out.append((round_num, host))
    return out


def empty_history() -> Dict[str, List[Any]]:
    """The history schema (the JAX package's, key for key)."""
    return {
        "round": [],
        "mean_accuracy": [],
        "std_accuracy": [],
        "mean_loss": [],
        "honest_accuracy": [],
        "compromised_accuracy": [],
        "mean_vacuity": [],
        "mean_entropy": [],
        "mean_strength": [],
    }


def record_round_metrics(
    history: Dict[str, List[Any]],
    round_num: int,
    metrics: Dict[str, np.ndarray],
    compromised: np.ndarray,
    evidential: bool,
    has_attack: bool,
) -> None:
    """Append one evaluated round to ``history``.  The ``mean_vacuity`` /
    ``mean_entropy`` / ``mean_strength`` columns fill for evidential models
    only."""
    acc = np.asarray(metrics["accuracy"])
    loss = np.asarray(metrics["loss"])
    comp = np.asarray(compromised) > 0

    history["round"].append(round_num)
    history["mean_accuracy"].append(float(acc.mean()))
    history["std_accuracy"].append(float(acc.std()))
    history["mean_loss"].append(float(loss.mean()))
    if has_attack and comp.any():
        history["honest_accuracy"].append(float(acc[~comp].mean()))
        history["compromised_accuracy"].append(float(acc[comp].mean()))
    if evidential:
        for k in ("vacuity", "entropy", "strength"):
            history[f"mean_{k}"].append(float(np.asarray(metrics[k]).mean()))
    for k, v in metrics.items():
        if k.startswith("agg_"):
            arr = np.asarray(v, dtype=np.float64)
            history.setdefault(k, []).append(
                float(arr.mean()) if arr.ndim else float(arr)
            )


class Network:
    """Orchestrates decentralized FL over a round program."""

    def __init__(
        self,
        program: RoundProgram,
        topology: Topology,
        attack: Optional[Attack] = None,
        seed: int = 42,
        fault_schedule: Optional[FaultSchedule] = None,
        telemetry=None,
        profile_dir: Optional[str] = None,
    ):
        """``telemetry``: a TelemetryWriter, or None (no events, and the
        history and round program are unchanged either way).
        ``profile_dir`` (tpu.profile_dir): trace every ``train`` call with
        torch.profiler into this directory."""
        n = program.num_nodes
        if topology.num_nodes != n:
            raise ValueError(
                f"Topology has {topology.num_nodes} nodes, data/model stack has {n}"
            )
        if fault_schedule is not None and not program.faulted:
            raise ValueError(
                "A fault schedule was supplied but the round program was "
                "built without faults (build_round_program(faults=...)); "
                "the alive mask would silently never reach the round step"
            )
        self.program = program
        self.topology = topology
        self.attack = attack
        self.seed = seed
        self.fault_schedule = fault_schedule
        self.device = program.device
        self.compromised = (
            attack.compromised.astype(np.float32)
            if attack is not None
            else np.zeros(n, dtype=np.float32)
        )
        self._comp = torch.as_tensor(self.compromised).to(self.device)
        self.flat = program.init_flat
        self.agg_state = dict(program.init_agg_state)
        self.history: Dict[str, List[Any]] = empty_history()
        self.round_times: List[float] = []
        self.current_round = 0
        self._fused: Dict[Tuple[int, int], Any] = {}
        # With no fault schedule the graph never changes: staged once.
        self._static_adj = (
            torch.as_tensor(topology.mask()).to(self.device)
            if fault_schedule is None else None
        )
        self.telemetry = telemetry
        self.profile_dir = profile_dir
        self._profiler = None  # the open window: (torch.profiler, its first round)
        # Host-side in-degree of each staged round's adjacency (before the
        # round's own folds), popped when the round is recorded.
        self._in_degree: Dict[int, np.ndarray] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, rounds: List[int]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The [k, N, N] adjacency stack of ``rounds`` and, for a faulted
        program, their [k, N] alive stack: each staged in one copy under a
        fault schedule, else views of the static graph and of all-alive."""
        k, n = len(rounds), self.program.num_nodes
        if self._static_adj is not None:
            if self.telemetry is not None:
                deg = self.topology.mask().sum(axis=0)
                self._in_degree.update({r: deg for r in rounds})
            adj = self._static_adj[None].expand(k, -1, -1)
            if not self.program.faulted:
                return adj, None
            return adj, torch.ones((k, n), device=self.device)
        adj = np.stack([effective_adjacency(self.topology, self.fault_schedule, r)
                        for r in rounds])
        if self.telemetry is not None:
            self._in_degree.update({r: a.sum(axis=0) for r, a in zip(rounds, adj)})
        alive = np.stack([effective_alive(self.fault_schedule, n, r) for r in rounds])
        return (torch.as_tensor(adj).to(self.device),
                torch.as_tensor(alive).to(self.device))

    def train(
        self,
        rounds: int,
        verbose: bool = False,
        eval_every: int = 1,
        rounds_per_dispatch: int = 1,
    ) -> Dict[str, List[Any]]:
        """Run ``rounds`` FL rounds, evaluating every ``eval_every``-th.

        Round r draws its shuffle and attack noise from generators seeded by
        (seed, r), so the stream does not depend on how the rounds are split
        across calls or chunks.

        Args:
            rounds_per_dispatch: run this many rounds as one chunk
                (:func:`build_multi_round`): their adjacency (and alive)
                stack staged once, the rounds launched back to back with
                no host synchronisation, evaluation on the ``eval_every``
                cadence, the metrics copied to the host and the device
                synchronised once a chunk, and ``round_times`` the chunk's
                time over its rounds.  1 (the default) makes every round a
                chunk of its own, timed alone.
        """
        first = self.current_round
        whole = self._start_profiler() if self.profile_dir else None
        try:
            self._train_chunks(rounds, verbose, eval_every, rounds_per_dispatch)
        finally:
            if whole is not None:
                self._stop_profiler(whole, self.profile_dir,
                                    f"train_{first}-{self.current_round - 1}")
            # Close a window the run ended inside, and commit the manifest:
            # each train() call re-finalizes with the latest history.  (The
            # JAX package also adds a ``compiles`` counter here; the port
            # compiles nothing per round and counts nothing.)
            self._profile_window_stop(self.current_round, force=True)
            if self.telemetry is not None:
                self.telemetry.finalize(history=self.history)
        return self.history

    def _train_chunks(self, rounds, verbose, eval_every, rounds_per_dispatch) -> None:
        done = 0
        while done < rounds:
            k = min(rounds_per_dispatch, rounds - done)
            if (k, eval_every) not in self._fused:
                self._fused[k, eval_every] = build_multi_round(self.program, k, eval_every)
            round0 = self.current_round
            self._profile_window_start(round0, span=k)
            t0 = time.perf_counter()
            adj_stack, alive_stack = self._stage(list(range(round0, round0 + k)))
            self.flat, self.agg_state, rows = self._fused[k, eval_every](
                self.flat, self.agg_state, self.seed, adj_stack, self._comp, round0,
                alive_stack=alive_stack,
            )
            rows = _host_rows(rows)
            self._sync()
            elapsed = time.perf_counter() - t0
            self.current_round = round0 + k
            # One amortised entry a round: the rounds of a chunk are not
            # timed one by one.
            self.round_times.extend([elapsed / k] * k)
            done += k
            if self.telemetry is not None:
                if rounds_per_dispatch == 1:
                    self.telemetry.phase_times(
                        round0, "per_round", elapsed,
                        evaluated=bool(self.current_round % eval_every == 0),
                        deferred=False,
                    )
                else:
                    for i in range(k):
                        self.telemetry.phase_times(round0 + i, "fused", elapsed / k, chunk=k)
                self.telemetry.memory_event(self.current_round - 1, self.device)
                self._profile_window_stop(self.current_round)
            for round_num, metrics in rows:
                self._record(round_num, metrics, verbose)

    # ------------------------------------------------------------------
    # the profiler (telemetry's round window, and tpu.profile_dir's trace
    # of a whole train() call)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof, trace_dir: str, name: str) -> Path:
        """Stop ``prof`` and write its Chrome trace to ``trace_dir/name``."""
        prof.stop()
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{name}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        return path

    def _window_dir(self) -> str:
        t = self.telemetry
        return t.profile_dir or str(t.run_dir / "trace")

    def _profile_window_start(self, round_idx: int, span: int = 1) -> None:
        """Open the telemetry profiler window at the first chunk
        [round_idx, round_idx + span) that overlaps it.  Not while a whole
        train() trace (tpu.profile_dir) runs: the two do not nest."""
        t = self.telemetry
        if (t is None or not t.profile_rounds or self._profiler is not None
                or self.profile_dir is not None):
            return
        end = t.profile_start_round + t.profile_rounds
        if round_idx < end and round_idx + span > t.profile_start_round:
            self._profiler = (self._start_profiler(), round_idx)
            t.emit("profile", status="started", round=round_idx, trace_dir=self._window_dir())

    def _profile_window_stop(self, next_round: int, force: bool = False) -> None:
        t = self.telemetry
        if t is None or self._profiler is None:
            return
        if force or next_round >= t.profile_start_round + t.profile_rounds:
            prof, first = self._profiler
            self._profiler = None
            path = self._stop_profiler(prof, self._window_dir(),
                                       f"rounds_{first}-{next_round - 1}")
            t.emit("profile", status="stopped", round=next_round - 1,
                   trace_dir=self._window_dir(), trace_file=str(path))

    def _record(self, round_num: int, metrics: Dict[str, np.ndarray], verbose: bool):
        acc = np.asarray(metrics["accuracy"])
        record_round_metrics(
            self.history, round_num, metrics, self.compromised,
            self.program.evidential, self.attack is not None,
        )
        if self.telemetry is not None:
            # Per-node arrays of the recorded round plus the host-side
            # in-degree of the adjacency staged for it; unrecorded rounds'
            # entries (eval_every > 1) are dropped with it.
            in_deg = self._in_degree.pop(round_num - 1)
            self._in_degree = {r: v for r, v in self._in_degree.items() if r >= round_num}
            self.telemetry.round_event(round_num, metrics, in_degree=in_deg)
        if verbose:
            comp = self.compromised > 0
            print(
                f"Round {round_num}: Mean Accuracy = {acc.mean():.4f} ± {acc.std():.4f}",
                flush=True,
            )
            if self.attack is not None and comp.any():
                print(
                    f"  Honest: {acc[~comp].mean():.4f}, "
                    f"Compromised: {acc[comp].mean():.4f}",
                    flush=True,
                )
