"""Network orchestrator (the PyTorch counterpart of
murmura_tpu/core/network.py).

Drives the round program across rounds, per round or fused into chunks of
rounds (``rounds_per_dispatch``), folds the fault schedule into each
round's adjacency and alive mask, keeps the JAX package's history schema,
and records the per-node ``agg_*`` rule statistics exactly as the JAX
package does.
"""

import time
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
    ):
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, rounds: List[int]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The [k, N, N] adjacency stack of ``rounds`` and, for a faulted
        program, their [k, N] alive stack: each staged in one copy under a
        fault schedule, else views of the static graph and of all-alive."""
        k, n = len(rounds), self.program.num_nodes
        if self._static_adj is not None:
            adj = self._static_adj[None].expand(k, -1, -1)
            if not self.program.faulted:
                return adj, None
            return adj, torch.ones((k, n), device=self.device)
        adj = np.stack([effective_adjacency(self.topology, self.fault_schedule, r)
                        for r in rounds])
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
        done = 0
        while done < rounds:
            k = min(rounds_per_dispatch, rounds - done)
            if (k, eval_every) not in self._fused:
                self._fused[k, eval_every] = build_multi_round(self.program, k, eval_every)
            round0 = self.current_round
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
            for round_num, metrics in rows:
                self._record(round_num, metrics, verbose)
        return self.history

    def _record(self, round_num: int, metrics: Dict[str, np.ndarray], verbose: bool):
        acc = np.asarray(metrics["accuracy"])
        record_round_metrics(
            self.history, round_num, metrics, self.compromised,
            self.program.evidential, self.attack is not None,
        )
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
