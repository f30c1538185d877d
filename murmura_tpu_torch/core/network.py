"""Network orchestrator (the PyTorch counterpart of
murmura_tpu/core/network.py, per-round dispatch only).

Drives the round program across rounds, keeps the JAX package's history
schema, and records the per-node ``agg_*`` rule statistics exactly as the
JAX package does.
"""

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import Attack
from murmura_tpu_torch.core.rounds import RoundProgram, round_generators
from murmura_tpu_torch.topology.base import Topology


def _host(t: torch.Tensor) -> np.ndarray:
    """A metric on the host; bfloat16 stats (a rule's over bfloat16
    parameters) are widened, exactly, since numpy has no bfloat16."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
    ):
        n = program.num_nodes
        if topology.num_nodes != n:
            raise ValueError(
                f"Topology has {topology.num_nodes} nodes, data/model stack has {n}"
            )
        self.program = program
        self.topology = topology
        self.attack = attack
        self.seed = seed
        self.device = program.device
        self.compromised = (
            attack.compromised.astype(np.float32)
            if attack is not None
            else np.zeros(n, dtype=np.float32)
        )
        self._comp = torch.as_tensor(self.compromised).to(self.device)
        self._adj = torch.as_tensor(topology.mask()).to(self.device)
        self.flat = program.init_flat
        self.agg_state = dict(program.init_agg_state)
        self.history: Dict[str, List[Any]] = empty_history()
        self.round_times: List[float] = []
        self.current_round = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(
        self, rounds: int, verbose: bool = False, eval_every: int = 1
    ) -> Dict[str, List[Any]]:
        """Run ``rounds`` FL rounds, evaluating every ``eval_every``-th.

        Round r draws its shuffle and attack noise from generators seeded by
        (seed, r), so the stream does not depend on how the rounds are split
        across calls.  Each round's wall time ends in a device synchronise.
        """
        for _ in range(rounds):
            round_idx = self.current_round
            t0 = time.perf_counter()
            self.flat, self.agg_state, agg_metrics = self.program.train_step(
                self.flat, self.agg_state, self._adj, self._comp,
                float(round_idx),
                generators=round_generators(self.seed, round_idx, self.device),
            )
            self.current_round = round_idx + 1
            if self.current_round % eval_every == 0:
                metrics = {**self.program.eval_step(self.flat), **agg_metrics}
                metrics = {k: _host(v) for k, v in metrics.items()}
                self._record(self.current_round, metrics, verbose)
            self._sync()
            self.round_times.append(time.perf_counter() - t0)
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
