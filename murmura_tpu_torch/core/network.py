"""Network orchestrator (the PyTorch counterpart of
murmura_tpu/core/network.py).

Drives the round program across rounds, per round or fused into chunks of
rounds (``rounds_per_dispatch``), takes each round's graph from the
mobility model where there is one (G^t, topology/dynamic.py), folds the
fault schedule into each round's adjacency and alive mask, keeps the JAX
package's history schema, and records the per-node ``agg_*`` rule statistics exactly as the JAX
package does.  With a telemetry writer (telemetry/writer.py) it emits the
round, phase_times and memory events, finalizes the manifest when
``train`` returns, and opens the profiler window (a ``torch.profiler``
trace, written as Chrome trace JSON) over the configured rounds.  With a
checkpoint directory it snapshots the whole run state on the chunk
cadence (durability/snapshot.py) and restores it exactly.

Over a param group's round program (parallel/mesh.py) every rank runs the
same Network: ``flat`` is the rank's own node rows and the carried [N, P]
state its column blocks, eval's metrics come back whole on every rank (so
each keeps the same history), the snapshot is gathered into the ordinary
layout and written by rank 0 alone, and only rank 0 has a telemetry
writer (utils/factories.py).  Over a node group's round program the same
holds with ``flat`` the rank's node rows and the carried state whole on
every rank; its snapshot records the node axis, and a snapshot of another
node-axis width is refused both ways.

The two runtime guards of the ``tpu:`` section keep their names:

- ``transfer_guard``: every chunk after the first of its (chunk, eval_every)
  key runs under ``torch.cuda.set_sync_debug_mode("error")``, so a call that
  synchronises with the host inside it raises (the first makes the
  one-time device copies of the attack's rows and the circulant offsets).
  The staging of the chunk's inputs and its one copy-out stay outside, as
  explicit transfers (the JAX package's ``device_put`` and ``device_get``
  under ``transfer_guard("disallow")``).  On the CPU there is nothing to
  synchronise and the guard does nothing.  Over a group joined from several
  processes (``tpu.multihost``) it is refused, in the JAX package's words.
- ``recompile_guard``: eager torch compiles no program a round.  Its two
  analogues of a recompile (analysis/sanitizers.py) raise
  :class:`RecompileError`: a new ``build_multi_round`` entry for a key
  that has already run, and an ``nvcc`` build (ops/_build.py) that starts
  during a chunk that is not the first of its key.  A shorter last chunk
  is a new key, whose first chunk may build, as the JAX package's
  ``chunk_warmup`` allows.
"""

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from murmura_tpu_torch.analysis.sanitizers import RecompileError, transfer_sanitizer
from murmura_tpu_torch.attacks.base import Attack
from murmura_tpu_torch.core.rounds import RoundProgram, build_multi_round
from murmura_tpu_torch.faults.schedule import FaultSchedule
from murmura_tpu_torch.ops import _build
from murmura_tpu_torch.parallel.mesh import (
    NodeGroup,
    barrier,
    gather_columns,
    gather_rows,
    refuse_transfer_guard_across_processes,
)
from murmura_tpu_torch.topology.base import Topology
from murmura_tpu_torch.topology.sparse import SparseTopology
from murmura_tpu_torch.utils.checkpoint import committed_bytes


def effective_adjacency(topology, mobility, fault_schedule, round_idx: int) -> np.ndarray:
    """One round's [N, N] adjacency: the mobility model's G^t (else the
    static mask) with the fault schedule's alive, link and straggler masks
    folded in."""
    if mobility is not None:
        adj = mobility.adjacency_at(round_idx).astype(np.float32)
    else:
        adj = topology.mask()
    if fault_schedule is not None:
        adj = fault_schedule.masked_adjacency(adj, round_idx)
    return adj


def effective_edge_mask(topology, fault_schedule, round_idx: int) -> np.ndarray:
    """One round's [k, N] sparse edge mask (topology/sparse.py): the
    SparseTopology's schedule (static all-ones, or one_peer's single
    offset) with the fault schedule's masks folded in on the host, the
    sparse twin of :func:`effective_adjacency`; O(k·N), never O(N^2)."""
    mask = topology.edge_mask(round_idx)
    if fault_schedule is not None:
        mask = fault_schedule.masked_edge_mask(mask, topology.offsets, round_idx)
    return mask


def round_exchange_input(topology, fault_schedule, round_idx: int,
                         mobility=None) -> np.ndarray:
    """The adjacency input of one round: the [k, N] edge mask of a sparse
    topology, else the [N, N] adjacency."""
    if isinstance(topology, SparseTopology):
        return effective_edge_mask(topology, fault_schedule, round_idx)
    return effective_adjacency(topology, mobility, fault_schedule, round_idx)


def sender_in_degree(topology, mask: np.ndarray) -> np.ndarray:
    """[N] host-side in-degree of each sender (how many receivers read its
    broadcast) under a round's adjacency input."""
    if isinstance(topology, SparseTopology):
        return topology.in_degree_from_edge_mask(mask)
    return mask.sum(axis=0)


def check_exchange_layout(program: RoundProgram, topology) -> None:
    """A sparse round program needs the sparse topology of its offsets, and
    a dense one a dense topology."""
    sparse_topology = isinstance(topology, SparseTopology)
    if program.sparse != sparse_topology:
        raise ValueError(
            "the round program was built with sparse_offsets but the topology is not "
            "a SparseTopology" if program.sparse else
            "the topology is a SparseTopology but the round program was built for the "
            "dense [N, N] adjacency (build it with sparse_offsets=topology.offsets)"
        )
    if program.sparse and tuple(topology.offsets) != tuple(program.sparse_offsets):
        raise ValueError(
            f"sparse topology offsets {tuple(topology.offsets)} != round program "
            f"offsets {tuple(program.sparse_offsets)}"
        )


def static_exchange_input(topology, fault_schedule, mobility=None) -> Optional[np.ndarray]:
    """The adjacency input of every round where it never changes (no fault
    schedule, no mobility and a static schedule), else None: each round (or
    chunk) then stages its own."""
    if fault_schedule is not None or mobility is not None:
        return None
    if isinstance(topology, SparseTopology):
        return topology.edge_mask(0) if topology.schedule == "static" else None
    return topology.mask()


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


def stage_rounds(topology, fault_schedule, program: RoundProgram, static_host, static_adj,
                 rounds: List[int], degrees: bool = False, mobility=None):
    """(adjacency stack, alive stack or None, {round: host sender in-degree})
    of ``rounds`` for ``program`` on its device: views of ``static_adj``
    where the graph never changes, else one copy each; the in-degrees only
    when ``degrees`` (telemetry's round events)."""
    k, n, dev = len(rounds), program.num_nodes, program.device
    if static_adj is not None:
        in_deg = {}
        if degrees:
            deg = sender_in_degree(topology, static_host)
            in_deg = {r: deg for r in rounds}
        adj = static_adj[None].expand(k, -1, -1)
        if not program.faulted:
            return adj, None, in_deg
        return adj, torch.ones((k, n), device=dev), in_deg
    adj = np.stack([round_exchange_input(topology, fault_schedule, r, mobility)
                    for r in rounds])
    in_deg = ({r: sender_in_degree(topology, a) for r, a in zip(rounds, adj)}
              if degrees else {})
    alive = None
    if program.faulted:
        alive = torch.as_tensor(
            np.stack([effective_alive(fault_schedule, n, r) for r in rounds])).to(dev)
    return torch.as_tensor(adj).to(dev), alive, in_deg


def check_snapshot_shards(meta: Dict[str, Any], ours: int) -> None:
    """Refuse a snapshot written at another ``tpu.param_shards`` (in the JAX
    package's words): the flat pad is a function of the shard count."""
    snap_shards = int(meta.get("param_shards", 1))
    if snap_shards != int(ours):
        raise ValueError(
            f"snapshot was written by a param-sharded run with "
            f"tpu.param_shards={snap_shards} but this run has "
            f"param_shards={int(ours)} — the flat pad (and the mesh "
            "layout the cache rows restore into) is a function of "
            "the shard count; rebuild with the matching "
            "tpu.param_shards"
        )


def check_snapshot_node_axis(meta: Dict[str, Any], ours: int) -> None:
    """Refuse a snapshot written over another node-axis width: each rank
    restores its own block of the rows, and a run at another width would
    restore into blocks the snapshot was not written for."""
    snap = int(meta.get("node_axis", 1))
    if snap != int(ours):
        raise ValueError(
            f"snapshot was written by a run over a node axis of {snap} ranks but this "
            f"run has a node axis of {int(ours)} — rebuild with the matching "
            "tpu.num_devices")


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
        transfer_guard: bool = False,
        recompile_guard: bool = False,
        mobility=None,
    ):
        """``mobility``: a MobilityModel (topology/dynamic.py) whose G^t is
        each round's graph, before the fault fold; the topology then only
        fixes N.  ``telemetry``: a TelemetryWriter, or None (no events, and
        the history and round program are unchanged either way).
        ``profile_dir`` (tpu.profile_dir): trace every ``train`` call with
        torch.profiler into this directory.  ``transfer_guard`` and
        ``recompile_guard``: the tpu: section's runtime guards (module
        docstring)."""
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
        check_exchange_layout(program, topology)
        if mobility is not None and program.sparse:
            raise ValueError(
                "sparse exchange mode does not compose with mobility (G^t is a dense "
                "per-round graph)"
            )
        self.program = program
        self.group = program.group
        refuse_transfer_guard_across_processes(self.group, transfer_guard)
        if self.group is not None and self.group.staged and transfer_guard:
            raise ValueError(
                "tpu.transfer_guard does not compose with a gloo param or node group on "
                "CUDA tensors: its collectives are staged through host memory every round")
        self.topology = topology
        self.mobility = mobility
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
        # With no fault schedule, no mobility (and a static sparse schedule)
        # the graph never changes: staged once.
        static = static_exchange_input(topology, fault_schedule, mobility)
        self._static_host = static
        self._static_adj = None if static is None else torch.as_tensor(static).to(self.device)
        self.telemetry = telemetry
        self.profile_dir = profile_dir
        self._profiler = None  # the open window: (torch.profiler, its first round)
        # Host-side in-degree of each staged round's adjacency (before the
        # round's own folds), popped when the round is recorded.
        self._in_degree: Dict[int, np.ndarray] = {}
        self.transfer_guard = transfer_guard
        self.recompile_guard = recompile_guard
        # (chunk, eval_every) keys whose first chunk has run.
        self._warmed: set = set()
        # One record a snapshot saved or restored: action, round, bytes, seconds.
        self.checkpoints: List[Dict[str, Any]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, rounds: List[int]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The adjacency stack of ``rounds`` ([k, N, N], or [k, K, N] edge
        masks on a sparse program) and, for a faulted program, their [k, N]
        alive stack: each staged in one copy where the graph changes, else
        views of the static graph and of all-alive."""
        adj, alive, in_deg = stage_rounds(self.topology, self.fault_schedule, self.program,
                                          self._static_host, self._static_adj, rounds,
                                          degrees=self.telemetry is not None,
                                          mobility=self.mobility)
        self._in_degree.update(in_deg)
        return adj, alive

    def train(
        self,
        rounds: int,
        verbose: bool = False,
        eval_every: int = 1,
        rounds_per_dispatch: int = 1,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
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
            checkpoint_dir: snapshot the run here (:meth:`save_checkpoint`)
                after each chunk that crosses a multiple of
                ``checkpoint_every`` rounds, and after the last chunk.
        """
        first = self.current_round
        whole = self._start_profiler() if self.profile_dir else None
        try:
            self._train_chunks(rounds, verbose, eval_every, rounds_per_dispatch,
                               checkpoint_dir, checkpoint_every)
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

    def _train_chunks(self, rounds, verbose, eval_every, rounds_per_dispatch, checkpoint_dir,
                      checkpoint_every) -> None:
        done = 0
        while done < rounds:
            k = min(rounds_per_dispatch, rounds - done)
            key = (k, eval_every)
            if key not in self._fused:
                if self.recompile_guard and key in self._warmed:
                    raise RecompileError(
                        f"tpu.recompile_guard: the fused program for {key} (chunk, "
                        "eval_every) was built again after it had run"
                    )
                self._fused[key] = build_multi_round(self.program, k, eval_every)
            warmup = key not in self._warmed
            builds = len(_build.STARTED)
            round0 = self.current_round
            self._profile_window_start(round0, span=k)
            t0 = time.perf_counter()
            adj_stack, alive_stack = self._stage(list(range(round0, round0 + k)))
            guard = (transfer_sanitizer() if self.transfer_guard and not warmup
                     and self.device.type == "cuda" else contextlib.nullcontext())
            with guard:
                self.flat, self.agg_state, rows = self._fused[key](
                    self.flat, self.agg_state, self.seed, adj_stack, self._comp, round0,
                    alive_stack=alive_stack,
                )
            rows = _host_rows(rows)
            self._sync()
            elapsed = time.perf_counter() - t0
            self._warmed.add(key)
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
                        deferred=False, **self._phase_overlap(),
                    )
                else:
                    for i in range(k):
                        self.telemetry.phase_times(round0 + i, "fused", elapsed / k, chunk=k,
                                                   **self._phase_overlap())
                self.telemetry.memory_event(self.current_round - 1, self.device)
                self._profile_window_stop(self.current_round)
            for round_num, metrics in rows:
                self._record(round_num, metrics, verbose)
            # After the bookkeeping, so that a raise leaves the round counter
            # and the history aligned with the parameters.
            if self.recompile_guard and not warmup and len(_build.STARTED) > builds:
                raise RecompileError(
                    f"tpu.recompile_guard: kernel build(s) {_build.STARTED[builds:]} "
                    f"started in rounds {round0}-{round0 + k - 1}, after the first chunk "
                    f"of {key} (chunk, eval_every)"
                )
            crossed = checkpoint_every and (
                self.current_round // checkpoint_every > round0 // checkpoint_every)
            if checkpoint_dir and (crossed or done >= rounds):
                self.save_checkpoint(checkpoint_dir)

    def _phase_overlap(self) -> Dict[str, str]:
        """The ``overlap`` marker of a pipelined program's phase_times: its
        wall time is the round's critical path, and its train and delayed
        aggregate phases are not to be summed (telemetry/report.py renders
        the critical path).  A serialized program's records carry none."""
        return {"overlap": "pipelined"} if self.program.pipelined else {}

    # ------------------------------------------------------------------
    # durability (durability/snapshot.py)

    def save_checkpoint(self, directory: str) -> None:
        """Snapshot the whole run state into ``directory`` (fsync'd; a crash
        leaves the previous snapshot or this one)."""
        from murmura_tpu_torch.durability.snapshot import save_run_snapshot

        t0 = time.perf_counter()
        nbytes = save_run_snapshot(directory, self)
        if self.group is not None:
            # Rank 0 writes: no rank goes on before the snapshot is committed.
            barrier(self.group)
        self._log_checkpoint("save", self.current_round, nbytes, time.perf_counter() - t0,
                             directory)

    def restore_checkpoint(self, directory: str) -> int:
        """Restore the run state from ``directory``; returns the round to
        continue from.  Emits ``run_resumed`` into the telemetry stream
        (which the writer appends to when opened with ``resume=True``)."""
        from murmura_tpu_torch.durability.snapshot import restore_run_snapshot

        t0 = time.perf_counter()
        round_num = restore_run_snapshot(directory, self)
        # Staged rounds' in-degrees belong to the run that was stopped.
        self._in_degree.clear()
        self._log_checkpoint("restore", round_num, committed_bytes(directory),
                             time.perf_counter() - t0, directory)
        if self.telemetry is not None:
            self.telemetry.emit("run_resumed", round=round_num, path=str(directory),
                                run_id=self.telemetry.run_id)
        return round_num

    def _log_checkpoint(self, action, round_num, nbytes, seconds, directory) -> None:
        self.checkpoints.append({"action": action, "round": round_num, "bytes": nbytes,
                                 "seconds": seconds})
        if self.telemetry is not None:
            self.telemetry.checkpoint_event(round_num, seconds, action=action,
                                            path=str(directory), bytes=nbytes)

    # What a snapshot of this orchestrator carries beyond the base sections.

    def _durability_history(self):
        return self.history

    def _durability_params(self):
        """(flat, agg_state) in the snapshot's layout, the whole [N, P]:
        a param group's row and column blocks, a node group's rows and row
        blocks of state, gathered to rank 0 (a collective; (None, None) on
        the other ranks)."""
        if self.group is None:
            return self.flat, self.agg_state
        sharded = self.program.sharded_state_keys
        by_rows = self.program.row_state_keys
        flat = gather_rows(self.flat, self.group, dst=0)
        state = {k: gather_columns(v, self.group, dst=0) if k in sharded
                 else gather_rows(v, self.group, dst=0) if k in by_rows else v
                 for k, v in self.agg_state.items()}
        if self.group.rank != 0:
            return None, None
        return flat, state

    def _durability_layout(self):
        """The snapshot layout's (shape, dtype) of the flat and of each
        agg_state key, without gathering anything."""
        from murmura_tpu_torch.durability.snapshot import describe_state

        flat_desc, state_desc = describe_state(self.flat, self.agg_state)
        if self.group is None:
            return flat_desc, state_desc
        whole = (self.program.num_nodes, self.program.flat_dim)
        for k in self.program.sharded_state_keys:
            state_desc[k] = (whole, state_desc[k][1])
        for k in self.program.row_state_keys:
            shape, dtype = state_desc[k]
            state_desc[k] = ((self.program.num_nodes,) + tuple(shape[1:]), dtype)
        return (whole, flat_desc[1]), state_desc

    def _durability_set_params(self, flat, agg_state) -> None:
        """Assign a restored snapshot, cut to a param group's blocks."""
        if self.group is not None:
            lo, hi = self.group.rows
            flat = flat[lo:hi].contiguous()
            agg_state = {k: v[lo:hi].contiguous() if k in self.program.row_state_keys else v
                         for k, v in agg_state.items()}
            sharded = self.program.sharded_state_keys
            if sharded:
                c0, c1 = self.group.cols
                agg_state = {k: v[:, c0:c1].contiguous() if k in sharded else v
                             for k, v in agg_state.items()}
        self.flat, self.agg_state = flat, agg_state

    def _durability_writes(self) -> bool:
        """Whether this process writes the snapshot (rank 0 of a group)."""
        return self.group is None or self.group.rank == 0

    def _durability_set_history(self, history) -> None:
        self.history = history

    def _durability_extra_state(self):
        """(arrays, meta) extra sections: the telemetry run id, stable
        across resumes, and a padded program's shard count (the flat pad is
        a function of it)."""
        meta = {}
        if self.telemetry is not None:
            meta["telemetry_run_id"] = self.telemetry.run_id
        if self.program.param_shards > 1:
            meta["param_shards"] = int(self.program.param_shards)
        if self._node_axis() > 1:
            meta["node_axis"] = self._node_axis()
        return {}, meta

    def _node_axis(self) -> int:
        """The node axis this network runs over (1 outside a node group)."""
        return self.group.world if isinstance(self.group, NodeGroup) else 1

    def _durability_validate_extra(self, arrays, meta) -> None:
        """Refuse, before anything is assigned, a snapshot with extra
        sections this orchestrator does not understand (a gang's or a
        population's)."""
        foreign = sorted(set(arrays) | ({"gang", "population"} & set(meta)))
        if foreign:
            raise ValueError(
                f"snapshot carries extra sections {foreign} this orchestrator does not "
                "understand — it was written by a population/gang run; rebuild with the "
                "matching config"
            )
        check_snapshot_shards(meta, self.program.param_shards)
        check_snapshot_node_axis(meta, self._node_axis())

    def _durability_restore_extra(self, arrays, meta) -> None:
        """Nothing beyond the base sections to apply."""

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
