"""Per-node worker process of the ZMQ backend (the PyTorch counterpart of
murmura_tpu/distributed/node_process.py; reference:
murmura/distributed/node_process.py:8-364).

Socket layout: one PULL bind (receives from neighbours), lazy PUSH per
neighbour, one PUSH to the monitor.  Round protocol: sleep until
t_start + k*round_duration -> local train (honest only) -> overrun check ->
attack own outgoing state -> PUSH to current neighbours -> PULL until all
expected arrived or deadline (aggregate with whatever arrived) -> aggregate
-> evaluate -> PUSH metrics.  Round sync is the system clock; there are no
control messages.

The node runs its model and its rule on the device the caller names: the
CUDA card ``cuda:(node_id % device_count)`` by default, the CPU on request;
without a usable card a ``cuda`` node fails, it never falls back to the
CPU.  ``zmq`` is imported inside the functions that use it, so the package
imports on a host without pyzmq.

The attack noise of a compromised gaussian node is drawn from a CPU
generator that is a pure function of ``(experiment.seed + 7919, round,
node)``; ``_execute_round(round, draws=...)`` injects it (``noise``) and
the node's training draws (``train``, distributed/local.py) instead.
"""

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.distributed.endpoints import Endpoints
from murmura_tpu_torch.distributed.messaging import (
    MsgType,
    decode,
    encode,
    pack_obj,
    pack_state,
    unpack_state,
)


def resolve_node_device(device: str, node_id: int) -> torch.device:
    """``cuda`` -> ``cuda:(node_id % device_count)``; ``cpu`` -> the CPU.
    Without a usable card ``cuda`` raises (distributed/local.py)."""
    from murmura_tpu_torch.distributed.local import node_device

    dev = node_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", node_id % torch.cuda.device_count())
    return dev


def attack_generator(seed: int, round_idx: int, node_id: int) -> torch.Generator:
    """The CPU generator of a compromised node's attack noise: a pure
    function of (experiment.seed + 7919, round, node)."""
    g = torch.Generator()
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed) + 7919, int(round_idx), int(node_id)]).generate_state(1)[0]))
    return g


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """The kernel wrappers' launch and plain-version counters of this process."""
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    mods = (agg_kernels, candidate_kernels, sketch_kernels)
    return {"launches": {k: v for m in mods for k, v in m.LAUNCHES.items()},
            "plain": {k: v for m in mods for k, v in m.PLAIN_CALLS.items()}}


class NodeProcess:
    """One FL node in its own OS process."""

    def __init__(
        self,
        config: Config,
        node_id: int,
        run_id: str,
        t_start: float,
        compromised_ids: List[int],
        host: Optional[str] = None,
        resume: bool = False,
        device: str = "cuda",
        spawned_at: Optional[float] = None,
    ):
        self.config = config
        self.node_id = node_id
        self.run_id = run_id
        self.t_start = t_start
        self.compromised_ids = set(compromised_ids)
        self.host = host
        self.is_compromised = node_id in self.compromised_ids
        # Crash recovery (faults.enabled): a respawned process restores its
        # last per-node checkpoint and rejoins at the wall-clock-current
        # round instead of replaying from round 0.
        self.resume = resume
        self.start_round = 0
        self.device_name = device
        self.device: Optional[torch.device] = None
        # monotonic time of the parent's spawn call, for the boot time.
        self.spawned_at = spawned_at

        self.endpoints = Endpoints(config.distributed, run_id)
        self.rounds = config.experiment.rounds
        self.round_duration = config.distributed.round_duration_s

        self.node = None
        self.attack = None
        self.mobility = None
        self.fault_schedule = None
        self.static_neighbors: List[int] = []
        self._ctx = None
        self._pull = None
        self._push: Dict[int, object] = {}
        self._monitor_push = None
        # Telemetry counters (operational events): they ride every METRICS
        # frame under the known 'counters' key; the Monitor folds them into
        # the run manifest.
        self._counters: Dict[str, float] = {
            "send_retries": 0.0,
            "send_failures": 0.0,
            "reconnects": 0.0,
            "rounds_skipped": 0.0,
            "nonfinite_drops": 0.0,
            "checkpoint_saves": 0.0,
            "checkpoint_s": 0.0,
        }
        # Per executed round: the local_train and aggregate seconds.
        self.round_times: Dict[int, Dict[str, float]] = {}

    # ------------------------------------------------------------------

    def run(self) -> None:
        """Entry point inside the child process (reference: node_process.py:111-124)."""
        self.device = resolve_node_device(self.device_name, self.node_id)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        else:
            # N node processes share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // max(1, self.config.topology.num_nodes)))
        self._build_node()
        if self.resume:
            self._restore_node_checkpoint()
            # Rejoin at the wall-clock-current round: round k occupies
            # [t_start + k*dur, t_start + (k+1)*dur).  Scheduled-dead
            # rounds between boot and recovery are self-skipped below.
            self.start_round = max(
                0,
                int((time.monotonic() - self.t_start) // self.round_duration),
            )
        self._setup_sockets()
        ready = time.monotonic()
        boot = "" if self.spawned_at is None else f"ready {ready - self.spawned_at:.2f} s after spawn, "
        print(f"[node {self.node_id}] pid {os.getpid()} {boot}{self.t_start - ready:.2f} s "
              f"before round 0, on {self.device}", flush=True)
        try:
            self._run_all_rounds()
        finally:
            self._teardown()
            self._print_summary()

    def _print_summary(self) -> None:
        """One line: each executed round's train and aggregate seconds, the
        allocator's peak on the card, and this process's kernel counters."""
        rounds = ", ".join(
            f"{r}: train {t.get('train_s', 0.0):.4f} s aggregate {t.get('aggregate_s', 0.0):.4f} s"
            for r, t in sorted(self.round_times.items()))
        counts = kernel_counts()
        memory = ""
        if self.device is not None and self.device.type == "cuda":
            memory = (f"card memory peak "
                      f"{torch.cuda.max_memory_allocated(self.device) / 2**20:.1f} MiB; ")
        print(f"[node {self.node_id}] rounds {{{rounds}}}; {memory}kernel launches "
              f"{counts['launches']}; plain calls {counts['plain']}", flush=True)

    # ------------------------------------------------------------------

    def _build_node(self) -> None:
        """Factories + full dataset load in every process, then subset
        (reference behaviour: node_process.py:333-364)."""
        from murmura_tpu_torch.aggregation import build_aggregator
        from murmura_tpu_torch.data.registry import build_federated_data
        from murmura_tpu_torch.distributed.local import LocalNode
        from murmura_tpu_torch.ops.flatten import model_dimension
        from murmura_tpu_torch.topology.generators import create_topology
        from murmura_tpu_torch.utils.factories import (
            ConfigError,
            build_attack,
            build_fault_schedule,
            build_mobility,
            resolve_model,
        )

        cfg = self.config
        device = self.device if self.device is not None else torch.device(self.device_name)
        # Same deterministic schedule every process reconstructs from the
        # seed: dead peers are excluded from expected-neighbour sets
        # without any control messages (faults/schedule.py).
        self.fault_schedule = build_fault_schedule(cfg)
        data = build_federated_data(
            cfg.data.adapter,
            cfg.data.params,
            num_nodes=cfg.topology.num_nodes,
            seed=cfg.experiment.seed,
            max_samples=cfg.training.max_samples,
        )
        model = resolve_model(cfg, data)
        x, y = data.get_client_data(self.node_id)
        eval_x = eval_y = None
        if data.x_test is not None:
            eval_x, eval_y = data.get_client_eval_data(self.node_id)

        self.mobility = build_mobility(cfg)
        if self.mobility is None:
            topo = create_topology(
                cfg.topology.type,
                num_nodes=cfg.topology.num_nodes,
                p=cfg.topology.p,
                k=cfg.topology.k,
                seed=cfg.topology.seed,
            )
            self.static_neighbors = topo.neighbors[self.node_id]
            max_deg = max(len(ns) for ns in topo.neighbors)
        else:
            max_deg = cfg.topology.num_nodes - 1

        self.attack = build_attack(cfg)

        model_dim = model_dimension(model.init(torch.Generator().manual_seed(0),
                                               torch.device("cpu")))
        agg_params = dict(cfg.aggregation.params)
        if cfg.aggregation.algorithm == "evidential_trust":
            probe_size = int(agg_params.get("max_eval_samples", 100))
        else:
            probe_size = cfg.training.batch_size
        try:
            agg = build_aggregator(cfg.aggregation.algorithm, agg_params, model_dim=model_dim)
        except ValueError as e:
            raise ConfigError(str(e)) from None

        self.node = LocalNode(
            node_id=self.node_id,
            model=model,
            agg=agg,
            x=x,
            y=y,
            eval_x=eval_x,
            eval_y=eval_y,
            max_neighbors=max_deg,
            local_epochs=cfg.training.local_epochs,
            batch_size=cfg.training.batch_size,
            lr=cfg.training.lr,
            total_rounds=cfg.experiment.rounds,
            probe_size=probe_size,
            annealing_rounds=max(1, cfg.experiment.rounds // 2),
            seed=cfg.experiment.seed + self.node_id,
            device=device,
        )

    def _setup_sockets(self) -> None:
        """PULL bind + PUSH to monitor; neighbour PUSH sockets are lazy
        (reference: node_process.py:130-155)."""
        import zmq

        self._ctx = zmq.Context()
        self._pull = self._ctx.socket(zmq.PULL)
        self._pull.bind(self.endpoints.node_bind(self.node_id, self.host))
        self._monitor_push = self._ctx.socket(zmq.PUSH)
        self._monitor_push.setsockopt(zmq.LINGER, 2000)
        self._monitor_push.connect(self.endpoints.monitor_connect())

    def _push_to(self, neighbor_id: int):
        import zmq

        if neighbor_id not in self._push:
            sock = self._ctx.socket(zmq.PUSH)
            sock.setsockopt(zmq.LINGER, 2000)
            sock.connect(self.endpoints.node_connect(neighbor_id))
            self._push[neighbor_id] = sock
        return self._push[neighbor_id]

    def _teardown(self) -> None:
        for sock in self._push.values():
            sock.close()
        if self._pull is not None:
            self._pull.close()
        if self._monitor_push is not None:
            self._monitor_push.close()
        if self._ctx is not None:
            self._ctx.term()

    # ------------------------------------------------------------------

    def current_neighbors(self, round_idx: int) -> List[int]:
        """Static topology or mobility G^t (reference: node_process.py:292-323)."""
        if self.mobility is not None:
            return self.mobility.neighbors_at(round_idx)[self.node_id]
        return list(self.static_neighbors)

    def _scheduled_dead(self, round_idx: int) -> bool:
        return (
            self.fault_schedule is not None
            and self.fault_schedule.alive_at(round_idx)[self.node_id] <= 0
        )

    def _run_all_rounds(self) -> None:
        for k in range(self.start_round, self.rounds):
            target = self.t_start + k * self.round_duration
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if self._scheduled_dead(k):
                # Self-enforced crash window: a dead process neither trains
                # nor reports (reporting_nodes drops).  It keeps multi-machine
                # runs (no FaultInjector parent) honouring the schedule, and
                # gives a respawned process a boot round before its
                # scheduled recovery.
                continue
            self._execute_round(k)
            if self.fault_schedule is not None:
                self._save_node_checkpoint(k)

    @property
    def _is_colluder(self) -> bool:
        """Colluding attacks (ALIE, IPM) estimate population statistics
        from the coalition's own benign states on this backend."""
        return (
            self.attack is not None
            and self.attack.name in ("alie", "ipm")
            and self.is_compromised
        )

    def _execute_round(self, round_idx: int, draws: Optional[Dict] = None) -> None:
        """One wall-clock round (reference: node_process.py:193-247).
        ``draws`` injects the round's random draws: ``train`` the local
        training's (LocalNode.round_draws), ``noise`` the [P] attack noise
        of a compromised gaussian node."""
        draws = draws or {}
        deadline = self.t_start + (round_idx + 1) * self.round_duration
        # 0. already past this round's deadline (a previous round's training
        # overran the whole window, or a recovery boot landed late):
        # publish the SKIPPED frame so the monitor stays index-aligned.
        if time.monotonic() >= deadline:
            print(
                f"[node {self.node_id}] round {round_idx}: round window "
                "already elapsed; skipping",
                flush=True,
            )
            self._send_metrics(round_idx, skipped=True)
            return
        neighbors = self.current_neighbors(round_idx)
        if self.fault_schedule is not None:
            # Re-resolve the expected-neighbour set from the schedule: no
            # waiting out the deadline on a known-dead peer or a dropped
            # link.  Symmetric link masks keep sender and receiver
            # expectations consistent without communication.
            alive = self.fault_schedule.alive_at(round_idx)
            link = self.fault_schedule.link_mask_at(round_idx)
            neighbors = [
                j for j in neighbors
                if alive[j] > 0 and link[self.node_id, j] > 0
            ]

        # 1. local training (honest only, node_process.py:205-207).  ALIE/IPM
        # colluders also train: their benign states are the coalition
        # sample the papers' estimators run on; it never leaves the
        # coalition.
        faults = self.config.faults if self.config.faults.enabled else None
        pre_flat = None
        if faults is not None and faults.nan_quarantine:
            # Pre-round snapshot: a divergent (non-finite) local step rolls
            # back to this instead of poisoning the exchange.
            pre_flat = self.node.get_flat_state()
        t_train0 = time.monotonic()
        times = self.round_times.setdefault(round_idx, {})
        if not self.is_compromised or self._is_colluder:
            self.node.local_train(round_idx, draws=draws.get("train"))
            times["train_s"] = self.node.timings["train_s"]

        # 1b. straggler realisation: the schedule's boolean becomes an
        # actual delay, (factor-1) x the measured training time, capped
        # just past the round window: whether the update misses the
        # deadline depends on real timing.
        if (
            self.fault_schedule is not None
            and self.fault_schedule.straggler_at(round_idx)[self.node_id]
        ):
            train_time = time.monotonic() - t_train0
            delay = min(
                (self.fault_schedule.straggler_factor - 1.0) * train_time,
                max(0.0, deadline - time.monotonic()) + 0.5,
            )
            if delay > 0:
                print(
                    f"[node {self.node_id}] round {round_idx}: straggling "
                    f"{delay:.2f}s (factor "
                    f"{self.fault_schedule.straggler_factor})",
                    flush=True,
                )
                time.sleep(delay)

        # 2. overrun check: skip the exchange if training blew the window
        # (node_process.py:210-218).
        if time.monotonic() >= deadline:
            print(
                f"[node {self.node_id}] round {round_idx}: training overran "
                "the round window; skipping exchange",
                flush=True,
            )
            self._send_metrics(round_idx, skipped=True)
            return

        # 2b. numerical sentinel (faults.nan_quarantine): a non-finite
        # post-training state quarantines this node for the round: params
        # roll back to the pre-round snapshot and the exchange is skipped
        # (neighbours also drop non-finite arrivals in _collect_states).
        flat = self.node.get_flat_state()
        if (
            faults is not None
            and self.node_id in faults.nan_inject_nodes
            and round_idx >= faults.nan_inject_from_round
        ):
            # Deterministic divergence injection for chaos testing, the
            # jitted backends' nan_inject_nodes.
            flat = np.full_like(flat, np.nan)
        if pre_flat is not None and not np.isfinite(flat).all():
            print(
                f"[node {self.node_id}] round {round_idx}: non-finite local "
                "update quarantined; rolling back to the pre-round state",
                flush=True,
            )
            self.node.set_flat_state(pre_flat)
            self._send_metrics(round_idx, skipped=False)
            return

        # 3. attack own outgoing state (node_process.py:221-225).  ALIE/IPM
        # colluders first exchange benign states within the coalition;
        # neighbour MODEL_STATEs arriving meanwhile are buffered for step 5.
        prebuffered: Dict[int, np.ndarray] = {}
        if self._is_colluder:
            out_flat, prebuffered = self._colluding_state(flat, round_idx, deadline)
        else:
            out_flat = self._attacked_state(flat, round_idx, draws.get("noise"))

        # 4. PUSH to current neighbours (node_process.py:227-232)
        payload = pack_state(out_flat)
        for nid in neighbors:
            self._send_to(
                nid, encode(MsgType.MODEL_STATE, self.node_id, payload, round_idx)
            )

        # 5. collect neighbour states until expected or deadline
        # (node_process.py:249-276)
        received = self._collect_states(
            set(neighbors), round_idx, deadline, prebuffered=prebuffered
        )

        # 6. aggregate with whatever arrived (partial OK)
        if received:
            self.node.aggregate_with_neighbors(received, round_idx)
            times["aggregate_s"] = self.node.timings["aggregate_s"]

        # 7. evaluate + metrics to monitor
        self._send_metrics(round_idx, skipped=False)

    def _reject_nonfinite(self, sender: int, state: np.ndarray) -> bool:
        """Receiver-side sentinel (faults.nan_quarantine): drop a neighbour
        state carrying non-finite values before it reaches any rule math
        (0 * nan == nan in every Gram path and kernel)."""
        if (
            self.config.faults.enabled
            and self.config.faults.nan_quarantine
            and not np.isfinite(state).all()
        ):
            print(
                f"[node {self.node_id}] dropped non-finite state from "
                f"{sender}",
                flush=True,
            )
            self._counters["nonfinite_drops"] += 1
            return True
        return False

    def _send_to(self, neighbor_id: int, frames, attempts: int = 3) -> bool:
        """Send with exponential-backoff reconnect.  A PUSH socket wedged by
        a peer restart raises; dropping the cached socket and reconnecting
        is the recovery.  Failure after the retry budget degrades to the
        round's partial-aggregation semantics."""
        delay = 0.05
        for attempt in range(attempts):
            try:
                self._push_to(neighbor_id).send_multipart(frames, copy=False)
                return True
            except Exception as e:
                print(
                    f"[node {self.node_id}] push to {neighbor_id} failed "
                    f"(attempt {attempt + 1}/{attempts}): {e}",
                    flush=True,
                )
                self._counters["send_retries"] += 1
                self._counters["reconnects"] += 1
                sock = self._push.pop(neighbor_id, None)
                if sock is not None:
                    try:
                        sock.close(linger=0)
                    except Exception:  # pragma: no cover - teardown races
                        pass
                if attempt + 1 < attempts:
                    time.sleep(delay)
                    delay *= 2
        self._counters["send_failures"] += 1
        return False

    def _attacked_state(self, flat: np.ndarray, round_idx: int,
                        noise: Optional[np.ndarray] = None) -> np.ndarray:
        """The compromised node's outgoing row: the attack's [1, P] view on
        the host, its noise from :func:`attack_generator` unless injected."""
        if self.attack is None or not self.is_compromised:
            return flat
        out = self.attack.apply(
            torch.from_numpy(np.asarray(flat, np.float32))[None, :], torch.ones(1),
            attack_generator(self.config.experiment.seed, round_idx, self.node_id),
            noise=None if noise is None else torch.as_tensor(
                np.array(noise, np.float32)).reshape(1, -1),
        )
        return out[0].numpy().astype(np.float32)

    def _colluding_state(
        self, flat: np.ndarray, round_idx: int, deadline: float
    ) -> tuple:
        """Coalition-estimated colluding vector: ALIE's mu - z*sigma
        (Baruch et al.) or IPM's -epsilon*mu (Xie et al.), both estimated
        from the corrupted workers' own benign states.

        Protocol: push own benign state to every other colluder
        (COLLUDE_STATE), collect theirs until half the remaining round
        window is spent, then broadcast the colluding vector over whatever
        coalition sample arrived (always >= the own state).  Neighbour
        MODEL_STATEs arriving early are buffered and returned for step 5.
        """
        import zmq

        peers = sorted(self.compromised_ids - {self.node_id})
        if self.fault_schedule is not None:
            # Dead colluders can neither contribute nor receive.
            alive = self.fault_schedule.alive_at(round_idx)
            peers = [p for p in peers if alive[p] > 0]
        payload = pack_state(flat)
        for nid in peers:
            self._send_to(
                nid,
                encode(MsgType.COLLUDE_STATE, self.node_id, payload, round_idx),
            )

        coalition: Dict[int, np.ndarray] = {self.node_id: np.asarray(flat)}
        prebuffered: Dict[int, np.ndarray] = {}
        # Leave at least half the remaining window for the real exchange.
        sub_deadline = min(
            deadline, time.monotonic() + 0.5 * max(0.0, deadline - time.monotonic())
        )
        poller = zmq.Poller()
        poller.register(self._pull, zmq.POLLIN)
        while set(peers) - set(coalition) and time.monotonic() < sub_deadline:
            timeout_ms = max(1, int((sub_deadline - time.monotonic()) * 1000))
            events = dict(poller.poll(min(timeout_ms, 200)))
            if self._pull not in events:
                continue
            msg_type, sender, msg_round, data = decode(self._pull.recv_multipart())
            if msg_round != round_idx:
                continue  # straggler from an earlier round window
            if msg_type == MsgType.COLLUDE_STATE and sender in peers:
                state = unpack_state(data)
                if not self._reject_nonfinite(sender, state):
                    coalition[sender] = state
            elif msg_type == MsgType.MODEL_STATE:
                state = unpack_state(data)
                if not self._reject_nonfinite(sender, state):
                    prebuffered[sender] = state
        missing = set(peers) - set(coalition)
        if missing:
            print(
                f"[node {self.node_id}] {self.attack.name}: coalition "
                f"sample {len(coalition)}/{len(peers) + 1} "
                f"(missing {sorted(missing)})",
                flush=True,
            )
        sample = np.stack(list(coalition.values()))
        p = self.config.attack.params
        if self.attack.name == "ipm":
            from murmura_tpu_torch.attacks.ipm import ipm_vector, resolve_ipm_epsilon

            out = ipm_vector(sample, resolve_ipm_epsilon(p.get("epsilon")))
        else:
            from murmura_tpu_torch.attacks.alie import colluding_vector, resolve_alie_z

            out = colluding_vector(
                sample,
                resolve_alie_z(
                    self.config.topology.num_nodes,
                    len(self.compromised_ids),
                    p.get("z"),
                ),
            )
        return out, prebuffered

    def _collect_states(
        self,
        expected: set,
        round_idx: int,
        deadline: float,
        prebuffered: Optional[Dict[int, np.ndarray]] = None,
    ) -> Dict[int, np.ndarray]:
        import zmq

        received: Dict[int, np.ndarray] = {
            s: v for s, v in (prebuffered or {}).items() if s in expected
        }
        poller = zmq.Poller()
        poller.register(self._pull, zmq.POLLIN)
        while expected - set(received) and time.monotonic() < deadline:
            timeout_ms = max(1, int((deadline - time.monotonic()) * 1000))
            events = dict(poller.poll(min(timeout_ms, 200)))
            if self._pull in events:
                msg_type, sender, msg_round, payload = decode(
                    self._pull.recv_multipart()
                )
                # round tag drops stragglers from earlier round windows
                if (
                    msg_type == MsgType.MODEL_STATE
                    and sender in expected
                    and msg_round == round_idx
                ):
                    state = unpack_state(payload)
                    if self._reject_nonfinite(sender, state):
                        expected = expected - {sender}
                        continue
                    received[sender] = state
        missing = expected - set(received)
        if missing:
            print(
                f"[node {self.node_id}] deadline: aggregating with "
                f"{len(received)}/{len(expected)} neighbors (missing {sorted(missing)})",
                flush=True,
            )
        return received

    # ------------------------------------------------------------------
    # crash-recovery checkpoints (faults.enabled runs)

    def _save_node_checkpoint(self, round_idx: int) -> None:
        """Atomically snapshot this node's state after a completed round:
        flat params and the per-node ('node'-kind) aggregator state.  The
        training draws are a function of (seed, round), so there is no
        generator state to keep; per-edge trust is not persisted (a
        recovered peer re-earns link trust, the Byzantine-safe choice).
        Written through utils/checkpoint.durable_replace, so a crash
        mid-save leaves the previous checkpoint intact."""
        import io

        from murmura_tpu_torch.utils.checkpoint import durable_replace

        t0 = time.monotonic()
        path = self.endpoints.node_checkpoint_path(self.node_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "flat": self.node.get_flat_state(),
            "round": np.int64(round_idx),
        }
        for k, v in getattr(self.node, "_node_state", {}).items():
            payload[f"node_state.{k}"] = np.asarray(v)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        durable_replace(
            os.path.dirname(path), os.path.basename(path), buf.getvalue()
        )
        self._counters["checkpoint_saves"] += 1
        self._counters["checkpoint_s"] += time.monotonic() - t0

    def _restore_node_checkpoint(self) -> Optional[int]:
        """Restore the last checkpoint onto the node's own device; returns
        its round or None."""
        path = self.endpoints.node_checkpoint_path(self.node_id)
        if not os.path.exists(path):
            print(
                f"[node {self.node_id}] resume requested but no checkpoint "
                f"at {path}; rejoining from the initial model",
                flush=True,
            )
            return None
        with np.load(path) as data:
            self.node.set_flat_state(data["flat"])
            for k in list(getattr(self.node, "_node_state", {})):
                key = f"node_state.{k}"
                if key in data:
                    self.node._node_state[k] = np.asarray(data[key])
            restored = int(data["round"])
        print(
            f"[node {self.node_id}] restored checkpoint from round "
            f"{restored}",
            flush=True,
        )
        return restored

    def _metrics(self, round_idx: int, skipped: bool) -> dict:
        metrics = {"round": round_idx, "node": self.node_id, "skipped": skipped}
        if skipped:
            self._counters["rounds_skipped"] += 1
        else:
            metrics.update(self.node.evaluate())
            metrics["stats"] = self.node.get_aggregator_statistics()
        return metrics

    def _send_metrics(self, round_idx: int, skipped: bool) -> None:
        metrics = self._metrics(round_idx, skipped)
        metrics["compromised"] = self.is_compromised
        # Cumulative operational counters ride every frame: the monitor
        # folds the last value per node into the manifest.
        metrics["counters"] = dict(self._counters)
        try:
            self._monitor_push.send_multipart(
                encode(MsgType.METRICS, self.node_id, pack_obj(metrics), round_idx)
            )
        except Exception as e:  # pragma: no cover
            print(f"[node {self.node_id}] metrics push failed: {e}", flush=True)


def run_single_node(
    config: Config,
    node_id: int,
    t_start: float,
    run_id: str,
    host: Optional[str] = None,
    resume: bool = False,
    device: str = "cuda",
) -> None:
    """Multi-machine worker entry (reference: cli.py:143-208).  The operator
    copies run_id/t_start printed by the head node; t_start must be valid on
    this machine's monotonic clock."""
    if not 0 <= node_id < config.topology.num_nodes:
        raise ValueError(
            f"--node-id {node_id} out of range for "
            f"topology.num_nodes={config.topology.num_nodes}"
        )
    from murmura_tpu_torch.utils.factories import build_attack

    attack = build_attack(config)
    compromised = sorted(np.flatnonzero(attack.compromised).tolist()) if attack else []
    node_class(config)(
        config,
        node_id=node_id,
        run_id=run_id,
        t_start=t_start,
        compromised_ids=compromised,
        host=host,
        resume=resume,
        device=device,
    ).run()


def node_class(config: Config):
    """NodeProcess, or the DMTT trust-protocol process for a ``dmtt:``
    config (reference: runner.py:88-103)."""
    if config.dmtt is not None:
        from murmura_tpu_torch.dmtt.node_process import DMTTNodeProcess

        return DMTTNodeProcess
    return NodeProcess
