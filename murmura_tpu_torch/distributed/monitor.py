"""Passive metrics monitor of the ZMQ backend (the PyTorch counterpart of
murmura_tpu/distributed/monitor.py; reference:
murmura/distributed/monitor.py:6-175).

PULL-only collector: its death cannot affect training.  Metrics are buffered
keyed by (round, node); complete rounds flush in order; a hard deadline
(t_start + rounds*duration + 2*duration) forces a partial flush of whatever
arrived.  Produces a history dict with the same schema as Network.train
(reference: monitor.py:49-59 vs network.py:47-58).  It runs no model and
never initialises CUDA.
"""

import time
from typing import Any, Dict, List, Optional, Set

import numpy as np

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.distributed.endpoints import Endpoints
from murmura_tpu_torch.distributed.messaging import MsgType, decode, unpack_obj
from murmura_tpu_torch.telemetry.schema import MONITOR_KNOWN_KEYS


class Monitor:
    def __init__(
        self,
        config: Config,
        run_id: str,
        t_start: float,
        compromised_ids: Optional[Set[int]] = None,
    ):
        self.config = config
        self.run_id = run_id
        self.endpoints = Endpoints(config.distributed, run_id)
        self.t_start = t_start
        self.num_nodes = config.topology.num_nodes
        self.rounds = config.experiment.rounds
        self.round_duration = config.distributed.round_duration_s
        self.compromised = compromised_ids or set()

        self.history: Dict[str, List[Any]] = {
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
        self._buffer: Dict[int, Dict[int, dict]] = {}
        self._flushed_through = -1
        # Per-node CUMULATIVE operational counters (node_process.py emits
        # the running totals on every frame; last frame wins), folded into
        # the telemetry manifest at the end of the run.
        self._node_counters: Dict[int, Dict[str, float]] = {}
        # telemetry.enabled: the monitor owns the run manifest for the
        # distributed backend (the same writer/schema the in-process
        # Network uses, telemetry/writer.py).  Built lazily in run() so
        # construction stays socket- and filesystem-free for tests.
        self._telemetry = None

    def run(self) -> Dict[str, List[Any]]:
        import zmq

        from murmura_tpu_torch.utils.factories import build_telemetry_writer

        self._telemetry = build_telemetry_writer(self.config, run_id=self.run_id)

        ctx = zmq.Context()
        sock = ctx.socket(zmq.PULL)
        sock.bind(self.endpoints.monitor_bind())
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)

        hard_deadline = (
            self.t_start + self.rounds * self.round_duration + 2 * self.round_duration
        )
        try:
            while time.monotonic() < hard_deadline:
                if self._flushed_through >= self.rounds - 1:
                    break
                events = dict(poller.poll(200))
                if sock in events:
                    msg_type, sender, _round, payload = decode(sock.recv_multipart())
                    if msg_type == MsgType.METRICS:
                        self._ingest(unpack_obj(payload))
                self._flush_complete()
            self._flush_partial()
        finally:
            sock.close()
            ctx.term()
            self._finalize_telemetry()
        return self.history

    def _finalize_telemetry(self) -> None:
        """Fold node counters + history into the one run manifest."""
        if self._telemetry is None:
            return
        for counters in self._node_counters.values():
            self._telemetry.add_counters(counters)
        self._telemetry.finalize(history=self.history)
        self._telemetry.close()

    # ------------------------------------------------------------------

    def _ingest(self, metrics: dict) -> None:
        r = int(metrics.get("round", -1))
        n = int(metrics.get("node", -1))
        if r < 0 or r >= self.rounds or n < 0:
            return
        # Cumulative counters are captured at ingest (last frame wins), so
        # they survive even when the round itself never flushes — a node's
        # final totals must not depend on its last round completing.
        counters = metrics.get("counters")
        if isinstance(counters, dict):
            self._node_counters[n] = {
                k: float(v)
                for k, v in counters.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        self._buffer.setdefault(r, {})[n] = metrics

    def _flush_complete(self) -> None:
        """Flush rounds in order while fully reported (monitor.py:81-108)."""
        while True:
            nxt = self._flushed_through + 1
            if nxt >= self.rounds or len(self._buffer.get(nxt, {})) < self.num_nodes:
                return
            self._record_round(nxt, self._buffer.pop(nxt))
            self._flushed_through = nxt

    def _flush_partial(self) -> None:
        """Hard deadline passed: flush incomplete rounds in order
        (monitor.py:110-128).

        Rounds with zero buffered messages between flushed ones get a NaN
        row (reporting_nodes=0) instead of being skipped over, so
        ``history['round']`` stays gap-free and index-aligned (advancing
        past a wholly-unreported round would leave a silent hole, unlike
        the all-skipped case, which records NaNs).
        """
        reported = [r for r in self._buffer if self._buffer[r]]
        if not reported:
            self._buffer.clear()
            return
        # Clamp to the configured horizon: one corrupt METRICS frame with
        # a huge round tag must not drive an unbounded NaN-row loop.
        last = min(max(reported), self.rounds - 1)
        for r in range(self._flushed_through + 1, last + 1):
            self._record_round(r, self._buffer.get(r, {}))
            self._flushed_through = r
        self._buffer.clear()

    def _record_round(self, round_idx: int, per_node: Dict[int, dict]) -> None:
        rows = [m for m in per_node.values() if not m.get("skipped")]
        # Per-round overrun visibility (reference keeps skipped metrics
        # flagged rather than dropped — node_process.py:278-281).
        self.history.setdefault("skipped_nodes", []).append(
            len(per_node) - len(rows)
        )
        # Degradation visibility: how many nodes reported this round at all.
        # A crashed/stalled node shows up as reporting_nodes < num_nodes on
        # every partial-flushed round (the reference only logs the missing
        # set inside each node's stdout — node_process.py:259-269).
        self.history.setdefault("reporting_nodes", []).append(len(per_node))
        # Forward-compat: metric keys this monitor version does not know
        # (a newer node build, an experimental probe) are forwarded under
        # extra.* — into the history AND the manifest event stream —
        # instead of silently dropped (the pre-telemetry _ingest behavior;
        # tests/test_torch_distributed.py).  The union with
        # already-recording extra.* lists keeps every such list appended on
        # EVERY flushed round (None when nobody reported the key), so
        # extra columns stay index-aligned with 'round' from the first
        # round the key appears — including gap/all-skipped rounds.
        extra_keys = sorted(
            ({k for m in per_node.values() for k in m}
             - set(MONITOR_KNOWN_KEYS))
            | {
                k[len("extra."):] for k in self.history
                if k.startswith("extra.")
            }
        )
        for k in extra_keys:
            vals = {n: m[k] for n, m in per_node.items() if k in m}
            nums = [
                float(v) for v in vals.values()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            ]
            self.history.setdefault(f"extra.{k}", []).append(
                float(np.mean(nums)) if nums else None
            )
            if vals and self._telemetry is not None:
                self._telemetry.emit(
                    "extra", round=round_idx + 1, key=k,
                    values={str(n): v for n, v in vals.items()},
                )
        if self._telemetry is not None:
            self._telemetry.emit(
                "round",
                round=round_idx + 1,
                nodes={
                    str(n): {
                        k: v for k, v in m.items()
                        if k not in ("counters",)
                    }
                    for n, m in per_node.items()
                },
            )
        if not rows:
            # Every node overran its training window: keep the round visible
            # with NaN metrics instead of silently producing an empty
            # history.  Every list that has been
            # recording (uncertainty, agg_*) gets a NaN too so history
            # columns stay index-aligned with 'round'.
            self.history["round"].append(round_idx + 1)
            self.history["mean_accuracy"].append(float("nan"))
            self.history["std_accuracy"].append(float("nan"))
            self.history["mean_loss"].append(float("nan"))
            if self.compromised:
                self.history["honest_accuracy"].append(float("nan"))
                self.history["compromised_accuracy"].append(float("nan"))
            for k, lst in self.history.items():
                if (k.startswith("agg_") or k.startswith("mean_v")
                        or k in ("mean_entropy", "mean_strength")) and lst:
                    lst.append(float("nan"))
            return
        accs = np.array([m.get("accuracy", 0.0) for m in rows])
        losses = np.array([m.get("loss", 0.0) for m in rows])
        self.history["round"].append(round_idx + 1)
        self.history["mean_accuracy"].append(float(accs.mean()))
        self.history["std_accuracy"].append(float(accs.std()))
        self.history["mean_loss"].append(float(losses.mean()))

        if self.compromised:
            honest = [
                m.get("accuracy", 0.0)
                for m in rows
                if not m.get("compromised", False)
            ]
            comp = [
                m.get("accuracy", 0.0) for m in rows if m.get("compromised", False)
            ]
            # NaN placeholders keep every history list index-aligned with
            # 'round' even when a partial flush lost one class's reports.
            self.history["honest_accuracy"].append(
                float(np.mean(honest)) if honest else float("nan")
            )
            self.history["compromised_accuracy"].append(
                float(np.mean(comp)) if comp else float("nan")
            )

        vacs = [m["vacuity"] for m in rows if "vacuity" in m]
        if vacs:
            self.history["mean_vacuity"].append(float(np.mean(vacs)))
            self.history["mean_entropy"].append(
                float(np.mean([m["entropy"] for m in rows]))
            )
            self.history["mean_strength"].append(
                float(np.mean([m["strength"] for m in rows]))
            )

        # Per-round aggregator statistics, mean over reporting nodes — same
        # agg_<key> schema the simulation/tpu history records
        # (core/network.py), so the two backends' histories stay comparable.
        agg_keys = sorted({k for m in rows for k in m.get("stats", {})})
        for k in agg_keys:
            vals = [
                float(np.asarray(m["stats"][k], dtype=np.float64).mean())
                for m in rows
                if k in m.get("stats", {})
            ]
            self.history.setdefault(f"agg_{k}", []).append(float(np.mean(vals)))
