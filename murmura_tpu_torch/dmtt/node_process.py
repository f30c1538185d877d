"""DMTT trust-protocol node process of the ZMQ backend (the PyTorch
counterpart of murmura_tpu/dmtt/node_process.py; reference:
murmura/dmtt/node_process.py:53-406).

Extends ``NodeProcess`` with the 11-step DMTT round
(murmura/dmtt/node_process.py:150-250):

1.  local train (honest only)
2.  outgoing state (+ wrapped model attack, topology_liar.py:57-72)
3.  TOPO_CLAIM = true G^t neighbours, or the liar's falsified set: true
    neighbours united with the Byzantine coalition (topology_liar.py:78-102)
4.  PUSH MODEL_STATE + TOPO_CLAIM to current collaborators C_i^t
5.  collect both message types until the round deadline, dropping
    unexpected senders (node_process.py:288-289)
6.  link-reliability EMA from who answered (state.py:53-57)
7.  score received neighbour models on local probe data: accuracy +
    Dirichlet vacuity (node_process.py:309-363)
8.  verify claims against the locally recomputed deterministic G^t,
    update Beta evidence with forgetting (node_process.py:369-395,
    state.py:63-76)
9.  aggregate with the received subset
10. TopB over collaboration scores -> C_i^{t+1} (state.py:128-142)
11. evaluate + METRICS to the monitor

Per-neighbour trust is held as scalar dicts; the trust formulas are the
port's dmtt/protocol.py functions, applied to float32 [K] vectors, so this
backend and the in-process round use one implementation.
"""

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from murmura_tpu_torch.distributed.messaging import (
    MsgType,
    decode,
    encode,
    pack_obj,
    pack_state,
    unpack_obj,
    unpack_state,
)
from murmura_tpu_torch.distributed.node_process import NodeProcess
from murmura_tpu_torch.dmtt.protocol import (
    DMTTParams,
    collab_score,
    model_score,
    topo_trust,
)


def _f32(values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32))


class DMTTNodeProcess(NodeProcess):
    """One DMTT FL node in its own OS process."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.config.dmtt is None:
            raise ValueError("DMTTNodeProcess requires config.dmtt")
        self.dmtt = DMTTParams(**self.config.dmtt.model_dump(exclude={"allow_static"}))
        # Per-neighbour trust state (reference: state.py:42-47).
        self._c_hat: Dict[int, float] = {}
        self._alpha: Dict[int, float] = {}
        self._beta: Dict[int, float] = {}
        # None = no TopB selection yet -> use G^t directly
        # (reference: node_process.py:111-118).
        self._collaborators: Optional[List[int]] = None
        self._dmtt_stats: Dict[str, float] = {}
        self._static_truth: Optional[Dict[int, Set[int]]] = None

    # ------------------------------------------------------------------

    def _setup_sockets(self) -> None:
        """Pre-connect PUSH to every peer: under a dynamic topology any node
        may become a collaborator (reference: dmtt/node_process.py:103-105)."""
        super()._setup_sockets()
        for nid in range(self.config.topology.num_nodes):
            if nid != self.node_id:
                self._push_to(nid)

    def current_collaborators(self, round_idx: int) -> List[int]:
        """C_i^t: last TopB selection, or G^t neighbours before the first one."""
        if self._collaborators is None:
            return self.current_neighbors(round_idx)
        return list(self._collaborators)

    # ------------------------------------------------------------------

    def _execute_round(self, round_idx: int, draws: Optional[Dict] = None) -> None:
        """The 11-step DMTT round (reference: dmtt/node_process.py:150-250).
        ``draws`` as in NodeProcess._execute_round."""
        draws = draws or {}
        deadline = self.t_start + (round_idx + 1) * self.round_duration
        true_neighbors = self.current_neighbors(round_idx)
        collaborators = self.current_collaborators(round_idx)
        times = self.round_times.setdefault(round_idx, {})

        # 1. local training (honest only)
        if not self.is_compromised:
            self.node.local_train(round_idx, draws=draws.get("train"))
            times["train_s"] = self.node.timings["train_s"]

        if time.monotonic() >= deadline:
            print(
                f"[node {self.node_id}] round {round_idx}: training overran "
                "the round window; skipping exchange",
                flush=True,
            )
            self._send_metrics(round_idx, skipped=True)
            return

        # 2. outgoing state (+ model poisoning for liars with a wrapped attack)
        out_flat = self._attacked_state(self.node.get_flat_state(), round_idx,
                                        draws.get("noise"))

        # 3. TOPO_CLAIM (liars claim the Byzantine coalition as neighbours)
        claim = self._make_claim(true_neighbors)

        # 4. PUSH state + claim to current collaborators
        state_payload = pack_state(out_flat)
        claim_payload = pack_obj({"neighbors": claim})
        for nid in collaborators:
            try:
                sock = self._push_to(nid)
                sock.send_multipart(
                    encode(MsgType.MODEL_STATE, self.node_id, state_payload, round_idx),
                    copy=False,
                )
                sock.send_multipart(
                    encode(MsgType.TOPO_CLAIM, self.node_id, claim_payload, round_idx)
                )
            except Exception as e:  # pragma: no cover - socket teardown races
                print(f"[node {self.node_id}] push to {nid} failed: {e}", flush=True)

        # 5. collect MODEL_STATE + TOPO_CLAIM until deadline
        expected = set(collaborators)
        states, claims = self._collect_states_and_claims(expected, round_idx, deadline)

        # 6. link-reliability EMA over the expected set (state.py:53-57)
        for nid in expected:
            ack = 1.0 if nid in states else 0.0
            prev = self._c_hat.get(nid, 0.5)
            self._c_hat[nid] = (1.0 - self.dmtt.rho) * prev + self.dmtt.rho * ack

        # 7. score received models on local probe data (node_process.py:309-363)
        scores = self._score_models(states)

        # 8. verify claims vs the locally recomputed G^t -> Beta trust
        self._verify_claims(claims, round_idx)

        # 9. aggregate with whatever arrived (partial OK)
        if states:
            self.node.aggregate_with_neighbors(states, round_idx)
            times["aggregate_s"] = self.node.timings["aggregate_s"]

        # 10. TopB collaborator selection over direct G^t neighbours
        self._select_collaborators(true_neighbors, scores)

        # 11. evaluate + metrics
        self._dmtt_stats = {
            "dmtt_collab_count": float(len(self._collaborators or [])),
            "dmtt_received_count": float(len(states)),
            "dmtt_mean_topo_trust": self._mean_topo_trust(true_neighbors),
        }
        self._send_metrics(round_idx, skipped=False)

    # ------------------------------------------------------------------

    def _score_models(self, states: Dict[int, np.ndarray]) -> Dict[int, float]:
        """s^model of each received state on this node's probe batch."""
        scores: Dict[int, float] = {}
        for nid, flat in states.items():
            probe = self.node.probe_eval_flat(flat)
            scores[nid] = float(model_score(_f32(probe["accuracy"]), _f32(probe["vacuity"]),
                                            self.dmtt))
        return scores

    def _make_claim(self, true_neighbors: List[int]) -> List[int]:
        """Honest claim = true G^t neighbours; compromised nodes get theirs
        from the attack's claims_fn, the same [N, N] transform the
        in-process round applies (topology_liar.py:78-102), evaluated for
        this node's row."""
        if (
            self.is_compromised
            and self.attack is not None
            and self.attack.claims_fn is not None
        ):
            n = self.config.topology.num_nodes
            adj_row = np.zeros((n, n), np.float32)
            adj_row[self.node_id, true_neighbors] = 1.0
            comp_mask = np.zeros((n,), np.float32)
            comp_mask[sorted(self.compromised_ids)] = 1.0
            claimed = self.attack.claims_fn(torch.from_numpy(adj_row),
                                            torch.from_numpy(comp_mask)).numpy()
            return sorted(int(j) for j in np.flatnonzero(claimed[self.node_id]))
        return sorted(true_neighbors)

    def _collect_states_and_claims(
        self, expected: Set[int], round_idx: int, deadline: float
    ) -> Tuple[Dict[int, np.ndarray], Dict[int, List[int]]]:
        """PULL both message types until every expected collaborator
        delivered both, or the deadline (reference:
        dmtt/node_process.py:256-303)."""
        import zmq

        states: Dict[int, np.ndarray] = {}
        claims: Dict[int, List[int]] = {}
        poller = zmq.Poller()
        poller.register(self._pull, zmq.POLLIN)
        while (
            (expected - set(states)) or (expected - set(claims))
        ) and time.monotonic() < deadline:
            timeout_ms = max(1, int((deadline - time.monotonic()) * 1000))
            events = dict(poller.poll(min(timeout_ms, 200)))
            if self._pull not in events:
                continue
            msg_type, sender, msg_round, payload = decode(self._pull.recv_multipart())
            # drop unexpected senders (node_process.py:288-289) and
            # stragglers from earlier round windows (header round tag)
            if sender not in expected or msg_round != round_idx:
                continue
            if msg_type == MsgType.MODEL_STATE:
                states[sender] = unpack_state(payload)
            elif msg_type == MsgType.TOPO_CLAIM:
                claims[sender] = list(unpack_obj(payload).get("neighbors", []))
        return states, claims

    def _verify_claims(self, claims: Dict[int, List[int]], round_idx: int) -> None:
        """d_j / x_j = confirmations / contradictions of j's claim vs the
        locally recomputed G^t; Beta update with forgetting, floored at 0.01
        (reference: dmtt/node_process.py:369-395, state.py:63-76)."""
        p = self.dmtt
        if self.mobility is not None:
            truth = {
                i: set(ns)
                for i, ns in self.mobility.neighbors_at(round_idx).items()
            }
        else:
            truth = self._static_ground_truth()
        for nid, claimed in claims.items():
            true_set = truth[nid]
            claimed_set = set(claimed) - {nid}
            d = float(len(claimed_set & true_set))
            x = float(len(claimed_set - true_set))
            alpha = p.lambda_forget * self._alpha.get(nid, 1.0) + p.w_d * d
            beta = p.lambda_forget * self._beta.get(nid, 1.0) + p.w_x * x
            self._alpha[nid] = max(0.01, alpha)
            self._beta[nid] = max(0.01, beta)

    def _static_ground_truth(self) -> Dict[int, Set[int]]:
        """Static topology: G^t is the fixed graph, recomputed once from the
        shared seed (every process reconstructs the same graph)."""
        if self._static_truth is None:
            from murmura_tpu_torch.topology.generators import create_topology

            cfg = self.config.topology
            topo = create_topology(
                cfg.type, num_nodes=cfg.num_nodes, p=cfg.p, k=cfg.k, seed=cfg.seed,
            )
            self._static_truth = {i: set(ns) for i, ns in enumerate(topo.neighbors)}
        return self._static_truth

    def _select_collaborators(self, true_neighbors: List[int],
                              scores: Dict[int, float]) -> None:
        """TopB over q = λ1·s_model + λ2·T^topo + λ3·ĉ − λ4·c_comm among
        direct G^t neighbours (reference: dmtt/node_process.py:235-241,
        state.py:112-142)."""
        p = self.dmtt
        if not true_neighbors:
            self._collaborators = []
            return
        cand = np.asarray(true_neighbors)
        alpha = _f32([self._alpha.get(j, 1.0) for j in cand])
        beta = _f32([self._beta.get(j, 1.0) for j in cand])
        c_hat = _f32([self._c_hat.get(j, 0.5) for j in cand])
        # default model score 0.5 where no model arrived (state.py:139)
        s_model = _f32([scores.get(j, 0.5) for j in cand])
        t = topo_trust(alpha, beta, p)
        q = collab_score(s_model, t, c_hat, p).numpy()
        top = np.argsort(-q)[: p.budget_B]
        self._collaborators = sorted(int(cand[i]) for i in top)

    def _mean_topo_trust(self, true_neighbors: List[int]) -> float:
        if not true_neighbors:
            return 0.0
        p = self.dmtt
        alpha = _f32([self._alpha.get(j, 1.0) for j in true_neighbors])
        beta = _f32([self._beta.get(j, 1.0) for j in true_neighbors])
        return float(topo_trust(alpha, beta, p).mean())

    def _metrics(self, round_idx: int, skipped: bool) -> dict:
        metrics = super()._metrics(round_idx, skipped)
        if not skipped:
            metrics["stats"].update(self._dmtt_stats)
        return metrics
