"""One peer's runtime for the ZMQ backend (the PyTorch counterpart of
murmura_tpu/distributed/local.py).

One process owns one FL node: local SGD, eval and the probe eval on the
node's device (the CUDA card unless the caller asks for the CPU), and
aggregation through the SAME rules as the in-process backends on a
fixed-size mini network: slot 0 is this node, slots 1..M-1 hold the
neighbour states that arrived before the round deadline, and a missing
neighbour is masked out of the adjacency row (partial aggregation).  M =
1 + max_degree, so the rule sees one shape whatever arrived.  On the card
the rules launch their kernels on the mini network's [M, P] tensors
(Krum's two pairwise passes, Sketchguard's count sketch).

The mini network computes all M rows of the cheap per-entry math although
only row 0 is consumed; the probe rules (UBAR's stage 2, evidential trust)
get this node's probe batch with a leading dim of 1, so each of the M
models is forwarded once, not M^2 times.

The random draws of local training (each epoch's permutation, and the
dropout masks of each step where the model has dropout) come from a CPU
``torch.Generator`` that is a pure function of ``(seed, round)`` and are
then moved to the device, so a round on the card takes the draws of the
same round on the CPU.  ``local_train(round, draws=...)`` injects them
instead (the JAX node's own draws, in the tests).
"""

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import grad

from murmura_tpu_torch.aggregation.base import AggContext, AggregatorDef
from murmura_tpu_torch.core.rounds import evidential_lambda, pin_full_float32
from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.ops.flatten import make_flatteners, tree_leaves, tree_to_torch
from murmura_tpu_torch.ops.losses import (
    evidential_loss,
    masked_cross_entropy,
    uncertainty_metrics,
)


def node_device(device) -> torch.device:
    """The node's device; ``cuda`` without a usable card is an error, never
    a fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a node of the distributed backend runs on "
                "the card by default; pass --device cpu to run on the CPU"
            )
        pin_full_float32()
    return device


def round_draw_generator(seed: int, round_idx: int) -> torch.Generator:
    """The CPU generator of one node's round: a pure function of (seed,
    round), as the round program's ``round_generators``."""
    g = torch.Generator()
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(round_idx)]).generate_state(1)[0]))
    return g


def _to_device(draw, dtype, device) -> torch.Tensor:
    """A draw on ``device``: a CPU tensor (the node's own draw) is copied
    straight over; an injected array (the JAX node's draw) goes through
    numpy first."""
    if not isinstance(draw, torch.Tensor):
        draw = torch.as_tensor(np.array(draw))
    return draw.to(device=device, dtype=dtype, non_blocking=True)


class LocalNode:
    """One FL peer: local SGD, eval and rule-based aggregation."""

    def __init__(
        self,
        node_id: int,
        model: Model,
        agg: AggregatorDef,
        x: np.ndarray,
        y: np.ndarray,
        *,
        eval_x: Optional[np.ndarray] = None,
        eval_y: Optional[np.ndarray] = None,
        max_neighbors: int,
        local_epochs: int = 1,
        batch_size: int = 64,
        lr: float = 0.01,
        total_rounds: int = 20,
        probe_size: Optional[int] = None,
        annealing_rounds: int = 10,
        seed: int = 42,
        device="cuda",
        init_params: Any = None,
    ):
        self.node_id = node_id
        self.model = model
        self.agg = agg
        self.total_rounds = total_rounds
        self.mini_n = 1 + max_neighbors
        self.device = node_device(device)
        self.seed = int(seed)

        def inputs(a):
            a = np.asarray(a)
            dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
            return torch.as_tensor(a, dtype=dtype).to(self.device)

        n_samples = len(y)
        self.x = inputs(x)
        self.y = torch.as_tensor(np.asarray(y), dtype=torch.int64).to(self.device)
        self.n_samples = n_samples
        # Held-out evaluation arrays; default: the training shard.
        self._eval_x = self.x if eval_x is None else inputs(eval_x)
        self._eval_y = self.y if eval_y is None else torch.as_tensor(
            np.asarray(eval_y), dtype=torch.int64).to(self.device)
        # The reference batch rule (murmura/core/network.py:278-287).
        self.eff_batch = int(min(batch_size, max(2, n_samples)))
        self.steps = n_samples // self.eff_batch if n_samples > self.eff_batch else 1
        self.local_epochs = local_epochs
        self.lr = lr
        self.evidential = model.evidential
        self.num_classes = model.num_classes
        self.annealing_rounds = annealing_rounds

        if init_params is None:
            params = model.init(torch.Generator().manual_seed(self.seed), torch.device("cpu"))
        else:
            params = tree_to_torch(init_params, "cpu", torch.float32)
        self._ravel, self._unravel, self.model_dim = make_flatteners(params)
        self.flat = self._ravel(params).to(self.device).contiguous()

        p_size = int(min(n_samples, probe_size or self.eff_batch))
        self._probe_x = self.x[:p_size]
        self._probe_y = self.y[:p_size]
        self._probe_mask = torch.ones((p_size,), dtype=torch.float32, device=self.device)

        # Per-rule carried state, projected per AggregatorDef.state_kind.
        template = {k: np.asarray(v) for k, v in agg.init_state(self.mini_n).items()}
        unknown = [k for k in template if agg.state_kind.get(k) not in ("node", "edge")]
        if unknown:
            raise ValueError(
                f"Aggregator '{agg.name}' carries state keys {unknown} without a "
                "state_kind annotation — the distributed backend cannot project "
                "them per-neighbor and would silently reset them every round"
            )
        self._node_state = {
            k: np.array(v[0]) for k, v in template.items()
            if agg.state_kind.get(k) == "node"
        }
        self._edge_state: Dict[str, Dict[int, np.ndarray]] = {
            k: {} for k in template if agg.state_kind.get(k) == "edge"
        }
        self._state_template = template
        self._ctx = AggContext(
            apply_fn=model.apply,
            unravel=self._unravel,
            # Leading dim 1: one evaluator, each of the M models forwarded
            # once on this node's batch (aggregation/probe.py).
            probe_x=self._probe_x[None],
            probe_y=self._probe_y[None],
            probe_mask=self._probe_mask[None],
            evidential=self.evidential,
            num_classes=self.num_classes,
            total_rounds=total_rounds,
        )
        self._grad = grad(self._loss)
        self._last_stats: Dict[str, float] = {}
        # Seconds of the last local_train and aggregate_with_neighbors,
        # each ending in a device synchronise.
        self.timings: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _loss(self, params, xb, yb, masks, lam):
        out = self.model.apply(params, xb, masks)
        ones = torch.ones(xb.shape[0], dtype=torch.float32, device=xb.device)
        if self.evidential:
            return evidential_loss(out, yb, ones, self.num_classes, lam)
        loss, _ = masked_cross_entropy(out, yb, ones)
        return loss

    def round_draws(self, round_idx: int) -> Dict[str, List]:
        """The round's draws on the CPU: ``perm`` one permutation an epoch,
        ``dropout`` per epoch and step one bool [B, width] mask a dropout
        layer (empty lists without dropout)."""
        g = round_draw_generator(self.seed, round_idx)
        keep = 1.0 - self.model.dropout
        perms, masks = [], []
        for _ in range(self.local_epochs):
            perms.append(torch.randperm(self.n_samples, generator=g))
            masks.append([
                [torch.rand((self.eff_batch, w), generator=g) < keep
                 for w in self.model.dropout_widths]
                for _ in range(self.steps)
            ] if self.model.dropout_widths else [])
        return {"perm": perms, "dropout": masks}

    def local_train(self, round_idx: int, draws: Optional[Dict[str, List]] = None) -> None:
        """``local_epochs`` x SGD over this node's shard, in place."""
        t0 = time.perf_counter()
        draws = self.round_draws(round_idx) if draws is None else draws
        lam = evidential_lambda(round_idx, self.annealing_rounds)
        b, n = self.eff_batch, self.n_samples
        params = self._unravel(self.flat)
        arange_b = torch.arange(b, device=self.device)
        for epoch in range(self.local_epochs):
            perm = _to_device(draws["perm"][epoch], torch.int64, self.device)
            step_masks = draws.get("dropout") or []
            for t in range(self.steps):
                idx = perm[(t * b + arange_b) % n]
                masks = []
                if self.model.dropout_widths:
                    masks = [_to_device(m, torch.bool, self.device)
                             for m in step_masks[epoch][t]]
                g = self._grad(params, self.x[idx], self.y[idx], masks, lam)
                with torch.no_grad():
                    for p, gp in zip(tree_leaves(params), tree_leaves(g)):
                        p.sub_(self.lr * gp)
        self._sync()
        self.timings["train_s"] = time.perf_counter() - t0

    def get_flat_state(self) -> np.ndarray:
        return self.flat.detach().cpu().numpy().astype(np.float32, copy=True)

    def set_flat_state(self, flat: np.ndarray) -> None:
        """Set the parameters from a flat float32 vector in the JAX package's
        flat order (the wire format)."""
        with torch.no_grad():
            self.flat.copy_(torch.as_tensor(np.array(flat, dtype=np.float32)))

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        out = self.model.apply(self._unravel(self.flat), self._eval_x)
        ey = self._eval_y
        if self.evidential:
            unc = uncertainty_metrics(out)
            nll = -torch.log(torch.gather(unc["probs"], -1, ey[:, None])[:, 0] + 1e-10)
            acc = (torch.argmax(out, -1) == ey).to(torch.float32).mean()
            metrics = {
                "loss": nll.mean(),
                "accuracy": acc,
                "vacuity": unc["vacuity"].mean(),
                "entropy": unc["entropy"].mean(),
                "strength": unc["strength"].mean(),
            }
        else:
            loss, acc = masked_cross_entropy(
                out, ey, torch.ones(ey.shape[0], dtype=torch.float32, device=ey.device))
            metrics = {"loss": loss, "accuracy": acc}
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def probe_eval_flat(self, flat: np.ndarray) -> Dict[str, float]:
        """Accuracy and vacuity of a neighbour's flat state on this node's
        probe data (DMTT's model score)."""
        params = self._unravel(torch.as_tensor(np.asarray(flat, np.float32)).to(self.device))
        out = self.model.apply(params, self._probe_x)
        acc = (torch.argmax(out, -1) == self._probe_y).to(torch.float32).mean()
        vac = uncertainty_metrics(out)["vacuity"].mean() if self.evidential else 0.0
        return {"accuracy": float(acc), "vacuity": float(vac)}

    # ------------------------------------------------------------------
    # aggregation through the shared rules
    # ------------------------------------------------------------------

    def _mini_state(self, neighbor_ids: List[int]) -> Dict[str, torch.Tensor]:
        state = {}
        for k, template in self._state_template.items():
            arr = np.array(template)
            kind = self.agg.state_kind.get(k)
            if kind == "node":
                arr[0] = self._node_state[k]
            elif kind == "edge":
                for slot, nid in enumerate(neighbor_ids, start=1):
                    if nid in self._edge_state[k]:
                        arr[0, slot] = self._edge_state[k][nid]
            state[k] = torch.as_tensor(arr).to(self.device)
        return state

    def _store_state(self, state, neighbor_ids: List[int]) -> None:
        for k in self._state_template:
            kind = self.agg.state_kind.get(k)
            arr = state[k].detach().cpu().numpy()
            if kind == "node":
                self._node_state[k] = np.array(arr[0])
            elif kind == "edge":
                for slot, nid in enumerate(neighbor_ids, start=1):
                    self._edge_state[k][nid] = np.array(arr[0, slot])

    def mini_network(self, neighbor_states: Dict[int, np.ndarray]):
        """(stack [M, P], adj [M, M], neighbour ids) on the node's device:
        slot 0 this node, then the arrived neighbours by id, the missing
        slots zero rows masked out of the adjacency."""
        m = self.mini_n
        neighbor_ids = sorted(neighbor_states)[: m - 1]
        flats = np.zeros((m, self.model_dim), np.float32)
        mask = np.zeros((m - 1,), np.float32)
        for slot, nid in enumerate(neighbor_ids):
            flats[1 + slot] = neighbor_states[nid]
            mask[slot] = 1.0
        stack = torch.as_tensor(flats).to(self.device)
        stack[0] = self.flat
        adj = np.zeros((m, m), np.float32)
        adj[0, 1:] = mask
        adj[1:, 0] = mask
        return stack, torch.as_tensor(adj).to(self.device), neighbor_ids

    def aggregate_with_neighbors(
        self, neighbor_states: Dict[int, np.ndarray], round_num: int
    ) -> None:
        """Aggregate own params with the received subset (partial OK)."""
        t0 = time.perf_counter()
        stack, adj, neighbor_ids = self.mini_network(neighbor_states)
        state = self._mini_state(neighbor_ids)
        with torch.no_grad():
            new_flat, new_state, stats = self.agg.aggregate(
                stack, stack, adj, float(round_num), state, self._ctx)
            self.flat.copy_(new_flat[0])
        self._store_state(new_state, neighbor_ids)
        self._last_stats = {k: float(v[0]) for k, v in stats.items()}
        self._sync()
        self.timings["aggregate_s"] = time.perf_counter() - t0

    def get_aggregator_statistics(self) -> Dict[str, float]:
        return dict(self._last_stats)

