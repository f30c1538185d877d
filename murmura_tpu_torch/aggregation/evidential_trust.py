"""Evidential trust-aware aggregation (the PyTorch counterpart of
murmura_tpu/aggregation/evidential_trust.py).

Each neighbour j's model is evaluated on node i's probe batch
(``probe.evidential_trust_metric``):

    trust = clip((1 - vacuity) * (w_a * accuracy + 1 - w_a)
                 * [exp(-(vacuity - tau_u)) where vacuity > tau_u], 0, 1)

with an EMA over rounds (the first observation of an edge takes the raw
value), a tightening threshold tau(t) = clip(tau * (1 - gamma * exp(-kappa
t/T)), 0.05, tau), acceptance trust >= tau(t), and the output self_weight *
own + (1 - self_weight) * (the trust-weighted mean of the accepted
neighbours), or own where none is accepted.  The strength guard gives zero
trust to a neighbour whose mean Dirichlet strength exceeds
``strength_guard_factor`` times the median strength of the evaluated
neighbourhood, or whose metrics are not finite.

The carried state is the [N, N] smoothed trust and a seen mask.  The
dense exchange cross-evaluates every broadcast model on every node's probe
batch ([N, N]); the circulant exchange (``exchange_offsets``, ``tpu.exchange:
ppermute``) evaluates the k circulant neighbours ([k, N]) and reads and
writes the state at those edges only, on a copy.

The probe takes ``max_eval_samples`` samples a node (the factories size the
probe batch from it).  Not ported: the reuse of DMTT's shared
cross-evaluation (``ctx.probe_cross``, with DMTT) and the audit taps
(telemetry); the sparse [k, N] edge-mask exchange is refused.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from murmura_tpu_torch.aggregation.balance import time_factor
from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    blend_with_own,
    circulant_weighted_sum,
    masked_neighbor_mean,
    refuse_sparse_exchange,
)
from murmura_tpu_torch.aggregation.probe import (
    circulant_probe_eval,
    evidential_trust_metric,
    pairwise_probe_eval,
)


def make_evidential_trust(
    vacuity_threshold: float = 0.5,
    accuracy_weight: float = 0.5,
    trust_threshold: float = 0.3,
    self_weight: float = 0.5,
    use_adaptive_trust: bool = True,
    trust_momentum: float = 0.7,
    use_tightening_threshold: bool = True,
    gamma: float = 0.5,
    kappa: float = 1.0,
    strength_guard: bool = True,
    strength_guard_factor: float = 10.0,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    refuse_sparse_exchange("evidential_trust", sparse_exchange)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def init_state(num_nodes: int):
        return {
            "smoothed_trust": np.zeros((num_nodes, num_nodes), dtype=np.float32),
            "trust_seen": np.zeros((num_nodes, num_nodes), dtype=np.float32),
        }

    def trust_from_metrics(vacuity, accuracy):
        base_trust = (1.0 - vacuity) * (accuracy_weight * accuracy + (1.0 - accuracy_weight))
        penalty = torch.where(
            vacuity > vacuity_threshold, torch.exp(-(vacuity - vacuity_threshold)), 1.0
        )
        return torch.clamp(base_trust * penalty, 0.0, 1.0)

    def current_threshold(round_idx, total_rounds, device) -> torch.Tensor:
        """The schedule in float32, as the JAX rule computes it."""
        if not use_tightening_threshold:
            return torch.tensor(trust_threshold, dtype=torch.float32, device=device)
        decay = time_factor(round_idx, total_rounds, gamma, kappa)  # gamma exp(-kappa t/T)
        return torch.clamp(trust_threshold * (1.0 - decay), 0.05, trust_threshold).to(device)

    def guard(trust_new, vacuity, strength, median):
        """Zero trust where the strength dwarfs the neighbourhood median or
        a metric is not finite (NaN sorts after +inf in torch.sort, as in
        jnp.sort)."""
        inflated = strength > strength_guard_factor * torch.maximum(
            median, torch.tensor(1e-6, dtype=median.dtype, device=median.device))
        finite = torch.isfinite(trust_new) & torch.isfinite(vacuity) & torch.isfinite(strength)
        return torch.where(inflated | ~finite, 0.0, trust_new)

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        n, k = own.shape[0], len(offsets)
        ar = torch.arange(n, device=own.device)
        cols = (ar[None, :] + torch.tensor(offsets, device=own.device)[:, None]) % n  # [k, N]
        rows = ar[None, :].expand(k, n)

        metrics = circulant_probe_eval(bcast, offsets, ctx, evidential_trust_metric)  # [k, N]
        vacuity = metrics["vacuity"]
        trust_new = trust_from_metrics(vacuity, metrics["accuracy"])
        if strength_guard:
            strength = metrics["strength"]
            median = torch.sort(strength, dim=0).values[(k - 1) // 2][None, :]
            trust_new = guard(trust_new, vacuity, strength, median)

        if use_adaptive_trust:
            seen = state["trust_seen"][rows, cols]
            smoothed = (trust_momentum * trust_new
                        + (1.0 - trust_momentum) * state["smoothed_trust"][rows, cols])
            trust = torch.where(seen > 0, smoothed, trust_new)
            # The state tensors belong to the caller: write a copy.
            new_state = {"smoothed_trust": state["smoothed_trust"].clone(),
                         "trust_seen": state["trust_seen"].clone()}
            new_state["smoothed_trust"][rows, cols] = trust
            new_state["trust_seen"][rows, cols] = 1.0
        else:
            trust = trust_new
            new_state = state

        threshold = current_threshold(round_idx, ctx.total_rounds, own.device)
        accepted = trust >= threshold  # [k, N]
        weights = torch.where(accepted, trust, 0.0)
        total = weights.sum(dim=0)
        norm_w = weights / torch.clamp(total, min=1e-12)[None, :]
        neighbor_agg = circulant_weighted_sum(bcast, norm_w, offsets, out_dtype=own.dtype)
        new_flat = blend_with_own(own, neighbor_agg, total > 0, self_weight)
        stats = {
            "acceptance_rate": accepted.sum(dim=0) / float(k),
            "mean_trust": trust.mean(dim=0),
            "mean_vacuity": vacuity.mean(dim=0),
            "mean_entropy": metrics["entropy"].mean(dim=0),
            "threshold": threshold.expand(n),
        }
        return new_flat, new_state, stats

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        if offsets is not None:
            return aggregate_circulant(own, bcast, adj, round_idx, state, ctx)
        n = own.shape[0]
        adj_b = adj.to(torch.bool)
        metrics = pairwise_probe_eval(bcast, ctx, evidential_trust_metric)  # [N_i, N_j]
        vacuity = metrics["vacuity"]
        trust_new = trust_from_metrics(vacuity, metrics["accuracy"])
        if strength_guard:
            # The median of the evaluated neighbourhood: non-neighbours sort
            # last as +inf, the median index comes from the degree.
            strength = metrics["strength"]
            order = torch.sort(torch.where(adj_b, strength, float("inf")), dim=1).values
            deg = torch.clamp(adj_b.sum(dim=1), min=1)
            med_idx = torch.clamp((deg - 1) // 2, 0, n - 1)
            median = torch.gather(order, 1, med_idx[:, None])  # [N, 1]
            trust_new = guard(trust_new, vacuity, strength, median)

        if use_adaptive_trust:
            seen = state["trust_seen"]
            smoothed = (trust_momentum * trust_new
                        + (1.0 - trust_momentum) * state["smoothed_trust"])
            trust = torch.where(seen > 0, smoothed, trust_new)
            # Only the edges of the graph are observed.
            new_state = {
                "smoothed_trust": torch.where(adj_b, trust, state["smoothed_trust"]),
                "trust_seen": torch.where(adj_b, 1.0, seen),
            }
        else:
            trust = trust_new
            new_state = state

        threshold = current_threshold(round_idx, ctx.total_rounds, own.device)
        accepted = adj_b & (trust >= threshold)
        weights = torch.where(accepted, trust, 0.0)
        # masked_neighbor_mean normalises by the weights it multiplies by
        # (cast to the parameter dtype first), accumulating in float32.
        neighbor_agg = masked_neighbor_mean(bcast, weights)
        new_flat = blend_with_own(own, neighbor_agg, weights.sum(dim=1) > 0, self_weight)

        degree = torch.clamp(adj.sum(dim=1), min=1.0)

        def masked(m):
            return (m * adj).sum(dim=1) / degree

        stats = {
            "acceptance_rate": accepted.sum(dim=1) / degree,
            "mean_trust": masked(trust),
            "mean_vacuity": masked(vacuity),
            "mean_entropy": masked(metrics["entropy"]),
            "threshold": threshold.expand(n),
        }
        return new_flat, new_state, stats

    return AggregatorDef(name="evidential_trust", aggregate=aggregate, init_state=init_state)
