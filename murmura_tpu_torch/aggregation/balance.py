"""BALANCE: adaptive distance filtering (the PyTorch counterpart of
murmura_tpu/aggregation/balance.py).

threshold_i(t) = gamma * exp(-kappa * t/T) * |own_i|; accept neighbors at
L2 distance <= threshold; accept the closest neighbor when fewer than
``min_neighbors`` pass; output alpha*own + (1-alpha)*mean(accepted), or
own when nothing was accepted.  Dense distances come from the pairwise
kernel, circulant ones (``tpu.exchange: ppermute``) from the circulant
kernel.
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    blend_with_own,
    circulant_masked_mean,
    circulant_neighbor_distances,
    masked_neighbor_mean,
    pairwise_l2_distances,
    refuse_sparse_exchange,
)


def accept_with_closest_fallback(
    dist: torch.Tensor, adj: torch.Tensor, threshold: torch.Tensor, min_neighbors: int
) -> torch.Tensor:
    """[N, N] float mask of accepted neighbors: within ``threshold`` of the
    node, plus the closest neighbor where fewer than ``min_neighbors``
    passed (``dist`` [N, N] own-to-broadcast, diagonal ignored)."""
    n = adj.shape[0]
    adj_b = adj.to(torch.bool)
    accepted = adj_b & (dist <= threshold[:, None])
    count = accepted.sum(dim=1)
    has_any_neighbor = adj_b.any(dim=1)
    closest = torch.argmin(torch.where(adj_b, dist, torch.full_like(dist, float("inf"))), dim=1)
    fallback_row = torch.zeros_like(accepted)
    fallback_row[torch.arange(n, device=adj.device), closest] = True
    use_fallback = (count < min_neighbors) & has_any_neighbor
    accepted = torch.where(use_fallback[:, None], accepted | fallback_row, accepted)
    return accepted.to(dist.dtype)


def time_factor(round_idx, total_rounds: int, gamma: float, kappa: float) -> torch.Tensor:
    """gamma * exp(-kappa * round/T) in float32, as the JAX rules compute it."""
    lam = torch.tensor(round_idx, dtype=torch.float32) / max(1, int(total_rounds))
    return gamma * torch.exp(-kappa * lam)


def make_balance(
    gamma: float = 2.0,
    kappa: float = 1.0,
    alpha: float = 0.5,
    min_neighbors: int = 1,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    refuse_sparse_exchange("balance", sparse_exchange)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        own_norm = torch.sqrt(torch.sum(own * own, dim=-1))
        threshold = time_factor(round_idx, ctx.total_rounds, gamma, kappa).to(own.device) * own_norm

        if offsets is not None:
            d_k = circulant_neighbor_distances(own, bcast, offsets)  # [k, N]
            accept_k = d_k <= threshold[None, :]
            count = accept_k.sum(dim=0)
            closest = torch.argmin(d_k, dim=0)  # offset index per node
            ar = torch.arange(len(offsets), device=own.device)
            fallback = (count < min_neighbors)[None, :] & (ar[:, None] == closest[None, :])
            accept_k = (accept_k | fallback).to(own.dtype)
            neighbor_avg = circulant_masked_mean(bcast, accept_k, offsets, out_dtype=own.dtype)
            accepted_count = accept_k.sum(dim=0)
            degree = torch.full((n,), float(len(offsets)), dtype=own.dtype, device=own.device)
            if ctx.audit:
                # accept_k[o_idx, i]: receiver i accepted sender (i + o) % n.
                tap_selected_by = sum(
                    torch.roll(accept_k[i].to(torch.float32), o) for i, o in enumerate(offsets)
                )
                tap_considered_by = torch.full((n,), float(len(offsets)), device=own.device)
        else:
            dist = pairwise_l2_distances(own, bcast)
            accepted = accept_with_closest_fallback(dist, adj, threshold, min_neighbors)
            neighbor_avg = masked_neighbor_mean(bcast, accepted)
            accepted_count = accepted.sum(dim=1)
            degree = torch.clamp(adj.sum(dim=1), min=1.0)
            if ctx.audit:
                # Sender-side taps: column sums of the acceptance mask.
                tap_selected_by = accepted.to(torch.float32).sum(dim=0)
                tap_considered_by = adj.to(torch.float32).sum(dim=0)

        new_flat = blend_with_own(own, neighbor_avg, accepted_count > 0, alpha)
        stats = {"acceptance_rate": accepted_count / degree, "threshold": threshold}
        if ctx.audit:
            stats["tap_selected_by"] = tap_selected_by
            stats["tap_considered_by"] = tap_considered_by
        return new_flat, state, stats

    return AggregatorDef(
        name="balance", aggregate=aggregate, quantized_exchange=offsets is not None,
        influence=InfluenceDecl(
            "unbounded",
            note="distance-threshold accept-filter: benign inputs accept "
            "every neighbor; exclusion is data-dependent, not structural",
        ),
    )
