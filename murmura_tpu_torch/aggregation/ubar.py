"""UBAR: two-stage Byzantine-resilient aggregation (the PyTorch counterpart
of murmura_tpu/aggregation/ubar.py).

Stage 1, distance shortlist: keep the max(min_neighbors, floor(rho *
degree)) closest neighbours by L2, through the distance kernels.
Stage 2, loss probe: keep the shortlisted neighbours whose loss on the
node's probe batch is <= the node's own loss; when none passes, keep the
shortlisted neighbour of least loss (the first on a tie).  The output is
alpha * own + (1 - alpha) * the mean of the accepted neighbours.

The dense mode cross-evaluates every broadcast model on every node's probe
batch ([N, N] losses); the circulant mode (``exchange_offsets``, ``tpu.exchange:
ppermute``) evaluates only the k circulant neighbours ([k, N]).
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    blend_with_own,
    circulant_masked_mean,
    circulant_neighbor_distances,
    masked_neighbor_mean,
    pairwise_l2_distances,
    rank_mask,
    refuse_sparse_exchange,
    self_probe_metrics,
)
from murmura_tpu_torch.aggregation.probe import (
    ce_loss_metric,
    circulant_probe_eval,
    pairwise_probe_eval,
)


def _accept(shortlist: torch.Tensor, losses: torch.Tensor, own_loss: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Stage 2 over [N, M] candidates: the shortlisted ones whose loss is at
    most the node's own, else the shortlisted one of least loss."""
    passed = shortlist & (losses <= own_loss[:, None])
    shortlist_losses = torch.where(shortlist, losses, torch.full_like(losses, float("inf")))
    best = torch.argmin(shortlist_losses, dim=1)
    cols = torch.arange(shortlist.shape[1], device=shortlist.device)
    fallback = (cols[None, :] == best[:, None]) & shortlist
    none_passed = ~passed.any(dim=1)
    use_fallback = (none_passed & shortlist.any(dim=1))[:, None]
    return torch.where(use_fallback, fallback, passed).to(dtype)


def make_ubar(
    rho: float = 0.4,
    alpha: float = 0.5,
    min_neighbors: int = 1,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    refuse_sparse_exchange("ubar", sparse_exchange)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def stats(shortlist, accepted, stage1_denom, own_loss, dtype):
        shortlist_count = torch.clamp(shortlist.sum(dim=1).to(dtype), min=1.0)
        return {
            "stage1_acceptance_rate": shortlist.sum(dim=1) / stage1_denom,
            "stage2_acceptance_rate": accepted.sum(dim=1) / shortlist_count,
            "own_loss": own_loss,
        }

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        n, k = own.shape[0], len(offsets)
        d_nk = circulant_neighbor_distances(own, bcast, offsets).T  # [N, k]
        num_select = max(min_neighbors, int(rho * k))
        shortlist = rank_mask(
            d_nk, torch.ones_like(d_nk, dtype=torch.bool),
            torch.full((n,), num_select, dtype=torch.int64, device=own.device),
        )
        losses = circulant_probe_eval(bcast, offsets, ctx, ce_loss_metric)["loss"].T
        own_loss = self_probe_metrics(own, ctx, ce_loss_metric)["loss"]
        accepted = _accept(shortlist, losses, own_loss, own.dtype)  # [N, k]
        neighbor_avg = circulant_masked_mean(bcast, accepted.T, offsets)
        new_flat = blend_with_own(own, neighbor_avg, accepted.sum(dim=1) > 0, alpha)
        return new_flat, state, stats(shortlist, accepted, float(k), own_loss, own.dtype)

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        if offsets is not None:
            return aggregate_circulant(own, bcast, adj, round_idx, state, ctx)
        degree = adj.sum(dim=1)
        dist = pairwise_l2_distances(own, bcast)
        num_select = torch.clamp((rho * degree).to(torch.int32), min=min_neighbors)
        shortlist = rank_mask(dist, adj.to(torch.bool), num_select)
        losses = pairwise_probe_eval(bcast, ctx, ce_loss_metric)["loss"]  # [N, N]
        own_loss = self_probe_metrics(own, ctx, ce_loss_metric)["loss"]
        accepted = _accept(shortlist, losses, own_loss, own.dtype)
        neighbor_avg = masked_neighbor_mean(bcast, accepted)
        new_flat = blend_with_own(own, neighbor_avg, accepted.sum(dim=1) > 0, alpha)
        deg_safe = torch.clamp(degree, min=1.0)
        return new_flat, state, stats(shortlist, accepted, deg_safe, own_loss, own.dtype)

    return AggregatorDef(name="ubar", aggregate=aggregate)
