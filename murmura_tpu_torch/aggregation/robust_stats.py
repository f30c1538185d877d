"""Coordinate-wise median and trimmed mean, and the geometric median (the
PyTorch counterpart of murmura_tpu/aggregation/robust_stats.py).

Per node i the candidates are {own_i} ∪ {bcast_j : j ∈ N(i)}, Krum's
candidate set.  Dense: the candidates are gathered as an [N, m, P] stack,
P-chunked, and reduced along the candidate axis (plain tensor code, as in
the JAX package).  Circulant (``tpu.exchange: ppermute``): the median and
the trimmed mean go through the fused candidate-select kernel, and the
geometric median's Weiszfeld steps through the circulant distance kernel.
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    candidate_chunk_dispatch,
    candidate_indices,
    circulant_neighbor_distances,
    circulant_weighted_sum,
    pairwise_l2_distances,
    refuse_sparse_exchange,
)
from murmura_tpu_torch.ops import candidate_kernels


def _dense_candidate_map(own, bcast, adj, m_cap, fn):
    """``fn(cand [N, m, c], valid [N, m]) -> [N, c]`` over the gathered
    candidate stack (self first, taking the node's own true state), P-chunked.

    Returns:
        ([N, P] result, valid [N, m]).
    """
    n = bcast.shape[0]
    cand_idx, valid = candidate_indices(adj, m_cap)
    is_self = cand_idx == torch.arange(n, device=adj.device)[:, None]

    def chunk_apply(oc, bc):
        cand = torch.where(is_self[:, :, None], oc[:, None, :], bc[cand_idx])
        return fn(cand, valid)

    return candidate_chunk_dispatch(own, bcast, chunk_apply, int(cand_idx.shape[1])), valid


def _sorted_valid(cand, valid):
    """Candidates sorted along axis 1, invalid ones +inf-padded to the end."""
    inf = torch.tensor(float("inf"), dtype=cand.dtype, device=cand.device)
    return torch.sort(torch.where(valid[:, :, None], cand, inf), dim=1).values


def _candidate_select(own, bcast, offsets, **kw):
    """The candidate kernel over own and bcast in bcast's dtype (float32
    under an int8 exchange, where own may be bfloat16), written in own's."""
    return candidate_kernels.candidate_select(
        own.to(bcast.dtype), bcast, offsets, **kw).to(own.dtype)


def _take(ranked, idx):
    """ranked[i, idx[i], :] for each node i, as [N, c]."""
    return torch.gather(ranked, 1, idx[:, None, None].expand(-1, 1, ranked.shape[2]))[:, 0]


def make_coordinate_median(
    max_candidates: Optional[int] = None,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    """Coordinate-wise median over own + neighbor states."""
    refuse_sparse_exchange("median", sparse_exchange)
    mc = None if max_candidates is None else int(max_candidates)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        m_cap = n if mc is None else min(mc, n)

        def coord_median(cand, valid):
            cnt = valid.sum(dim=1)
            ranked = _sorted_valid(cand, valid)
            return 0.5 * (_take(ranked, (cnt - 1) // 2) + _take(ranked, cnt // 2))

        new_flat, valid = _dense_candidate_map(own, bcast, adj, m_cap, coord_median)
        return new_flat, state, {"num_candidates": valid.sum(dim=1).to(torch.float32)}

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        m = len(offsets) + 1
        new_flat = _candidate_select(own, bcast, offsets, median=True)
        return new_flat, state, {
            "num_candidates": torch.full((own.shape[0],), float(m), device=own.device)
        }

    return AggregatorDef(
        name="median", aggregate=aggregate if offsets is None else aggregate_circulant,
        quantized_exchange=offsets is not None,
        influence=InfluenceDecl(
            "bounded",
            bound=lambda k: 1 if (k + 1) % 2 else 2,
            note="coordinate-wise median: the middle element (or pair) of "
            "the sorted candidate stack",
        ),
    )


def make_trimmed_mean(
    trim_ratio: float = 0.2,
    max_candidates: Optional[int] = None,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    """Coordinate-wise beta-trimmed mean: drop the floor(beta*cnt) smallest
    and largest values per coordinate, average the rest.  On the circulant
    path every node has m = k+1 candidates, so the trim depth is static."""
    beta = float(trim_ratio)
    if not 0.0 <= beta < 0.5:
        raise ValueError(f"trim_ratio must be in [0, 0.5), got {beta}")
    refuse_sparse_exchange("trimmed_mean", sparse_exchange)
    mc = None if max_candidates is None else int(max_candidates)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def trim_of(cnt):
        return torch.floor(beta * cnt).to(cnt.dtype)

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        m_cap = n if mc is None else min(mc, n)

        def coord_trimmed(cand, valid):
            cnt = valid.sum(dim=1)  # [N]
            trim = trim_of(cnt)
            ranked = _sorted_valid(cand, valid)
            pos = torch.arange(valid.shape[1], device=cand.device)[None, :]
            keep = (pos >= trim[:, None]) & (pos < (cnt - trim)[:, None])  # [N, m]
            kept = torch.where(keep[:, :, None], ranked, torch.zeros_like(ranked)).sum(dim=1)
            denom = torch.clamp(cnt - 2 * trim, min=1)[:, None].to(own.dtype)
            return kept / denom

        new_flat, valid = _dense_candidate_map(own, bcast, adj, m_cap, coord_trimmed)
        cnt = valid.sum(dim=1)
        return new_flat, state, {
            "num_candidates": cnt.to(torch.float32),
            "trimmed_per_side": trim_of(cnt).to(torch.float32),
        }

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        m = len(offsets) + 1
        trim = int(beta * m)  # static: every node has exactly m candidates
        new_flat = _candidate_select(own, bcast, offsets, trim=trim)
        return new_flat, state, {
            "num_candidates": torch.full((n,), float(m), device=own.device),
            "trimmed_per_side": torch.full((n,), float(trim), device=own.device),
        }

    return AggregatorDef(
        name="trimmed_mean", aggregate=aggregate if offsets is None else aggregate_circulant,
        quantized_exchange=offsets is not None,
        influence=InfluenceDecl(
            "bounded",
            bound=lambda k: (k + 1) - 2 * int(beta * (k + 1)),
            note=f"beta-trimmed mean (beta={beta}): only the sorted "
            "interior is averaged; the trimmed tails never contribute",
        ),
    )


def make_geometric_median(
    max_iters: int = 8,
    smoothing: float = 1e-6,
    max_candidates: Optional[int] = None,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    """Geometric median via ``max_iters`` smoothed Weiszfeld steps.

    Dense: every step is one [N, N] distance matrix (the pairwise kernel,
    centred on the loop-invariant bcast as the JAX package orders it) and
    one [N, N] @ [N, P] weighted mean, masked to the candidate set.
    Circulant: the k neighbor distances per step come from the circulant
    kernel and the weighted mean from the circulant shifts.
    """
    iters = int(max_iters)
    if iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    nu = float(smoothing)
    if not nu > 0.0:
        raise ValueError(f"smoothing must be > 0, got {smoothing}")
    refuse_sparse_exchange("geometric_median", sparse_exchange)
    mc = None if max_candidates is None else int(max_candidates)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def self_distance(own, z):
        return torch.sqrt(torch.square((own - z).to(torch.float32)).sum(dim=-1))

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        dev = own.device
        m_cap = n if mc is None else min(mc, n)
        off_diag = 1.0 - torch.eye(n, device=dev)
        if m_cap < n:
            ci, cv = candidate_indices(adj, m_cap)  # [N, m] each
            nb_mask = torch.zeros((n, n), dtype=torch.float32, device=dev)
            nb_mask[torch.arange(n, device=dev)[:, None], ci] = cv.to(torch.float32)
            nb_mask = nb_mask * off_diag  # self handled apart
        else:
            nb_mask = adj.to(torch.float32) * off_diag
        cnt = 1.0 + nb_mask.sum(dim=1)
        own32 = own.to(torch.float32)
        bcast32 = bcast.to(torch.float32)

        def weighted_mean(w_self, w_nb):
            acc = w_self[:, None] * own32 + torch.matmul(w_nb, bcast32)
            tot = w_self + w_nb.sum(dim=1)
            return (acc / torch.clamp(tot, min=1e-30)[:, None]).to(own.dtype)

        def distances(z):
            return self_distance(own, z), pairwise_l2_distances(bcast, z).T  # [N], [N, N]

        z = weighted_mean(torch.ones(n, device=dev), nb_mask)
        for _ in range(iters):
            d_self, d_nb = distances(z)
            z = weighted_mean(
                1.0 / torch.clamp(d_self, min=nu), nb_mask / torch.clamp(d_nb, min=nu)
            )
        d_self, d_nb = distances(z)
        w_self = 1.0 / torch.clamp(d_self, min=nu)
        w_nb = nb_mask / torch.clamp(d_nb, min=nu)
        tot = torch.clamp(w_self + w_nb.sum(dim=1), min=1e-30)
        stats = {
            "num_candidates": cnt,
            "max_weight_share": torch.maximum(w_self, w_nb.max(dim=1).values) / tot,
            "mean_dist_to_gm": (d_self + (d_nb * nb_mask).sum(dim=1)) / torch.clamp(cnt, min=1.0),
        }
        return z.to(own.dtype), state, stats

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        k = len(offsets)
        dev = own.device

        def weighted_mean(w_self, w_k):
            acc = w_self[:, None] * own + circulant_weighted_sum(
                bcast, w_k, offsets, out_dtype=own.dtype
            )
            tot = w_self + w_k.sum(dim=0)
            return (acc / torch.clamp(tot, min=1e-30)[:, None]).to(own.dtype)

        def distances(z):
            return self_distance(own, z), circulant_neighbor_distances(z, bcast, offsets)

        z = weighted_mean(torch.ones(n, device=dev), torch.ones((k, n), device=dev))
        for _ in range(iters):
            d_self, d_k = distances(z)
            z = weighted_mean(1.0 / torch.clamp(d_self, min=nu), 1.0 / torch.clamp(d_k, min=nu))
        d_self, d_k = distances(z)
        w_self = 1.0 / torch.clamp(d_self, min=nu)
        w_k = 1.0 / torch.clamp(d_k, min=nu)
        tot = torch.clamp(w_self + w_k.sum(dim=0), min=1e-30)
        stats = {
            "num_candidates": torch.full((n,), float(k + 1), device=dev),
            "max_weight_share": torch.maximum(w_self, w_k.max(dim=0).values) / tot,
            "mean_dist_to_gm": (d_self + d_k.sum(dim=0)) / float(k + 1),
        }
        return z.to(own.dtype), state, stats

    return AggregatorDef(
        name="geometric_median",
        aggregate=aggregate if offsets is None else aggregate_circulant,
        quantized_exchange=offsets is not None,
        influence=InfluenceDecl(
            "unbounded",
            note="Weiszfeld weights are positive for every candidate; "
            "robustness is norm-bounded drag, not exclusion",
        ),
    )
