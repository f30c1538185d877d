"""Multi-Krum selection (the PyTorch counterpart of
murmura_tpu/aggregation/krum.py).

Per node i over candidates {i} ∪ N(i) (m = 1 + degree, c expected
Byzantine): Krum requires c < (m-2)/2, else the node keeps its own state;
score(j) = sum of the (m - c - 2) smallest distances from j to the other
candidates; the winner is the argmin score.  Candidate i in node i's view
is its *own* true state, so distances involving the self candidate come
from the own-to-broadcast distances.

Dense path (``aggregate``): two [N, N] distance matrices from the pairwise
kernel, (bcast, bcast) and (own, bcast), and a [N, m, m] candidate block per
node.  Circulant path (``aggregate_circulant``, ``tpu.exchange:
ppermute``): every candidate-pair distance is an entry of a rolled "delta
vector" B_d[j] = |bcast_j - bcast_{j+d}|, so the circulant kernel computes
|own_i - bcast_{i+o}| for the k offsets and B_d for the distinct offset
differences d, and the [m, m, N] pair distances are assembled from [N]
rolls.
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    candidate_indices,
    circulant_masked_mean,
    circulant_neighbor_distances,
    pairwise_l2_distances,
    refuse_sparse_exchange,
)
from murmura_tpu_torch.ops.agg_kernels import _offsets_on


def make_krum(
    num_compromised: int = 0,
    max_candidates: int = None,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    c = int(num_compromised)
    mc = None if max_candidates is None else int(max_candidates)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]
    refuse_sparse_exchange("krum", sparse_exchange)

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        k = len(offsets)
        m = k + 1  # self + full circulant degree at every node
        ok = c < (m - 2) / 2  # static on a degree-regular graph

        own_d = circulant_neighbor_distances(own, bcast, offsets)  # [k, N]
        deltas = sorted(
            {abs(o2 - o1) for o1 in offsets for o2 in offsets if o1 != o2}
        )
        if deltas:
            bcast_d = circulant_neighbor_distances(bcast, bcast, deltas)  # [D, N]
        didx = {d: i for i, d in enumerate(deltas)}

        rows = []
        for a in range(m):
            cols = []
            for b in range(m):
                if a == b:
                    cols.append(torch.full((n,), float("inf"), dtype=own_d.dtype, device=own_d.device))
                elif a == 0 or b == 0:
                    cols.append(own_d[max(a, b) - 1])
                else:
                    o_a, o_b = offsets[a - 1], offsets[b - 1]
                    v = bcast_d[didx[abs(o_b - o_a)]]
                    cols.append(torch.roll(v, -min(o_a, o_b)))
            rows.append(torch.stack(cols))
        pair = torch.stack(rows)  # [m, m, N]

        num_closest = max(1, m - c - 2)
        ranked = torch.sort(pair, dim=1).values
        scores = ranked[:, :num_closest, :].sum(dim=1)  # [m, N]
        best = scores.min(dim=0).values
        w = torch.argmin(scores, dim=0)
        if not ok:
            w = torch.zeros_like(w)  # every node keeps its own state
        ar = torch.arange(1, m, device=own.device)
        accept_k = (w[None, :] == ar[:, None]).to(own.dtype)
        neighbor_sel = circulant_masked_mean(bcast, accept_k, offsets, out_dtype=own.dtype)
        selected_own = w == 0
        new_flat = torch.where(selected_own[:, None], own, neighbor_sel)
        stats = {
            "selected_index": (torch.arange(n, device=own.device)
                               + _offsets_on(tuple([0] + offsets), own.device)[w]) % n,
            "krum_score": best,
            "selected_own": selected_own.to(torch.float32),
        }
        if ctx.audit:
            # Sender-side taps: accept_k[o_idx, i] says receiver i selected
            # sender (i + o) % n, so selected_by[s] = sum_o accept_k[o_idx,
            # (s - o) % n]; every sender is considered by its k receivers.
            stats["tap_selected_by"] = sum(
                torch.roll(accept_k[i].to(torch.float32), o) for i, o in enumerate(offsets)
            )
            stats["tap_considered_by"] = torch.full((n,), float(k), device=own.device)
        return new_flat, state, stats

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        dev = own.device
        m_cap = n if mc is None else min(mc, n)
        d_bcast = pairwise_l2_distances(bcast)
        d_own = pairwise_l2_distances(own, bcast)  # [i, j] = |own_i - bcast_j|

        cand_idx, valid = candidate_indices(adj, m_cap)  # [N, m] each
        node = torch.arange(n, device=dev)
        # [N, m, m] candidate-pair distances; entries involving the self
        # candidate use the own-state distance row.
        d = d_bcast[cand_idx[:, :, None], cand_idx[:, None, :]]
        own_d = torch.gather(d_own, 1, cand_idx)  # [N, m]
        is_self = cand_idx == node[:, None]
        d = torch.where(is_self[:, :, None], own_d[:, None, :], d)
        d = torch.where(is_self[:, None, :], own_d[:, :, None], d)

        m_i = valid.sum(dim=1)  # [N]
        num_closest = torch.clamp(m_i - c - 2, min=1)
        eye = torch.eye(m_cap, dtype=torch.bool, device=dev)
        pair_valid = valid[:, None, :] & valid[:, :, None] & ~eye
        masked = torch.where(pair_valid, d, torch.full_like(d, float("inf")))
        ranked = torch.sort(masked, dim=-1).values
        take = torch.arange(m_cap, device=dev)[None, None, :] < num_closest[:, None, None]
        scores = torch.where(
            take & torch.isfinite(ranked), ranked, torch.zeros_like(ranked)
        ).sum(dim=-1)  # [N, m]
        scores = torch.where(valid, scores, torch.full_like(scores, float("inf")))
        w = torch.argmin(scores, dim=1)
        best = torch.gather(scores, 1, w[:, None])[:, 0]
        ok = c < (m_i - 2) / 2  # Krum constraint
        winners = torch.where(ok, torch.gather(cand_idx, 1, w[:, None])[:, 0], node)

        # Row selection stays a gather: a one-hot product would spread one
        # non-finite Byzantine row to every node (0 * inf = nan).
        selected_own = winners == node
        new_flat = torch.where(selected_own[:, None], own, bcast[winners])
        stats = {
            "selected_index": winners,
            "krum_score": best,
            "selected_own": selected_own.to(torch.float32),
        }
        if ctx.audit:
            # Sender-side taps: how many peers picked node s's broadcast as
            # their winner (self-selections excluded), and how many had it
            # as a candidate (its in-degree under the round's adjacency).
            picked = (winners[:, None] == node[None, :]) & ~selected_own[:, None]
            stats["tap_selected_by"] = picked.to(torch.float32).sum(dim=0)
            stats["tap_considered_by"] = adj.to(torch.float32).sum(dim=0)
        return new_flat, state, stats

    return AggregatorDef(
        name="krum",
        aggregate=aggregate if offsets is None else aggregate_circulant,
        quantized_exchange=offsets is not None,
        influence=InfluenceDecl(
            "bounded",
            bound=lambda k: 1,
            note="single Krum winner: at most one neighbor's state is "
            "ever adopted; scores only decide which",
        ),
    )
