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
rolls.  Under the sparse exchange ``adj`` is the [k, N] edge mask: the
candidate count m_i, the trim depth and the constraint c < (m_i - 2)/2
become per node, and an all-ones mask gives the static path bit for bit.

Under a node scope (parallel/mesh.py) the rule serves its block's R
receivers: dense, the [N, N] of (bcast, bcast) is gathered from the ranks'
[R, N] row blocks and (own, bcast) is the block's [R, N]; circulant, the
pair distances are the window's rows d apart (``window_delta_distances``)
at the window positions of the offsets, sliced where one process rolls.
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    candidate_indices,
    circulant_in_degree,
    circulant_masked_mean,
    circulant_neighbor_distances,
    circulant_sender_sum,
    exchange_offsets_of,
    pairwise_l2_distances,
    receiver_ids,
    window_delta_distances,
)
from murmura_tpu_torch.ops.agg_kernels import _offsets_on
from murmura_tpu_torch.parallel.mesh import active_node_group, sender_total_


def make_krum(
    num_compromised: int = 0,
    max_candidates: int = None,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    c = int(num_compromised)
    mc = None if max_candidates is None else int(max_candidates)
    offsets = exchange_offsets_of(exchange_offsets, sparse_exchange)

    def aggregate_circulant(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        k = len(offsets)
        m = k + 1  # self + full circulant degree at every node
        ok = c < (m - 2) / 2  # static on a degree-regular graph

        own_d = circulant_neighbor_distances(own, bcast, offsets)  # [k, N]
        group = active_node_group()
        # Where each offset's sender lies: the offset (rolls of the whole
        # bcast), or its window row under a node scope (slices).
        pos = offsets if group is None else group.positions(offsets)
        deltas = sorted(
            {abs(o2 - o1) for o1 in pos for o2 in pos if o1 != o2}
        )
        if deltas and group is None:
            bcast_d = circulant_neighbor_distances(bcast, bcast, deltas)  # [D, N]
        elif deltas:
            bcast_d = window_delta_distances(bcast, deltas)  # D of [W - d]
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
                    o_a, o_b = pos[a - 1], pos[b - 1]
                    v = bcast_d[didx[abs(o_b - o_a)]]
                    lo = min(o_a, o_b)
                    cols.append(torch.roll(v, -lo) if group is None else v[lo:lo + n])
            rows.append(torch.stack(cols))
        pair = torch.stack(rows)  # [m, m, N]

        if sparse_exchange:
            # Self is always a candidate; the mask's rows are the others.
            valid = torch.cat([torch.ones((1, n), dtype=adj.dtype, device=adj.device),
                               adj], dim=0) > 0  # [m, N]
            m_i = valid.sum(dim=0)  # [N]
            pair_valid = valid[:, None, :] & valid[None, :, :]
            masked = torch.where(pair_valid, pair, torch.full_like(pair, float("inf")))
            num_closest = torch.clamp(m_i - c - 2, min=1)
            ranked = torch.sort(masked, dim=1).values
            take = (torch.arange(m, device=own.device)[None, :, None]
                    < num_closest[None, None, :])
            scores = torch.where(take & torch.isfinite(ranked), ranked,
                                 torch.zeros_like(ranked)).sum(dim=1)  # [m, N]
            scores = torch.where(valid, scores, torch.full_like(scores, float("inf")))
            w = torch.argmin(scores, dim=0)
            best = scores.min(dim=0).values
            # Too few candidates for the constraint: the node keeps its own.
            w = torch.where(c < (m_i - 2) / 2, w, torch.zeros_like(w))
        else:
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
        n_all = n if group is None else group.num_nodes
        stats = {
            "selected_index": (receiver_ids(n, own.device)
                               + _offsets_on(tuple([0] + offsets), own.device)[w]) % n_all,
            "krum_score": best,
            "selected_own": selected_own.to(torch.float32),
        }
        if ctx.audit:
            # Sender-side taps: accept_k[o_idx, i] says receiver i selected
            # sender (i + o) % n, so selected_by[s] = sum_o accept_k[o_idx,
            # (s - o) % n]; every sender is considered by its k receivers.
            stats["tap_selected_by"] = circulant_sender_sum(accept_k, offsets)
            stats["tap_considered_by"] = (
                circulant_in_degree(adj, offsets) if sparse_exchange
                else torch.full((n_all,), float(k), device=own.device))
        return new_flat, state, stats

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n_all = bcast.shape[0]  # the network's N (own's rows: a node block's)
        dev = own.device
        m_cap = n_all if mc is None else min(mc, n_all)
        d_bcast = pairwise_l2_distances(bcast)
        d_own = pairwise_l2_distances(own, bcast)  # [i, j] = |own_i - bcast_j|

        cand_idx, valid = candidate_indices(adj, m_cap)  # [N, m] each
        node = receiver_ids(own.shape[0], dev)
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
            senders = torch.arange(n_all, device=dev)
            picked = (winners[:, None] == senders[None, :]) & ~selected_own[:, None]
            stats["tap_selected_by"] = sender_total_(picked.to(torch.float32).sum(dim=0))
            stats["tap_considered_by"] = sender_total_(adj.to(torch.float32).sum(dim=0))
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
