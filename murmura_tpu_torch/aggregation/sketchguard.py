"""Sketchguard: Count-Sketch compressed filtering (the PyTorch counterpart
of murmura_tpu/aggregation/sketchguard.py).

The filter runs on [sketch_size] Count-Sketches of the flattened states
(the count-sketch kernel); the aggregation itself is BALANCE-style on the
full states.  The threshold is boosted 1.5x when the mean of the last 3
acceptance rates drops below 0.3; the acceptance window is the rule's
carried state.  Under ``tpu.exchange: ppermute`` the filter still runs on
the [N, N] sketch distances and only the full-state mean goes through the
circulant shifts; under the sparse exchange the filter too runs on the
circulant [k, N] sketch distances (the circulant kernel), gated by the
edge mask, so nothing [N, N] is built.

Under a param group each rank sketches its column block with the tables'
columns of that block and the [N, S] partials are summed over the group
(the same sum in another order); the sketch distances then run on whole,
replicated sketches and are not summed again (``replicated=True``).

Under a node scope (parallel/mesh.py) each rank sketches its own rows and
its own broadcast rows, and the [R, S] broadcast sketches are gathered into
the [N, S] the filter compares (the sparse filter reads the window's rows
of them); the acceptance window stays whole on every rank, each rank's
new rates gathered into it.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from murmura_tpu_torch.aggregation.balance import accept_with_closest_fallback, time_factor
from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    blend_with_own,
    circulant_masked_mean,
    circulant_neighbor_distances,
    exchange_offsets_of,
    masked_neighbor_mean,
    own_broadcast_rows,
    pairwise_l2_distances,
    receiver_ids,
    window_of,
)
from murmura_tpu_torch.ops.sketch import build_sketch_tables, count_sketch
from murmura_tpu_torch.ops.sketch_kernels import SketchTables
from murmura_tpu_torch.parallel.mesh import (
    active_param_group,
    node_rows,
    reduce_partial_,
    whole_rows,
)


def make_sketchguard(
    model_dim: int,
    sketch_size: int = 1000,
    gamma: float = 2.0,
    kappa: float = 1.0,
    alpha: float = 0.5,
    min_neighbors: int = 1,
    network_seed: int = 42,
    attack_detection_window: int = 5,
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    tables = build_sketch_tables(model_dim, sketch_size, network_seed)
    offsets = exchange_offsets_of(exchange_offsets, sparse_exchange)
    # The threshold logic reads only the last 3 rates of the window, so a
    # window under 3 disables the attack factor (the JAX package's rule).
    window = max(1, int(attack_detection_window))
    block_tables = {}

    def local_tables() -> SketchTables:
        """The tables of the active group's column block (all of them off
        a group), built once a block."""
        group = active_param_group()
        if group is None:
            return tables
        c0, c1 = group.cols
        if (c0, c1) not in block_tables:
            block_tables[(c0, c1)] = SketchTables(tables.hash[c0:c1], tables.sign[c0:c1],
                                                  sketch_size)
        return block_tables[(c0, c1)]

    def sketch(x):
        return reduce_partial_(count_sketch(x.to(torch.float32), local_tables()))

    def init_state(num_nodes: int):
        return {
            "acc_window": np.zeros((num_nodes, window), dtype=np.float32),
            "window_len": np.zeros((num_nodes,), dtype=np.int32),
        }

    def window_state(state, acc_rate):
        acc_rate = whole_rows(acc_rate)
        return {
            "acc_window": torch.cat([state["acc_window"][:, 1:], acc_rate[:, None]], dim=1),
            "window_len": torch.clamp(state["window_len"] + 1, max=window),
        }

    def sparse_filter(own, bcast, adj, own_sk, bcast_sk, threshold, state):
        """The sparse exchange's filter, in circulant sketch space: [k, N]
        per-offset sketch distances by the circulant kernel instead of the
        [N, N] pairwise matrix, the [k, N] edge mask gating acceptance, the
        closest-neighbour fallback and the degree."""
        n = own.shape[0]
        edge_b = adj > 0
        d_k = circulant_neighbor_distances(own_sk, window_of(bcast_sk), offsets,
                                           replicated=True)  # [k, N]
        accept_b = edge_b & (d_k <= threshold[None, :])
        count = accept_b.sum(dim=0)
        closest = torch.argmin(
            torch.where(edge_b, d_k, torch.full_like(d_k, float("inf"))), dim=0)
        ar = torch.arange(len(offsets), device=own.device)
        fallback = (((count < min_neighbors) & edge_b.any(dim=0))[None, :]
                    & (ar[:, None] == closest[None, :]) & edge_b)
        accept_k = (accept_b | fallback).to(own.dtype)
        neighbor_avg = circulant_masked_mean(bcast, accept_k, offsets)
        new_flat = blend_with_own(own, neighbor_avg, accept_k.sum(dim=0) > 0, alpha)
        acc_rate = accept_k.sum(dim=0) / torch.clamp(adj.sum(dim=0), min=1.0)
        stats = {
            "acceptance_rate": acc_rate,
            "threshold": threshold,
            "compression_ratio": torch.full(
                (n,), model_dim / sketch_size, dtype=own.dtype, device=own.device
            ),
        }
        return new_flat, window_state(state, acc_rate), stats

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        # Two launches, one per tensor: stacking them would copy [2N, P].
        own_sk = sketch(own)
        bcast_sk = whole_rows(sketch(own_broadcast_rows(bcast)))
        own_sk_norm = torch.sqrt(torch.sum(own_sk * own_sk, dim=-1))

        window_active = (node_rows(state["window_len"]) >= 3) & (window >= 3)
        recent = node_rows(state["acc_window"])[:, -3:].mean(dim=1)
        attack_factor = torch.where(window_active & (recent < 0.3), 1.5, 1.0)
        tf = time_factor(round_idx, ctx.total_rounds, gamma, kappa).to(own.device)
        threshold = tf * attack_factor * own_sk_norm

        if sparse_exchange:
            return sparse_filter(own, bcast, adj, own_sk, bcast_sk, threshold, state)
        sk_dist = pairwise_l2_distances(own_sk, bcast_sk, replicated=True)
        accepted = accept_with_closest_fallback(sk_dist, adj, threshold, min_neighbors)
        if offsets is not None:
            # Only the k offset columns of the accepted mask can be nonzero.
            ar = torch.arange(n, device=own.device)
            ids = receiver_ids(n, own.device)
            cols = ((ids[None, :] + torch.tensor(offsets, device=own.device)[:, None])
                    % bcast_sk.shape[0])
            accept_k = accepted[ar[None, :], cols]  # [k, N]
            neighbor_avg = circulant_masked_mean(bcast, accept_k, offsets)
        else:
            neighbor_avg = masked_neighbor_mean(bcast, accepted)
        new_flat = blend_with_own(own, neighbor_avg, accepted.sum(dim=1) > 0, alpha)

        degree = torch.clamp(adj.sum(dim=1), min=1.0)
        acc_rate = accepted.sum(dim=1) / degree
        new_state = window_state(state, acc_rate)
        stats = {
            "acceptance_rate": acc_rate,
            "threshold": threshold,
            "compression_ratio": torch.full(
                (n,), model_dim / sketch_size, dtype=own.dtype, device=own.device
            ),
        }
        return new_flat, new_state, stats

    return AggregatorDef(
        name="sketchguard", aggregate=aggregate, init_state=init_state,
        state_kind={"acc_window": "node", "window_len": "node"},
        influence=InfluenceDecl(
            "unbounded",
            note="sketch-space distance accept-filter: benign inputs "
            "accept every neighbor; exclusion is data-dependent",
        ),
    )
