"""Sketchguard: Count-Sketch compressed filtering (the PyTorch counterpart
of murmura_tpu/aggregation/sketchguard.py).

The filter runs on [sketch_size] Count-Sketches of the flattened states
(the count-sketch kernel); the aggregation itself is BALANCE-style on the
full states.  The threshold is boosted 1.5x when the mean of the last 3
acceptance rates drops below 0.3; the acceptance window is the rule's
carried state.  Under ``tpu.exchange: ppermute`` the filter still runs on
the [N, N] sketch distances and only the full-state mean goes through the
circulant shifts.
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
    masked_neighbor_mean,
    pairwise_l2_distances,
    refuse_sparse_exchange,
)
from murmura_tpu_torch.ops.sketch import build_sketch_tables, count_sketch


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
    refuse_sparse_exchange("sketchguard", sparse_exchange)
    tables = build_sketch_tables(model_dim, sketch_size, network_seed)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]
    # The threshold logic reads only the last 3 rates of the window, so a
    # window under 3 disables the attack factor (the JAX package's rule).
    window = max(1, int(attack_detection_window))

    def init_state(num_nodes: int):
        return {
            "acc_window": np.zeros((num_nodes, window), dtype=np.float32),
            "window_len": np.zeros((num_nodes,), dtype=np.int32),
        }

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        n = own.shape[0]
        # Two launches, one per tensor: stacking them would copy [2N, P].
        own_sk = count_sketch(own.to(torch.float32), tables)
        bcast_sk = count_sketch(bcast.to(torch.float32), tables)
        own_sk_norm = torch.sqrt(torch.sum(own_sk * own_sk, dim=-1))

        window_active = (state["window_len"] >= 3) & (window >= 3)
        recent = state["acc_window"][:, -3:].mean(dim=1)
        attack_factor = torch.where(window_active & (recent < 0.3), 1.5, 1.0)
        tf = time_factor(round_idx, ctx.total_rounds, gamma, kappa).to(own.device)
        threshold = tf * attack_factor * own_sk_norm

        sk_dist = pairwise_l2_distances(own_sk, bcast_sk)
        accepted = accept_with_closest_fallback(sk_dist, adj, threshold, min_neighbors)
        if offsets is not None:
            # Only the k offset columns of the accepted mask can be nonzero.
            ar = torch.arange(n, device=own.device)
            cols = (ar[None, :] + torch.tensor(offsets, device=own.device)[:, None]) % n
            accept_k = accepted[ar[None, :], cols]  # [k, N]
            neighbor_avg = circulant_masked_mean(bcast, accept_k, offsets)
        else:
            neighbor_avg = masked_neighbor_mean(bcast, accepted)
        new_flat = blend_with_own(own, neighbor_avg, accepted.sum(dim=1) > 0, alpha)

        degree = torch.clamp(adj.sum(dim=1), min=1.0)
        acc_rate = accepted.sum(dim=1) / degree
        new_state = {
            "acc_window": torch.cat([state["acc_window"][:, 1:], acc_rate[:, None]], dim=1),
            "window_len": torch.clamp(state["window_len"] + 1, max=window),
        }
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
        influence=InfluenceDecl(
            "unbounded",
            note="sketch-space distance accept-filter: benign inputs "
            "accept every neighbor; exclusion is data-dependent",
        ),
    )
