"""FedAvg: equal-weight mean of own + neighbor states (the PyTorch
counterpart of murmura_tpu/aggregation/fedavg.py).

Dense: one adjacency product over the broadcast, normalised by 1 + degree.
Circulant (``tpu.exchange: ppermute``): the product is a sum of fixed
circular shifts (``circulant_weighted_sum``), each weighed by its row of
the [k, N] edge mask under the sparse exchange.  Neither needs a kernel of
its own: the JAX package computes both outside Pallas.  Under a node scope
(parallel/mesh.py) the same code serves a block's receivers: the [R, N]
adjacency rows over the whole broadcast, or the [k, R] weights over its
window.
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    circulant_weighted_sum,
    exchange_offsets_of,
)


def make_fedavg(
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    offsets = exchange_offsets_of(exchange_offsets, sparse_exchange)

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        # The [k, N] edge mask's columns are the receivers.
        degree = adj.sum(dim=0) if sparse_exchange else adj.sum(dim=1)
        if offsets is not None:
            if sparse_exchange:
                w_k = adj.to(torch.float32)
            else:
                w_k = torch.ones((len(offsets), own.shape[0]), dtype=torch.float32,
                                 device=own.device)
            neighbor_sum = circulant_weighted_sum(bcast, w_k, offsets, out_dtype=own.dtype)
        else:
            # float32 accumulation over the stored operands (widening is exact).
            neighbor_sum = torch.matmul(
                adj.to(bcast.dtype).to(torch.float32), bcast.to(torch.float32)
            )
        new_flat = ((own + neighbor_sum) / (1.0 + degree)[:, None]).to(own.dtype)
        return new_flat, state, {"num_neighbors": degree}

    return AggregatorDef(
        name="fedavg", aggregate=aggregate, quantized_exchange=offsets is not None,
        influence=InfluenceDecl(
            "unbounded",
            note="every neighbor's state enters the degree-normalized "
            "mean; a single Byzantine row moves it arbitrarily",
        ),
    )
