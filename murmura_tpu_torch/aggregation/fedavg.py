"""FedAvg: equal-weight mean of own + neighbor states (the PyTorch
counterpart of murmura_tpu/aggregation/fedavg.py).

Dense: one adjacency product over the broadcast, normalised by 1 + degree.
Circulant (``tpu.exchange: ppermute``): the product is a sum of fixed
circular shifts (``circulant_weighted_sum``).  Neither needs a kernel of
its own: the JAX package computes both outside Pallas.
"""

from typing import Optional, Sequence

import torch

from murmura_tpu_torch.aggregation.base import (
    AggContext,
    AggregatorDef,
    InfluenceDecl,
    circulant_weighted_sum,
    refuse_sparse_exchange,
)


def make_fedavg(
    exchange_offsets: Optional[Sequence[int]] = None,
    sparse_exchange: bool = False,
    **_params,
) -> AggregatorDef:
    refuse_sparse_exchange("fedavg", sparse_exchange)
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]

    def aggregate(own, bcast, adj, round_idx, state, ctx: AggContext):
        degree = adj.sum(dim=1)
        if offsets is not None:
            w_k = torch.ones((len(offsets), own.shape[0]), dtype=torch.float32, device=own.device)
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
