"""Aggregation rule interface and the shared distance/selection helpers
(the PyTorch counterpart of the parts of murmura_tpu/aggregation/base.py
that Krum uses).

A rule is one function over the whole network:

    aggregate(own[N, P], bcast[N, P], adj[N, N], round_idx, state, ctx)
        -> (new_flat[N, P], new_state, stats)

``own`` holds each node's true state, ``bcast`` the states as broadcast
(post-attack); ``stats`` are per-node tensors.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from murmura_tpu_torch.ops import agg_kernels

Stats = Dict[str, torch.Tensor]
AggState = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AggContext:
    """Per-round context handed to aggregation rules.  Krum reads none of
    the JAX package's context fields; each arrives with the rule that
    reads it."""


@dataclass(frozen=True)
class AggregatorDef:
    """A named aggregation rule with optional carried state."""

    name: str
    aggregate: Callable[..., Tuple[torch.Tensor, AggState, Stats]]
    init_state: Callable[[int], AggState] = field(default=lambda num_nodes: {})


def pairwise_l2_distances(
    a: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """L2 distance matrix D[i, j] = |a_i - b_j| through the pairwise kernel.

    The rows are centered on the mean of ``a`` first: late in training all
    nodes' vectors cluster around a common point whose norm dwarfs their
    pairwise distances, and |a|^2 + |b|^2 - 2ab would cancel
    catastrophically in float32.  Centering leaves the distances unchanged.
    The kernel takes float32, so bf16 parameters are widened here.
    """
    same = b is None
    a32 = a.to(torch.float32)
    center = a32.mean(dim=0, keepdim=True)
    a32 = (a32 - center).contiguous()
    b32 = None if same else (b.to(torch.float32) - center).contiguous()
    d2 = agg_kernels.pairwise_sq_distances(a32, b32)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def circulant_neighbor_distances(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """[k, N] distances D[o, i] = |own_i - bcast[(i + o) mod N]| through the
    circulant kernel (no Gram identity, so no centering is needed)."""
    d2 = agg_kernels.circulant_sq_distances(
        own.to(torch.float32).contiguous(),
        bcast.to(torch.float32).contiguous(),
        offsets,
    )
    return torch.sqrt(d2)


# Per-rolled-copy budget (bytes) of circulant_weighted_sum's P chunks.
_CIRCULANT_CHUNK_BYTES = 256 * 1024 * 1024


def circulant_weighted_sum(
    bcast: torch.Tensor, w_k: torch.Tensor, offsets, out_dtype=None
) -> torch.Tensor:
    """[N, P] sum_o w_k[o, i] * bcast[(i + o) mod N], accumulated at the
    promoted precision per P chunk and written in ``out_dtype``."""
    n, p = bcast.shape
    acc_dtype = torch.promote_types(bcast.dtype, w_k.dtype)
    out_dtype = acc_dtype if out_dtype is None else out_dtype
    chunk = max(1, min(p, _CIRCULANT_CHUNK_BYTES // max(1, n * max(bcast.element_size(), 4))))
    out = torch.empty((n, p), dtype=out_dtype, device=bcast.device)
    for c0 in range(0, p, chunk):
        bc = bcast[:, c0:c0 + chunk]
        acc = torch.zeros(bc.shape, dtype=acc_dtype, device=bcast.device)
        for idx, o in enumerate(offsets):
            acc = acc + w_k[idx][:, None] * torch.roll(bc, -int(o), dims=0)
        out[:, c0:c0 + chunk] = acc.to(out_dtype)
    return out


def circulant_masked_mean(
    bcast: torch.Tensor, accept_k: torch.Tensor, offsets
) -> torch.Tensor:
    """Weighted neighbor mean from per-offset acceptance ``accept_k[k, N]``."""
    cnt = accept_k.sum(dim=0)
    w_norm = accept_k / torch.clamp(cnt, min=1e-12)[None, :]
    return circulant_weighted_sum(bcast, w_norm, offsets, out_dtype=bcast.dtype)


def candidate_indices(adj: torch.Tensor, m_cap: int):
    """Per-node candidate ordering: self first, then neighbors ascending,
    non-candidates last (a stable sort), truncated at ``m_cap``.

    Returns:
        (cand_idx [N, m] int64, valid [N, m] bool).
    """
    n = adj.shape[0]
    rank = adj + 2.0 * torch.eye(n, dtype=adj.dtype, device=adj.device)
    cand_idx = torch.argsort(-rank, dim=1, stable=True)[:, :m_cap]
    valid = torch.gather(rank, 1, cand_idx) > 0.0
    return cand_idx, valid
