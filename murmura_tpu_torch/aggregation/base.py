"""Aggregation rule interface and the shared distance/selection helpers
(the PyTorch counterpart of the parts of murmura_tpu/aggregation/base.py
that the ported rules use).

A rule is one function over the whole network:

    aggregate(own[N, P], bcast[N, P], adj[N, N], round_idx, state, ctx)
        -> (new_flat[N, P], new_state, stats)

``own`` holds each node's true state, ``bcast`` the states as broadcast
(post-attack); ``stats`` are per-node tensors.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from murmura_tpu_torch.ops import agg_kernels

Stats = Dict[str, torch.Tensor]
AggState = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AggContext:
    """Per-round context handed to aggregation rules.  Only the fields a
    ported rule reads are here; the others arrive with their levers.

    Attributes:
        apply_fn: single-model forward in eval mode, (params, x) -> outputs.
        unravel: flat [..., P] -> params pytree (views).
        probe_x/probe_y/probe_mask: per-node probe batches [N, B, ...] that
            the loss-probe rules (UBAR's stage 2) evaluate models on.
        evidential: whether ``apply_fn`` outputs Dirichlet alphas.
        num_classes: output arity.
        total_rounds: T of the threshold schedules (BALANCE, Sketchguard).
    """

    apply_fn: Optional[Callable] = None
    unravel: Optional[Callable] = None
    probe_x: Optional[torch.Tensor] = None
    probe_y: Optional[torch.Tensor] = None
    probe_mask: Optional[torch.Tensor] = None
    evidential: bool = False
    num_classes: int = 0
    total_rounds: int = 1


@dataclass(frozen=True)
class AggregatorDef:
    """A named aggregation rule with optional carried state."""

    name: str
    aggregate: Callable[..., Tuple[torch.Tensor, AggState, Stats]]
    init_state: Callable[[int], AggState] = field(default=lambda num_nodes: {})
    # Under an int8 compressed exchange the rule receives the broadcast as
    # float32 dequantized values (the circulant rules, whose JAX twins read
    # the int8 payload through ``dequantize_f32``); its output stays in the
    # dtype of ``own``.
    quantized_exchange: bool = False


def refuse_sparse_exchange(rule: str, sparse_exchange: bool) -> None:
    """The sparse [k, N] edge-mask exchange is not ported: a rule built
    with it raises instead of running another exchange."""
    if sparse_exchange:
        raise ValueError(
            f"{rule}'s sparse [k, N] edge-mask exchange is not ported to the "
            "PyTorch package yet"
        )


def pairwise_l2_distances(
    a: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """L2 distance matrix D[i, j] = |a_i - b_j| through the pairwise kernel.

    The rows are centered on the mean of ``a`` first: late in training all
    nodes' vectors cluster around a common point whose norm dwarfs their
    pairwise distances, and |a|^2 + |b|^2 - 2ab would cancel
    catastrophically in float32.  Centering leaves the distances unchanged.
    The kernel subtracts the center row as it loads the values, so no
    centered copy of ``a`` or ``b`` is made.  The kernel takes float32, so
    bf16 parameters are widened here.
    """
    a32 = a.to(torch.float32).contiguous()
    b32 = None if b is None else b.to(torch.float32).contiguous()
    d2 = agg_kernels.pairwise_sq_distances(a32, b32, center=a32.mean(dim=0))
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


# Per-rolled-copy budget (bytes) of the circulant helpers' P chunks.
_CIRCULANT_CHUNK_BYTES = 256 * 1024 * 1024


def _p_chunk_len(n: int, p: int, itemsize: int) -> int:
    """Chunk length along P so that one [n, chunk] copy stays in budget,
    sized as float32 at least (every chunk is accumulated in float32)."""
    return max(1, min(p, _CIRCULANT_CHUNK_BYTES // max(1, n * max(itemsize, 4))))


def circulant_weighted_sum(
    bcast: torch.Tensor, w_k: torch.Tensor, offsets, out_dtype=None
) -> torch.Tensor:
    """[N, P] sum_o w_k[o, i] * bcast[(i + o) mod N], accumulated at the
    promoted precision per P chunk and written in ``out_dtype``."""
    n, p = bcast.shape
    acc_dtype = torch.promote_types(bcast.dtype, w_k.dtype)
    out_dtype = acc_dtype if out_dtype is None else out_dtype
    chunk = _p_chunk_len(n, p, bcast.element_size())
    out = torch.empty((n, p), dtype=out_dtype, device=bcast.device)
    for c0 in range(0, p, chunk):
        bc = bcast[:, c0:c0 + chunk]
        acc = torch.zeros(bc.shape, dtype=acc_dtype, device=bcast.device)
        for idx, o in enumerate(offsets):
            acc = acc + w_k[idx][:, None] * torch.roll(bc, -int(o), dims=0)
        out[:, c0:c0 + chunk] = acc.to(out_dtype)
    return out


def circulant_masked_mean(
    bcast: torch.Tensor, accept_k: torch.Tensor, offsets, out_dtype=None
) -> torch.Tensor:
    """Weighted neighbor mean from per-offset acceptance ``accept_k[k, N]``,
    written in ``out_dtype`` (default: bcast's)."""
    cnt = accept_k.sum(dim=0)
    w_norm = accept_k / torch.clamp(cnt, min=1e-12)[None, :]
    out_dtype = bcast.dtype if out_dtype is None else out_dtype
    return circulant_weighted_sum(bcast, w_norm, offsets, out_dtype=out_dtype)


def candidate_chunk_dispatch(own, bcast, chunk_apply, stack_height: int) -> torch.Tensor:
    """Apply the coordinate-wise ``chunk_apply(own_chunk, bcast_chunk) ->
    [N, c]`` over P chunks whose budget is scaled by ``stack_height`` (the
    [N, c] copies the candidate stack holds per chunk); a small N*P runs in
    one chunk.  The output takes the dtype of the first chunk's result."""
    n, p = bcast.shape
    chunk = _p_chunk_len(n * stack_height, p, bcast.element_size())
    if chunk >= p:
        return chunk_apply(own, bcast)
    out = None
    for c0 in range(0, p, chunk):
        res = chunk_apply(own[:, c0:c0 + chunk], bcast[:, c0:c0 + chunk])
        if out is None:
            out = torch.empty((n, p), dtype=res.dtype, device=bcast.device)
        out[:, c0:c0 + chunk] = res
    return out


def circulant_candidate_map(own, bcast, offsets, fn) -> torch.Tensor:
    """``fn`` over the circulant candidate stack [m, N, c] (own, then
    bcast[(i + o) mod N] for each offset), P-chunked by the stack height m
    so that no [m, N, P] tensor exists at full size.  ``fn`` maps the stack
    to [N, c] and must be coordinate-wise along the last axis."""

    def chunk_apply(oc, bc):
        return fn(torch.stack([oc] + [torch.roll(bc, -int(o), dims=0) for o in offsets]))

    return candidate_chunk_dispatch(own, bcast, chunk_apply, len(offsets) + 1)


def masked_neighbor_mean(bcast: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted neighbor mean per node, (W @ bcast) / row sum, safe on empty
    rows and returned in bcast's dtype.  The weights are cast to bcast's
    dtype first and the row totals are summed (in float32) from the same
    cast weights as the product, so a bf16 numerator is never normalised by
    an unquantised total.  The product accumulates in float32: the operands
    are widened, which is exact."""
    w = weights.to(bcast.dtype)
    totals = w.sum(dim=1, keepdim=True, dtype=torch.float32)
    acc = torch.matmul(w.to(torch.float32), bcast.to(torch.float32))
    return (acc / torch.clamp(totals, min=1e-12)).to(bcast.dtype)


def blend_with_own(
    own: torch.Tensor, neighbor_avg: torch.Tensor, has_neighbors: torch.Tensor, alpha: float
) -> torch.Tensor:
    """alpha*own + (1-alpha)*neighbor_avg where any neighbor was accepted,
    else own (the BALANCE/Sketchguard output form)."""
    blended = alpha * own + (1.0 - alpha) * neighbor_avg
    return torch.where(has_neighbors[:, None], blended, own)


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


def rank_mask(values: torch.Tensor, valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the ``k`` smallest valid entries of each row
    (``values`` [..., M], ``valid`` [..., M], ``k`` [...]).  Both argsorts
    are stable, as JAX's are: invalid entries are all +inf and colluding
    senders broadcast equal rows, so ties are common and must rank by
    position."""
    masked = torch.where(valid, values, torch.full_like(values, float("inf")))
    order = torch.argsort(masked, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return valid & (ranks < k[..., None])


@torch.no_grad()
def self_probe_metrics(
    own: torch.Tensor, ctx: AggContext, metric_fn: Callable
) -> Dict[str, Any]:
    """Each node's own state on its own probe batch (the diagonal of the
    cross-evaluation), vmapped over the nodes: dict of [N] metrics."""

    def one(params_i, x_i, y_i, m_i):
        return metric_fn(ctx.apply_fn(params_i, x_i), y_i, m_i)

    return vmap(one)(ctx.unravel(own), ctx.probe_x, ctx.probe_y, ctx.probe_mask)
