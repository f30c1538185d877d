"""Aggregation rule interface and the shared distance/selection helpers
(the PyTorch counterpart of the parts of murmura_tpu/aggregation/base.py
that the ported rules use).

A rule is one function over the whole network:

    aggregate(own[N, P], bcast[N, P], adj[N, N], round_idx, state, ctx)
        -> (new_flat[N, P], new_state, stats)

``own`` holds each node's true state, ``bcast`` the states as broadcast
(post-attack); ``stats`` are per-node tensors.  A rule built with
``sparse_exchange`` (a sparse topology's offsets as ``exchange_offsets``)
takes the [k, N] edge mask as ``adj``: ``adj[j, i]`` is the edge ``i <- (i
+ offsets[j]) % N``, and its circulant path weighs or masks each offset's
candidates by it.

Under a param group (parallel/mesh.py) a rule runs on its rank's column
block of ``own`` and ``bcast``: the distance helpers and :func:`row_norms`
sum their partials over the group before the square root, the probe
forwards (:func:`self_probe_metrics`, aggregation/probe.py) turn the
rank's own rows back whole and gather their metrics, and everything else
a rule does is column-local or works on those replicated results.

Under a node group's scope (``node_block_scope``, parallel/mesh.py) a rule
runs for its rank's block of R receivers: ``own`` is the block's [R, P]
rows; ``bcast`` the whole [N, P] (the dense exchange's all_gather) or, on
a circulant path, the block's window of [R + high - low, P] sender rows;
``adj`` the adjacency's [R, N] rows, or the [k, R] columns of a sparse
edge mask.  The helpers below take those operands as they come (each
docstring says how) and return the block's rows; the per-node stats a rule
returns are the block's, which the round gathers, and a sender-side count
is summed over the group (:func:`sender_total_`).  Off both scopes every
hook is the identity.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from murmura_tpu_torch.ops import agg_kernels
from murmura_tpu_torch.parallel.mesh import (
    active_node_group,
    active_param_group,
    all_reduce_sum_,
    columns_to_rows,
    gather_rows,
    node_rows,
    reduce_partial_,
    sender_total_,
)

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
        audit: telemetry.audit_taps — the tapping rules (Krum, BALANCE,
            UBAR, evidential trust) add per-node ``tap_*`` decision tensors
            to their stats; nothing else in the round changes.
        probe_cross: the round's [N, N] probe cross-evaluation
            (``probe.combined_probe_metric``, entry [i, j] model j on node
            i's probe batch) when a DMTT round has already computed it; the
            dense probe rules read it instead of evaluating again.
    """

    apply_fn: Optional[Callable] = None
    unravel: Optional[Callable] = None
    probe_x: Optional[torch.Tensor] = None
    probe_y: Optional[torch.Tensor] = None
    probe_mask: Optional[torch.Tensor] = None
    evidential: bool = False
    num_classes: int = 0
    total_rounds: int = 1
    audit: bool = False
    probe_cross: Optional[Dict[str, torch.Tensor]] = None


# Copy of InfluenceDecl from murmura_tpu/aggregation/base.py.
@dataclass(frozen=True)
class InfluenceDecl:
    """A rule's declared Byzantine influence contract: how many distinct
    neighbours' broadcast values can enter one output coordinate.

    ``kind="bounded"`` declares a cap, ``bound(k)`` for a node with k
    neighbours (Krum's single winner: 1; the coordinate median's middle
    pair; the trimmed mean's kept interior).  ``kind="unbounded"`` admits
    that every neighbour's value can reach the output, or that the cap is
    data-dependent and vanishes on benign inputs; ``note`` says why.  The
    report prints it next to the observed audit-tap rejection counts.
    """

    kind: str  # "bounded" | "unbounded"
    bound: Optional[Callable[[int], int]] = None
    note: str = ""

    def __post_init__(self):
        if self.kind not in ("bounded", "unbounded"):
            raise ValueError(
                f"influence kind must be 'bounded' or 'unbounded', got {self.kind!r}"
            )
        if self.kind == "bounded" and self.bound is None:
            raise ValueError("bounded influence declarations need a bound()")
        if self.kind == "unbounded" and self.bound is not None:
            raise ValueError("unbounded influence declarations must not carry a bound()")

    def describe(self, k: Optional[int] = None) -> str:
        """Human-readable contract line (the report's rendering)."""
        if self.kind == "unbounded":
            base = "unbounded"
        elif k is None:
            base = "bounded"
        else:
            base = f"bounded: <= {self.bound(k)} of {k} neighbors per coordinate"
        return f"{base} — {self.note}" if self.note else base


@dataclass(frozen=True)
class AggregatorDef:
    """A named aggregation rule with optional carried state.

    ``state_kind`` maps each carried-state key to its indexing scheme:
    'node' = leading axis is the node id (e.g. acceptance windows), 'edge' =
    [N, N] directed-edge matrix (e.g. smoothed trust).  The ZMQ backend
    (distributed/local.py) uses it to project the stacked state onto one
    process's view."""

    name: str
    aggregate: Callable[..., Tuple[torch.Tensor, AggState, Stats]]
    init_state: Callable[[int], AggState] = field(default=lambda num_nodes: {})
    state_kind: Dict[str, str] = field(default_factory=dict)
    # Under an int8 compressed exchange the rule receives the broadcast as
    # float32 dequantized values (the circulant rules, whose JAX twins read
    # the int8 payload through ``dequantize_f32``); its output stays in the
    # dtype of ``own``.
    quantized_exchange: bool = False
    influence: Optional[InfluenceDecl] = None
    # The circulant offsets the rule reads its senders at (ppermute or the
    # sparse exchange), () on the dense path: a node group's exchange is
    # the window of these offsets (parallel/mesh.py).
    exchange_offsets: Tuple[int, ...] = ()


def exchange_offsets_of(exchange_offsets, sparse_exchange: bool):
    """The rule's circulant offsets as ints (None: the dense path); the
    sparse edge-mask exchange runs on the circulant path, so it needs them."""
    offsets = None if exchange_offsets is None else [int(o) for o in exchange_offsets]
    if sparse_exchange and offsets is None:
        raise ValueError("sparse_exchange requires exchange_offsets")
    return offsets


def circulant_sender_sum(v_k: torch.Tensor, offsets) -> torch.Tensor:
    """[N] per-sender sums of a [k, N] per-receiver tensor, by rolls:
    ``v_k[j, i]`` belongs to receiver i's sender (i + offsets[j]) % N, so
    sender s collects v_k[j, (s - o) % N].  Under a node scope ``v_k`` is
    the block's [k, R] columns: each is added at its sender, and the [N]
    partials are summed over the group."""
    group = active_node_group()
    if group is None:
        return sum(torch.roll(v_k[j].to(torch.float32), o) for j, o in enumerate(offsets))
    n = group.num_nodes
    lo, hi = group.rows
    ids = torch.arange(lo, hi, device=v_k.device)
    out = torch.zeros(n, dtype=torch.float32, device=v_k.device)
    for j, o in enumerate(offsets):
        out.index_add_(0, (ids + int(o)) % n, v_k[j].to(torch.float32))
    return sender_total_(out)


def circulant_in_degree(edge_k: torch.Tensor, offsets) -> torch.Tensor:
    """[N] sender in-degree under a [k, N] edge mask (a node block's [k, R]
    columns under a node scope): ``edge_k[j, i]`` says receiver i reads
    sender (i + offsets[j]) % N."""
    return circulant_sender_sum(edge_k, offsets)


def network_size(rows: int) -> int:
    """The network's N: ``rows`` in one process, the node group's N under a
    node scope (where a rule's ``own`` holds the block's R rows)."""
    group = active_node_group()
    return rows if group is None else group.num_nodes


def self_mask(rows: int, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[rows, N] ones where a receiver meets itself: ``eye(N)`` in one
    process, the block's rows of it under a node scope."""
    group = active_node_group()
    if group is None:
        return torch.eye(n, dtype=dtype, device=device)
    lo = group.rows[0]
    out = torch.zeros((rows, n), dtype=dtype, device=device)
    ar = torch.arange(rows, device=device)
    out[ar, lo + ar] = 1
    return out


def receiver_ids(rows: int, device) -> torch.Tensor:
    """The node ids of a rule's receivers: 0..N-1 in one process, the
    block's under a node scope."""
    group = active_node_group()
    lo = 0 if group is None else group.rows[0]
    return torch.arange(lo, lo + rows, device=device)


def own_broadcast_rows(bcast: torch.Tensor) -> torch.Tensor:
    """The broadcast rows of a rule's own receivers: ``bcast`` in one
    process; under a node scope the block's rows of the whole [N, P], or
    of its window (which always holds them)."""
    group = active_node_group()
    if group is None:
        return bcast
    if group.windowed:
        start, stop = group.own_window_rows()
        return bcast[start:stop]
    lo, hi = group.rows
    return bcast[lo:hi]


def window_of(whole: torch.Tensor) -> torch.Tensor:
    """A node block's window rows of a whole [N, ...] tensor (the tensor
    itself off a node scope)."""
    group = active_node_group()
    if group is None or not group.windowed:
        return whole
    idx = torch.tensor(group.window_rows(), dtype=torch.int64, device=whole.device)
    return whole[idx]



def row_norms(x: torch.Tensor) -> torch.Tensor:
    """[N] L2 norm of each row, in ``x``'s dtype (a column block's squared
    partial summed over the active param group first)."""
    return torch.sqrt(reduce_partial_(torch.sum(x * x, dim=-1)))


def pairwise_l2_distances(
    a: torch.Tensor, b: Optional[torch.Tensor] = None, replicated: bool = False
) -> torch.Tensor:
    """L2 distance matrix D[i, j] = |a_i - b_j| through the pairwise kernel.

    The rows are centered on the mean of ``a`` first: late in training all
    nodes' vectors cluster around a common point whose norm dwarfs their
    pairwise distances, and |a|^2 + |b|^2 - 2ab would cancel
    catastrophically in float32.  Centering leaves the distances unchanged.
    The kernel subtracts the center row as it loads the values, so no
    centered copy of ``a`` or ``b`` is made.  The kernel takes float32, so
    bf16 parameters are widened here.

    Under a param group the operands are column blocks and the squared
    partials are summed over the group (the center is column-local);
    ``replicated`` operands (whole on every rank: Sketchguard's sketches)
    are not summed.

    Under a node scope ``a`` is either whole ([N, P], the gathered
    broadcast) or the block's [R, P] rows, and the center is always the
    whole network's mean, as in one process: taken locally from a whole
    ``a``, else the block's float32 column sums summed over the group over
    N.  A whole ``a`` with no ``b`` gives the whole [N, N]: the kernel runs
    on the block's [R, N] rows and the blocks are gathered.
    """
    a32 = a.to(torch.float32).contiguous()
    b32 = None if b is None else b.to(torch.float32).contiguous()
    group = active_node_group()
    if group is not None:
        return _block_l2_distances(a32, b32, group)
    d2 = agg_kernels.pairwise_sq_distances(a32, b32, center=a32.mean(dim=0))
    d2 = reduce_partial_(d2, replicated)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _block_l2_distances(a32, b32, group) -> torch.Tensor:
    """:func:`pairwise_l2_distances` under a node scope."""
    n = group.num_nodes
    if a32.shape[0] == n:
        center = a32.mean(dim=0)
    else:
        center = all_reduce_sum_(a32.sum(dim=0), group) / n
    if b32 is None and a32.shape[0] == n:
        lo, hi = group.rows
        d2 = gather_rows(agg_kernels.pairwise_sq_distances(a32[lo:hi], a32, center=center),
                         group)
    else:
        d2 = agg_kernels.pairwise_sq_distances(a32, b32, center=center)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def circulant_neighbor_distances(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int],
    replicated: bool = False,
) -> torch.Tensor:
    """[k, N] distances D[o, i] = |own_i - bcast[(i + o) mod N]| through the
    circulant kernel (no Gram identity, so no centering is needed); the
    squared partials summed over a param group unless ``replicated``, as
    in :func:`pairwise_l2_distances`.  Under a node scope ``own`` is the
    block's [R, P] rows and ``bcast`` its window: [k, R], one offset-0
    launch an offset on the window's rows (``circulant_window_sq_distances``)."""
    group = active_node_group()
    if group is not None:
        d2 = agg_kernels.circulant_window_sq_distances(
            own.to(torch.float32).contiguous(), bcast.to(torch.float32).contiguous(),
            group.positions(offsets))
        return torch.sqrt(d2)
    d2 = agg_kernels.circulant_sq_distances(
        own.to(torch.float32).contiguous(),
        bcast.to(torch.float32).contiguous(),
        offsets,
    )
    return torch.sqrt(reduce_partial_(d2, replicated))


def window_delta_distances(window: torch.Tensor, deltas: Sequence[int]) -> list:
    """Under a node scope: for each step d, the [W - d] distances
    |window[w] - window[w + d]| between the window's rows d apart (one
    offset-0 launch each), the node block's counterpart of the circulant
    [D, N] of ``circulant_neighbor_distances(bcast, bcast, deltas)``."""
    w32 = window.to(torch.float32).contiguous()
    rows = w32.shape[0]
    return [torch.sqrt(agg_kernels.circulant_window_sq_distances(w32[:rows - d], w32, [d])[0])
            for d in deltas]


def _senders(bc: torch.Tensor, offsets, rows: int):
    """For each offset in turn, the [rows, c] sender rows of the receivers:
    rolls of the whole ``bc`` in one process (made one at a time), slices
    of a node block's window under a node scope."""
    group = active_node_group()
    if group is None:
        return (torch.roll(bc, -int(o), dims=0) for o in offsets)
    return (bc[q:q + rows] for q in group.positions(offsets))


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
    promoted precision per P chunk and written in ``out_dtype``.  Under a
    node scope ``bcast`` is the block's window and ``w_k`` its [k, R]
    columns: [R, P], each sender a slice of the window."""
    n, p = bcast.shape
    rows = w_k.shape[1]
    acc_dtype = torch.promote_types(bcast.dtype, w_k.dtype)
    out_dtype = acc_dtype if out_dtype is None else out_dtype
    chunk = _p_chunk_len(n, p, bcast.element_size())
    out = torch.empty((rows, p), dtype=out_dtype, device=bcast.device)
    for c0 in range(0, p, chunk):
        bc = bcast[:, c0:c0 + chunk]
        acc = torch.zeros((rows, bc.shape[1]), dtype=acc_dtype, device=bcast.device)
        for idx, sender in enumerate(_senders(bc, offsets, rows)):
            acc = acc + w_k[idx][:, None] * sender
        out[:, c0:c0 + chunk] = acc.to(out_dtype)
    return out


def circulant_masked_mean(
    bcast: torch.Tensor, accept_k: torch.Tensor, offsets, out_dtype=None
) -> torch.Tensor:
    """Weighted neighbor mean from per-offset acceptance ``accept_k[k, N]``,
    written in ``out_dtype`` (default: bcast's); under a node scope over
    the block's window and ``accept_k``'s [k, R] columns."""
    cnt = accept_k.sum(dim=0)
    w_norm = accept_k / torch.clamp(cnt, min=1e-12)[None, :]
    out_dtype = bcast.dtype if out_dtype is None else out_dtype
    return circulant_weighted_sum(bcast, w_norm, offsets, out_dtype=out_dtype)


def candidate_chunk_dispatch(own, bcast, chunk_apply, stack_height: int) -> torch.Tensor:
    """Apply the coordinate-wise ``chunk_apply(own_chunk, bcast_chunk) ->
    [N, c]`` over P chunks whose budget is scaled by ``stack_height`` (the
    [N, c] copies the candidate stack holds per chunk); a small N*P runs in
    one chunk.  The output takes the dtype of the first chunk's result and
    ``own``'s rows (a node block's R under a node scope)."""
    n, p = own.shape[0], bcast.shape[1]
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
    to [N, c] and must be coordinate-wise along the last axis.  Under a
    node scope the stack is [m, R, c]: the block's own rows, then slices
    of its window."""

    def chunk_apply(oc, bc):
        return fn(torch.stack([oc, *_senders(bc, offsets, oc.shape[0])]))

    return candidate_chunk_dispatch(own, bcast, chunk_apply, len(offsets) + 1)


def masked_neighbor_mean(bcast: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted neighbor mean per node, (W @ bcast) / row sum, safe on empty
    rows and returned in bcast's dtype (under a node scope ``weights`` are
    the block's [R, N] rows over the whole ``bcast``: [R, P]).  The weights are cast to bcast's
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
    else own (the BALANCE/Sketchguard output form); row-local, so a node
    block's rows under a node scope."""
    blended = alpha * own + (1.0 - alpha) * neighbor_avg
    return torch.where(has_neighbors[:, None], blended, own)


def candidate_indices(adj: torch.Tensor, m_cap: int):
    """Per-node candidate ordering: self first, then neighbors ascending,
    non-candidates last (a stable sort), truncated at ``m_cap``.  Under a
    node scope ``adj`` is the block's [R, N] rows, and the self candidate
    of row i is node lo + i.

    Returns:
        (cand_idx [N, m] int64, valid [N, m] bool).
    """
    rank = adj + 2.0 * self_mask(adj.shape[0], adj.shape[1], adj.dtype, adj.device)
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
    cross-evaluation), vmapped over the nodes: dict of [N] metrics.  A
    leading probe dim of 1 is one evaluator batch for every row (the ZMQ
    backend's mini network, distributed/local.py).  Under a param group
    ``own`` is the rank's column block: the rank evaluates its own rows,
    turned back whole, and the [N] metrics are gathered.  Under a node
    scope ``own`` is the block's [R, P] rows, each on its own probe batch
    (the block's rows of the whole probe arrays): the block's [R]."""

    def one(params_i, x_i, y_i, m_i):
        return metric_fn(ctx.apply_fn(params_i, x_i), y_i, m_i)

    n = own.shape[0]
    px, py, pm = (
        a.expand((n,) + tuple(a.shape[1:])) if a.shape[0] == 1 and n != 1 else node_rows(a)
        for a in (ctx.probe_x, ctx.probe_y, ctx.probe_mask)
    )
    group = active_param_group()
    if group is None:
        return vmap(one)(ctx.unravel(own), px, py, pm)
    lo, hi = group.rows
    mine = vmap(one)(ctx.unravel(columns_to_rows(own, group)), px[lo:hi], py[lo:hi],
                     pm[lo:hi])
    return {k: gather_rows(v, group) for k, v in mine.items()}
