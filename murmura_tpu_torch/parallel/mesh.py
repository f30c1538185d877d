# Copy of plan_param_layout and plan_gang_param_layout from
# murmura_tpu/parallel/mesh.py.
"""Param-axis sharding over a ``torch.distributed`` process group (the
PyTorch counterpart of the param-axis part of murmura_tpu/parallel/mesh.py).

The JAX package splits every [N, P] round tensor by columns over the
``param`` axis of a ("seed", "nodes", "param") mesh and lets GSPMD place the
collectives.  The port runs W ranks of one process group instead, and moves
the data itself:

- rank r trains only its own node rows, ``[r N // W, (r + 1) N // W)`` at
  the full padded width ``P_pad`` (:meth:`ParamGroup.rows`);
- :func:`rows_to_columns` turns those row blocks into column blocks
  ``[N, P_pad / W]`` (one ``all_to_all_single``), on which the whole
  aggregation side runs: the scrub, the attack, the codec, the stale fold
  and the rule, with the carried [N, P] state kept as column blocks;
- :func:`columns_to_rows` returns the new rows (a second
  ``all_to_all_single``), and eval runs on each rank's own rows, its
  metrics gathered with :func:`gather_rows`.

A gang (core/gang.py) over the group holds each member's own rows as one
``[S, R_r, P_pad]`` stack: the same two turns take it whole (the members
become another row block, one ``all_to_all`` each way a round for every
member), as the JAX package's ``[S, N, P]`` param sharding moves the
members' state at once.

A row-wide reduction over the parameter axis crosses the shards: the rules'
distance helpers (aggregation/base.py), the fault scrub's finite flags, row
norms and the codec's error norms sum their partials with
:func:`reduce_partial_` (or take the minimum with :func:`all_columns`)
while :func:`param_group_scope` is active, the scope the round program
opens around a sharded round, so that no rule signature changes.  Off the
scope every hook is the identity.

The launcher (parallel/launch.py) spawns the ranks and sets each one's
:func:`process_group`.  Over gloo on CUDA tensors (several ranks on one
card, a check of the collective code) the ``all_to_all`` and ``all_gather``
steps are staged through pinned host buffers, since gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only; NCCL takes them all.
"""

import contextlib
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch


def plan_param_layout(
    num_nodes: int, param_shards: int, n_dev: int
) -> Tuple[int, int, int]:
    """(seed, nodes, param) axis sizes for a param-sharded single-run mesh.

    Largest-dividing-factor fallback (the :func:`make_gang_mesh` policy):
    prefer the full requested ``param_shards`` on the param axis, else the
    largest divisor of it that also divides the device count while leaving
    a node axis that divides ``num_nodes``.  ``param_shards=1`` degrades to
    the plain node layout.  Raises when no factorization fits.
    """
    if param_shards < 1:
        raise ValueError(f"param_shards must be >= 1, got {param_shards}")
    for s in sorted(
        (d for d in range(1, param_shards + 1) if param_shards % d == 0),
        reverse=True,
    ):
        if n_dev % s:
            continue
        nodes_ax = n_dev // s
        if nodes_ax <= num_nodes and num_nodes % nodes_ax == 0:
            return 1, nodes_ax, s
    raise ValueError(
        f"cannot lay {num_nodes} nodes x {param_shards} param shards onto "
        f"{n_dev} devices: no (nodes, param) factorization divides both "
        "axes — adjust tpu.num_devices or tpu.param_shards"
    )


def plan_gang_param_layout(
    batch: int, num_nodes: int, param_shards: int, n_dev: int
) -> Tuple[int, int, int]:
    """(seed, nodes, param) axis sizes for a param-sharded GANG mesh —
    the sharding x sweep lift.

    Same largest-dividing-factor policy as :func:`plan_param_layout`:
    prefer the full requested ``param_shards`` on the param axis (else
    its largest divisor that divides the device count), then lay the
    remaining devices as a ("seed", "nodes") gang plane under the
    ``make_gang_mesh`` policy — seed-major when the whole gang fits,
    otherwise the largest seed factor whose node remainder divides N.
    Raises when no factorization fits.
    """
    if param_shards < 1:
        raise ValueError(f"param_shards must be >= 1, got {param_shards}")
    for s in sorted(
        (d for d in range(1, param_shards + 1) if param_shards % d == 0),
        reverse=True,
    ):
        if n_dev % s:
            continue
        rem = n_dev // s
        if batch * num_nodes <= rem:
            return batch, num_nodes, s
        for g in sorted(range(1, rem + 1), reverse=True):
            if rem % g == 0 and g <= batch and batch % g == 0:
                if num_nodes % (rem // g) == 0:
                    return g, rem // g, s
    raise ValueError(
        f"cannot lay a gang of {batch} members x {num_nodes} nodes x "
        f"{param_shards} param shards onto {n_dev} devices: no "
        "(seed, nodes, param) factorization divides all three axes — "
        "adjust tpu.num_devices, tpu.param_shards or the gang size"
    )


def layout_devices(device_type: str, param_shards: int, num_devices: Optional[int]) -> int:
    """The devices a layout is planned over.  On CUDA the visible cards, or
    ``tpu.num_devices`` of them (more than are visible is refused, in the
    JAX package's words); on the CPU ``tpu.num_devices``, else
    ``param_shards`` (one gloo rank a shard, where the JAX package's tests
    force host devices)."""
    if device_type == "cuda":
        avail = torch.cuda.device_count()
        if num_devices is not None:
            if num_devices > avail:
                raise ValueError(
                    f"Requested {num_devices} devices but only {avail} available")
            return int(num_devices)
        return avail
    return int(num_devices) if num_devices is not None else int(param_shards)


def plan_layout(num_nodes: int, param_shards: int, device_type: str,
                num_devices: Optional[int] = None,
                gang: Optional[int] = None) -> Tuple[Tuple[int, int, int], int]:
    """((seed, nodes, param), devices) of a run, or of a gang of ``gang``
    lanes (the JAX gang's compiled batch) with :func:`plan_gang_param_layout`.
    The port runs no seed or node axis: the param axis is the group's world,
    and devices the other axes would take go unused."""
    n_dev = layout_devices(device_type, param_shards, num_devices)
    if gang is not None:
        return plan_gang_param_layout(gang, num_nodes, param_shards, n_dev), n_dev
    return plan_param_layout(num_nodes, param_shards, n_dev), n_dev


def block(total: int, world: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank's block when ``total`` items split over ``world``
    ranks (``total`` need not divide)."""
    return rank * total // world, (rank + 1) * total // world


@dataclass(frozen=True)
class ParamGroup:
    """One rank's place in the param group: the collective backend, the
    rank's device, and (once a round program binds it) the node rows it
    trains and the flat columns it aggregates."""

    rank: int
    world: int
    backend: str
    device: torch.device
    num_nodes: int = 0
    flat_dim: int = 0

    def bind(self, num_nodes: int, flat_dim: int) -> "ParamGroup":
        """This group over ``num_nodes`` nodes of a ``flat_dim``-wide flat
        vector (the padded width, a multiple of the world)."""
        if flat_dim % self.world:
            raise ValueError(
                f"the flat width {flat_dim} is not a multiple of the group's "
                f"{self.world} ranks: pad it (ops/flatten.make_sharded_flatteners)")
        return replace(self, num_nodes=int(num_nodes), flat_dim=int(flat_dim))

    @property
    def staged(self) -> bool:
        """gloo over CUDA tensors: all_to_all and all_gather go through
        pinned host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def rows(self) -> Tuple[int, int]:
        """[lo, hi) of the node rows this rank trains and evaluates."""
        return block(self.num_nodes, self.world, self.rank)

    def row_counts(self) -> List[int]:
        """Node rows of every rank, in rank order."""
        return [hi - lo for lo, hi in (block(self.num_nodes, self.world, r)
                                       for r in range(self.world))]

    @property
    def local_cols(self) -> int:
        """Width of one column block."""
        return self.flat_dim // self.world

    @property
    def cols(self) -> Tuple[int, int]:
        """[lo, hi) of the flat columns this rank aggregates."""
        c = self.local_cols
        return self.rank * c, (self.rank + 1) * c

    def describe(self) -> str:
        """The layout line: world, backend, device, rows and columns."""
        rows = " ".join(f"[{lo},{hi})" for lo, hi in
                        (block(self.num_nodes, self.world, r) for r in range(self.world)))
        c = self.local_cols
        cols = " ".join(f"[{r * c},{(r + 1) * c})" for r in range(self.world))
        staged = ", all_to_all staged through pinned host memory" if self.staged else ""
        return (f"param group: world {self.world}, backend {self.backend}{staged}, "
                f"rank 0 on {self.device}, rows {rows}, columns {cols} of {self.flat_dim}")


# The group of this process, set once by the launcher in each rank.
_PROCESS_GROUP: List[ParamGroup] = []


def set_process_group(group: Optional[ParamGroup]) -> None:
    _PROCESS_GROUP[:] = [] if group is None else [group]


def process_group() -> Optional[ParamGroup]:
    """This process's rank in a param group, or None outside one."""
    return _PROCESS_GROUP[0] if _PROCESS_GROUP else None


# The round-time scope: the bound group while a sharded round runs.
_SCOPE: List[ParamGroup] = []


@contextlib.contextmanager
def param_group_scope(group: Optional[ParamGroup]):
    """Activate ``group`` for the helpers below; None turns them off inside
    (an unsharded call made within a sharded round)."""
    _SCOPE.append(group)
    try:
        yield
    finally:
        _SCOPE.pop()


def active_param_group() -> Optional[ParamGroup]:
    """The innermost active group, or None."""
    return _SCOPE[-1] if _SCOPE else None


def _dist():
    import torch.distributed as dist

    return dist


def all_reduce_sum_(t: torch.Tensor, group: ParamGroup) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; float32 on the wire (a lower
    precision is widened for the sum and written back)."""
    if t.dtype in (torch.float32, torch.float64):
        _dist().all_reduce(t)
        return t
    wide = t.to(torch.float32)
    _dist().all_reduce(wide)
    return t.copy_(wide)


def reduce_partial_(t: torch.Tensor, replicated: bool = False) -> torch.Tensor:
    """A row-wide sum over the parameter axis: the column block's partial
    summed over the active group, in place; ``replicated`` operands (whole
    on every rank, such as Count-Sketches) and calls off the scope are left
    as they are."""
    group = active_param_group()
    if group is None or replicated:
        return t
    return all_reduce_sum_(t, group)


def all_columns(flags: torch.Tensor) -> torch.Tensor:
    """A row-wide ``all`` over the parameter axis: True where every rank's
    column block says True (a MIN over 0/1); the flags as they are off the
    scope."""
    group = active_param_group()
    if group is None:
        return flags
    f = flags.to(torch.float32)
    _dist().all_reduce(f, op=_dist().ReduceOp.MIN)
    return f > 0.5


def local_columns(full: torch.Tensor) -> torch.Tensor:
    """This rank's column block of a whole-width draw ``[..., P_pad]`` (the
    whole tensor off the scope), so that a draw keeps the unsharded run's
    bits."""
    group = active_param_group()
    if group is None:
        return full
    c0, c1 = group.cols
    return full[..., c0:c1]


def full_width(width: int) -> int:
    """The whole flat width a column block of ``width`` belongs to (itself
    off the scope)."""
    group = active_param_group()
    return width if group is None else group.flat_dim


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous 2-D byte view of ``t`` (rows along dim 0), so that the
    collectives move any dtype."""
    rows = t.shape[0]
    # Through 1-D: a contiguous tensor with a size-1 dim may keep any stride
    # there, which a byte view refuses.
    return t.contiguous().reshape(-1).view(torch.uint8).reshape(rows, -1)


def _all_to_all(out: torch.Tensor, inp: torch.Tensor, out_splits: Sequence[int],
                in_splits: Sequence[int], group: ParamGroup) -> None:
    dist = _dist()
    src, dst = _bytes(inp), _bytes(out)
    if not group.staged:
        dist.all_to_all_single(dst, src, list(out_splits), list(in_splits))
        if dst.data_ptr() != out.data_ptr():
            out.copy_(dst.view(out.dtype).reshape(out.shape))
        return
    h_in = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
    h_in.copy_(src)
    h_out = torch.empty(dst.shape, dtype=torch.uint8, pin_memory=True)
    dist.all_to_all_single(h_out, h_in, list(out_splits), list(in_splits))
    out.copy_(h_out.to(out.device).view(out.dtype).reshape(out.shape))


def rows_to_columns(rows: torch.Tensor, group: ParamGroup) -> torch.Tensor:
    """This rank's [R_r, P_pad] node rows -> its [N, P_pad / W] column
    block of every node's rows (one all_to_all); a gang's [S, R_r, P_pad]
    stack -> [S, N, P_pad / W] in the same one all_to_all."""
    stacked = rows.dim() == 3
    x = rows if stacked else rows[None]
    s, r = x.shape[0], x.shape[1]
    w, c = group.world, group.local_cols
    # [S, R, P] -> [W, R, S, c]: rank q's columns of every member's row,
    # node-major, so that each rank's split is whole rows of an [N, S c].
    send = x.reshape(s, r, w, c).permute(2, 1, 0, 3).reshape(w * r, s * c)
    out = torch.empty((group.num_nodes, s * c), dtype=rows.dtype, device=rows.device)
    _all_to_all(out, send, group.row_counts(), [r] * w, group)
    if not stacked:
        return out
    return out.reshape(group.num_nodes, s, c).transpose(0, 1).contiguous()


def columns_to_rows(cols: torch.Tensor, group: ParamGroup) -> torch.Tensor:
    """The reverse turn: this rank's [N, P_pad / W] column block -> its
    [R_r, P_pad] node rows; a gang's [S, N, P_pad / W] -> [S, R_r, P_pad]."""
    stacked = cols.dim() == 3
    x = cols if stacked else cols[None]
    s = x.shape[0]
    lo, hi = group.rows
    r, w, c = hi - lo, group.world, group.local_cols
    send = x.transpose(0, 1).reshape(group.num_nodes, s * c)
    recv = torch.empty((w * r, s * c), dtype=cols.dtype, device=cols.device)
    _all_to_all(recv, send, [r] * w, group.row_counts(), group)
    # [W, R, S, c] -> [S, R, W c]
    out = recv.reshape(w, r, s, c).permute(2, 1, 0, 3).reshape(s, r, w * c)
    return out if stacked else out[0]


def _gather(t: torch.Tensor, group: ParamGroup,
            dst: Optional[int]) -> Optional[List[torch.Tensor]]:
    """Every rank's equally shaped ``t``, in rank order, on ``t``'s device:
    on every rank, or on rank ``dst`` alone (None elsewhere)."""
    dist = _dist()
    src = _bytes(t)
    if group.staged:
        src = src.cpu()
    if dst is None:
        parts = [torch.empty_like(src) for _ in range(group.world)]
        dist.all_gather(parts, src)
    else:
        parts = ([torch.empty_like(src) for _ in range(group.world)]
                 if group.rank == dst else None)
        dist.gather(src, parts, dst=dst)
        if parts is None:
            return None
    return [p.to(t.device).view(t.dtype).reshape(t.shape) for p in parts]


def gather_columns(cols: torch.Tensor, group: ParamGroup,
                   dst: Optional[int] = None) -> Optional[torch.Tensor]:
    """Every rank's [..., N, P_pad / W] column block -> the whole [..., N,
    P_pad], on every rank (on rank ``dst`` alone when given; None
    elsewhere)."""
    parts = _gather(cols, group, dst)
    return None if parts is None else torch.cat(parts, dim=-1)


def gather_rows(rows: torch.Tensor, group: ParamGroup, dst: Optional[int] = None,
                stacked: bool = False) -> Optional[torch.Tensor]:
    """Every rank's [R_r, ...] rows -> the whole [N, ...], on every rank
    (on rank ``dst`` alone when given; None elsewhere); each block padded to
    the largest for the gather.  ``stacked``: a gang's [S, R_r, ...] stack,
    gathered into [S, N, ...]."""
    if stacked:
        whole = gather_rows(rows.transpose(0, 1).contiguous(), group, dst)
        return None if whole is None else whole.transpose(0, 1).contiguous()
    counts = group.row_counts()
    top = max(counts)
    padded = rows
    if rows.shape[0] < top:
        padded = torch.cat([rows, rows.new_zeros((top - rows.shape[0],) + tuple(rows.shape[1:]))])
    parts = _gather(padded, group, dst)
    return None if parts is None else torch.cat([p[:n] for p, n in zip(parts, counts)])


def barrier(group: ParamGroup) -> None:
    """Wait until every rank reaches this point."""
    _dist().barrier()
