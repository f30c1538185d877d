# Copy of plan_param_layout, plan_gang_param_layout and make_gang_mesh's
# layout policy (plan_gang_layout) from murmura_tpu/parallel/mesh.py.
"""Param-axis sharding, the node axis and the seed axis over a
``torch.distributed`` process group (the PyTorch counterpart of
murmura_tpu/parallel/mesh.py).

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

The node axis (:class:`NodeGroup`, the JAX package's node-sharded mesh)
splits the nodes instead: rank r trains, attacks and aggregates its block
of rows, and the neighbour exchange (:func:`exchange_rows`) is one
``all_gather`` of the broadcast rows, or under a circulant exchange one
``all_to_all_single`` that brings each rank exactly the window of rows its
receivers' senders hold (:func:`window_frame`).  The rules run on the block
while :func:`node_block_scope` is active (aggregation/base.py).

The seed axis (:class:`SeedGroup`, the JAX package's ("seed", "nodes")
gang mesh laid seed-major) splits a gang's members: rank r holds the
members ``block(S, W, r)`` whole and runs them as an ordinary gang
(core/gang.py).  Members are independent experiments, so no collective
runs inside a round; around the rounds the ranks gather each member's
metric rows (:func:`gather_objects`) and, for a snapshot, the members'
``[S_r, N, P]`` stacks to rank 0 (:func:`gather_rows` over the member
counts).

The serve daemon (serve/daemon.py) runs over a seed or a param group for its
whole lifetime: rank 0 sends every rank each generation's composition, the
idle ticks and the stop with :func:`broadcast_object`, and a gang that
serves takes its lane freezes from rank 0 the same way at each chunk
boundary.

The launcher (parallel/launch.py) spawns the ranks and sets each one's
:func:`process_group`.  Over gloo on CUDA tensors (several ranks on one
card, a check of the collective code) the ``all_to_all`` and ``all_gather``
steps of both axes are staged through pinned host buffers, since gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast`` only; NCCL takes them all.
A seed group's gathers are staged the same way.
"""

import contextlib
import functools
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


def plan_gang_layout(batch: int, num_nodes: int, n_dev: int) -> Tuple[int, int]:
    """(seed, nodes) axis sizes of a gang of ``batch`` lanes on ``n_dev``
    devices (the JAX package's ``make_gang_mesh`` policy): seed-major when
    the whole gang fits (``batch * num_nodes <= n_dev``), otherwise the
    largest seed factor that divides both the device count and the gang
    and leaves a node factor that divides the nodes; seed 1 (every device
    on the node axis) when no larger one does.  Raises when no
    factorization fits."""
    if batch * num_nodes <= n_dev:
        return batch, num_nodes
    for s in sorted(range(1, n_dev + 1), reverse=True):
        if n_dev % s == 0 and s <= batch and batch % s == 0:
            if num_nodes % (n_dev // s) == 0:
                return s, n_dev // s
    raise ValueError(
        f"cannot lay a gang of {batch} members x {num_nodes} nodes onto "
        f"{n_dev} devices: no (seed, nodes) factorization divides both "
        "axes — adjust tpu.num_devices or the gang size"
    )


def layout_devices(device_type: str, param_shards: int, num_devices: Optional[int],
                   processes: int = 1) -> int:
    """The devices a layout is planned over.  On CUDA the visible cards, or
    ``tpu.num_devices`` of them (more than are visible is refused, in the
    JAX package's words); on the CPU ``tpu.num_devices``, else
    ``param_shards`` (one gloo rank a shard, where the JAX package's tests
    force host devices).

    A run started as ``processes`` processes (``tpu.multihost``) plans over
    the global devices, as JAX's ``jax.devices()`` spans every host: on CUDA
    ``processes`` x the visible cards (``tpu.num_devices``, when given, is
    global), on the CPU ``tpu.num_devices``, else ``param_shards`` rounded up
    to a multiple of ``processes``; a global count that ``processes`` does
    not divide is refused (every process holds as many devices)."""
    if device_type == "cuda":
        avail = processes * torch.cuda.device_count()
        if num_devices is not None and num_devices > avail:
            raise ValueError(f"Requested {num_devices} devices but only {avail} available")
        n_dev = avail if num_devices is None else int(num_devices)
    elif num_devices is not None:
        n_dev = int(num_devices)
    else:
        n_dev = processes * -(-int(param_shards) // processes)
    if n_dev % processes:
        raise ValueError(
            f"the global device count {n_dev} is not a multiple of tpu.num_processes="
            f"{processes}: every process of a multihost run holds as many devices")
    return n_dev


def plan_layout(num_nodes: int, param_shards: int, device_type: str,
                num_devices: Optional[int] = None, gang: Optional[int] = None,
                processes: int = 1) -> Tuple[Tuple[int, int, int], int]:
    """((seed, nodes, param), devices) of a run, or of a gang of ``gang``
    lanes (the JAX gang's compiled batch): :func:`plan_gang_layout` at
    ``param_shards`` 1, else :func:`plan_gang_param_layout`.

    With ``param_shards`` 1 a run's node axis is every planned device, as the
    JAX package's ``make_mesh(tpu.num_devices)`` spans them; whether the
    nodes divide it is checked where the run starts
    (:func:`check_node_axis`).  Above 1 the param axis is the group's world
    (:func:`plan_param_layout`).  The port runs one axis at a time: a gang
    runs its seed axis (a seed group) where the plan's seed factor is above
    1, and a param group where the param factor is; a factor left beside
    the axis that runs goes unused (:func:`running_axis`).  ``processes``:
    the processes of a multihost run (:func:`layout_devices`)."""
    n_dev = layout_devices(device_type, param_shards, num_devices, processes)
    if gang is not None:
        if param_shards == 1:
            return (*plan_gang_layout(gang, num_nodes, n_dev), 1), n_dev
        return plan_gang_param_layout(gang, num_nodes, param_shards, n_dev), n_dev
    if param_shards == 1:
        return (1, n_dev, 1), n_dev
    return plan_param_layout(num_nodes, param_shards, n_dev), n_dev


AXES = ("seed", "nodes", "param")


def running_axis(layout: Tuple[int, int, int], gang: bool,
                 param_shards: int) -> Tuple[str, int, List[str]]:
    """The axis the port runs of a planned (seed, nodes, param) layout, its
    world, and the axes above 1 it leaves unused: the param axis where the
    config asks for ``param_shards`` above 1 (a world of 1 where the plan
    gives it one device: one process on the padded flat vector), else a
    gang's seed axis, else a run's node axis (a gang's node factor is never
    run: ROADMAP Queue A 7)."""
    if param_shards > 1:
        axis = "param"
    elif gang:
        axis = "seed"
    else:
        axis = "nodes"
    world = dict(zip(AXES, layout))[axis]
    unused = [f"{a} {n}" for a, n in zip(AXES, layout) if n > 1 and a != axis]
    return axis, world, unused


def check_node_axis(num_nodes: int, world: int) -> None:
    """Refuse a node axis that does not divide the nodes, in the JAX
    package's words (its ``shard_step``)."""
    if num_nodes % world != 0:
        raise ValueError(
            f"num_nodes={num_nodes} not divisible by mesh node axis {world}")


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
    processes: int = 1

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
        return (f"param group: world {self.world}{_spread(self)}, backend {self.backend}{staged}, "
                f"rank 0 on {self.device}, rows {rows}, columns {cols} of {self.flat_dim}")


def window_frame(num_nodes: int, offsets: Sequence[int]) -> Tuple[Dict[int, int], int, int]:
    """The circulant offsets as signed steps, and the window they span.

    Each offset o in [0, N) is taken as o or o - N: the offsets and 0 (the
    receiver's own row) are cut at their largest circular gap, so that the
    window ``[i + low, i + high]`` of receiver i's senders is as short as
    it can be.  Returns ({offset mod N: signed step}, low, high), with
    low <= 0 <= high."""
    n = int(num_nodes)
    points = sorted({int(o) % n for o in offsets} | {0})
    gaps = [(points[(j + 1) % len(points)] - points[j]) % n or n for j in range(len(points))]
    start = points[(gaps.index(max(gaps)) + 1) % len(points)]
    zero = (0 - start) % n
    signed = {p: (p - start) % n - zero for p in points}
    return signed, min(signed.values()), max(signed.values())


@dataclass(frozen=True)
class NodeGroup:
    """One rank's place in a node group: rank r of W trains, attacks,
    exchanges and aggregates the nodes ``[r N / W, (r + 1) N / W)``
    (:meth:`rows`), the JAX package's node-sharded mesh.  ``offsets`` (the
    exchange's circulant offsets, bound by the round program) make the
    exchange the offset-masked row exchange (:func:`exchange_rows`): the
    rank receives the window of rows its receivers' senders hold; without
    them it is the dense ``all_gather`` of every rank's rows."""

    rank: int
    world: int
    backend: str
    device: torch.device
    num_nodes: int = 0
    offsets: Tuple[int, ...] = ()
    processes: int = 1

    def bind(self, num_nodes: int, offsets: Optional[Sequence[int]] = None) -> "NodeGroup":
        """This group over ``num_nodes`` nodes (a multiple of the world), the
        window exchange over ``offsets`` when given."""
        check_node_axis(num_nodes, self.world)
        return replace(self, num_nodes=int(num_nodes),
                       offsets=tuple(int(o) % int(num_nodes) for o in offsets or ()))

    @property
    def staged(self) -> bool:
        """gloo over CUDA tensors: the exchange goes through pinned host
        buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def rows(self) -> Tuple[int, int]:
        """[lo, hi) of this rank's node block."""
        return block(self.num_nodes, self.world, self.rank)

    def row_counts(self) -> List[int]:
        """Node rows of every rank, in rank order."""
        return [hi - lo for lo, hi in (block(self.num_nodes, self.world, r)
                                       for r in range(self.world))]

    @property
    def windowed(self) -> bool:
        """Whether the exchange is the offset-masked window (else all_gather)."""
        return bool(self.offsets)

    def frame(self) -> Tuple[Dict[int, int], int, int]:
        """:func:`window_frame` of the bound offsets."""
        return window_frame(self.num_nodes, self.offsets)

    def window_rows(self, rank: Optional[int] = None) -> List[int]:
        """The node ids of ``rank``'s window (this rank's by default), in
        window order: ``lo + low`` to ``hi - 1 + high``, mod N."""
        lo, hi = block(self.num_nodes, self.world, self.rank if rank is None else rank)
        _, low, high = self.frame()
        return [(g % self.num_nodes) for g in range(lo + low, hi + high)]

    def positions(self, offsets: Sequence[int]) -> List[int]:
        """Where receiver 0 of the block finds its sender at each offset:
        the window row ``signed(o) - low``; receiver i's is that plus i."""
        signed, low, _ = self.frame()
        return [signed[int(o) % self.num_nodes] - low for o in offsets]

    def own_window_rows(self) -> Tuple[int, int]:
        """[start, stop) of the block's own rows within its window."""
        _, low, _ = self.frame()
        r = self.rows[1] - self.rows[0]
        return -low, -low + r

    def describe(self) -> str:
        """The layout line: world, backend, exchange, each rank's block and,
        under the window exchange, the rows it receives."""
        blocks = " ".join(f"[{lo},{hi})" for lo, hi in
                          (block(self.num_nodes, self.world, r) for r in range(self.world)))
        staged = ", staged through pinned host memory" if self.staged else ""
        if not self.windowed:
            how = f"all_gather of every rank's rows (each receives {self.num_nodes} rows)"
        else:
            wins = "; ".join(f"rank {r}: {_ranges(self.window_rows(r))}"
                             for r in range(self.world))
            how = (f"window exchange at offsets {list(self.offsets)}, rows received "
                   f"{wins}")
        return (f"node group: world {self.world}{_spread(self)}, backend {self.backend}{staged}, "
                f"rank 0 on {self.device}, node blocks {blocks}; {how}")


@dataclass(frozen=True)
class SeedGroup:
    """One rank's place in a seed group: rank r of W holds the members
    ``block(S, W, r)`` of a gang of S (:meth:`members`; blocks may be uneven,
    and a rank may hold none), whole, and trains, attacks, aggregates and
    evaluates them as an ordinary gang.  ``row_counts`` are the member
    counts, so :func:`gather_rows` gathers the members' stacks."""

    rank: int
    world: int
    backend: str
    device: torch.device
    num_members: int = 0
    processes: int = 1

    def bind(self, num_members: int) -> "SeedGroup":
        """This group over a gang of ``num_members``."""
        return replace(self, num_members=int(num_members))

    @property
    def staged(self) -> bool:
        """gloo over CUDA tensors: the gathers go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def members(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of the members ``rank`` (this rank by default) holds."""
        return block(self.num_members, self.world, self.rank if rank is None else rank)

    def row_counts(self) -> List[int]:
        """Members of every rank, in rank order."""
        return [hi - lo for lo, hi in (self.members(r) for r in range(self.world))]

    def describe(self) -> str:
        """The layout line: world, backend and each rank's members."""
        blocks = " ".join(f"[{lo},{hi})" for lo, hi in (self.members(r)
                                                        for r in range(self.world)))
        staged = ", gathers staged through host memory" if self.staged else ""
        return (f"seed group: world {self.world}{_spread(self)}, backend {self.backend}{staged}, "
                f"rank 0 on {self.device}, members {blocks} of {self.num_members}; "
                "no collective inside a round")


def _spread(group) -> str:
    """The layout line's note of a group joined from several processes
    (parallel/launch.py ``join``)."""
    if group.processes <= 1:
        return ""
    return f" over {group.processes} processes of {group.world // group.processes} ranks"


def refuse_transfer_guard_across_processes(group, transfer_guard: bool) -> None:
    """Refuse ``tpu.transfer_guard`` over a group joined from more than one
    process (``tpu.multihost``), in the JAX package's words."""
    if transfer_guard and group is not None and group.processes > 1:
        raise ValueError(
            "tpu.transfer_guard is single-host only: multi-host "
            "resident state cannot be explicitly pre-placed with "
            "jax.device_put, so the guard would flag the legitimate "
            "cross-process staging"
        )


def gather_objects(obj, group) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * group.world
    _dist().all_gather_object(out, obj)
    return out


def broadcast_object(obj, group, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (the other ranks'
    ``obj`` is ignored)."""
    box = [obj if group.rank == src else None]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


def _ranges(ids: Sequence[int]) -> str:
    """Node ids as runs: ``14-15,0-5``."""
    runs: List[List[int]] = []
    for g in ids:
        if runs and g == runs[-1][1] + 1:
            runs[-1][1] = g
        else:
            runs.append([g, g])
    return ",".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)


@functools.lru_cache(maxsize=64)
def _window_plan(num_nodes: int, world: int, offsets: Tuple[int, ...], rank: int):
    """The all_to_all of a window exchange, for ``rank``: (the local row
    indices it sends, receiver by receiver; its send counts; its receive
    counts, sender by sender; the window positions the received rows fill,
    in the order they arrive)."""
    g = NodeGroup(rank, world, "", torch.device("cpu"), num_nodes, offsets)
    owner = [q for q in range(world) for _ in range(g.row_counts()[q])]
    lo = g.rows[0]
    send, send_counts = [], []
    for q in range(world):
        mine = [x - lo for x in g.window_rows(q) if owner[x] == rank]
        send += mine
        send_counts.append(len(mine))
    win = g.window_rows()
    recv_pos = [w for q in range(world) for w, x in enumerate(win) if owner[x] == q]
    recv_counts = [sum(owner[x] == q for x in win) for q in range(world)]
    return tuple(send), tuple(send_counts), tuple(recv_counts), tuple(recv_pos)


# What this process's exchanges received (rows, bytes), for the tests and
# the card's report; reset with reset_exchange_counts().
EXCHANGE_COUNTS: Dict[str, int] = {"calls": 0, "rows": 0, "rows_from_others": 0, "bytes": 0}
# The other collectives of this process (gather_rows and all_reduce_sum_,
# the exchange's own all_gather left out): calls, the bytes each brings
# from the other ranks, and the widest row a gather moved (so a reader sees
# that no [N, P] gather runs beside the exchange); reset with it.
# DMTT's collaborator-mask gathers (gather_mask_rows) count among the
# gathers, and under their own keys with the bytes of the whole mask each
# assembles.
COLLECTIVE_COUNTS: Dict[str, int] = {"gathers": 0, "gather_bytes": 0, "gather_row_bytes_max": 0,
                                     "all_reduces": 0, "all_reduce_bytes": 0,
                                     "mask_gathers": 0, "mask_bytes": 0}


def reset_exchange_counts() -> None:
    for counts in (EXCHANGE_COUNTS, COLLECTIVE_COUNTS):
        for k in counts:
            counts[k] = 0


def _count_exchange(rows: int, own: int, row_bytes: int) -> None:
    EXCHANGE_COUNTS["calls"] += 1
    EXCHANGE_COUNTS["rows"] += rows
    EXCHANGE_COUNTS["rows_from_others"] += rows - own
    EXCHANGE_COUNTS["bytes"] += (rows - own) * row_bytes


def exchange_rows(rows: torch.Tensor, group: NodeGroup) -> torch.Tensor:
    """The neighbour exchange of a node group: this rank's [R_r, P]
    broadcast rows -> the whole [N, P] (one ``all_gather``), or under the
    window exchange the rank's [R_r + high - low, P] window (one
    ``all_to_all_single`` whose splits carry exactly the rows each
    receiver's window holds of the sender's block: a rank receives no other
    row)."""
    row_bytes = rows[0].numel() * rows.element_size() if rows.shape[0] else 0
    lo, hi = group.rows
    if not group.windowed:
        whole = _gather_rows(rows, group, None, counted=False)
        _count_exchange(whole.shape[0], hi - lo, row_bytes)
        return whole
    send_idx, send_counts, recv_counts, recv_pos = _window_plan(
        group.num_nodes, group.world, group.offsets, group.rank)
    send = rows[_offsets_on(send_idx, rows.device).long()] if send_idx else rows[:0]
    recv = torch.empty((sum(recv_counts),) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=rows.device)
    _all_to_all(recv, send, recv_counts, send_counts, group)
    own = recv_counts[group.rank]
    _count_exchange(recv.shape[0], own, row_bytes)
    if list(recv_pos) == list(range(len(recv_pos))):
        return recv
    window = torch.empty_like(recv)
    window[_offsets_on(recv_pos, rows.device).long()] = recv
    return window


@functools.lru_cache(maxsize=64)
def _offsets_on(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Small host integers as a device tensor, made once per (values,
    device)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


# The round-time node scope: the bound node group while a node-axis round
# runs (the counterpart of param_group_scope).
_NODE_SCOPE: List[Optional[NodeGroup]] = []


@contextlib.contextmanager
def node_block_scope(group: Optional[NodeGroup]):
    """Activate ``group`` for the node-block helpers (aggregation/base.py,
    the attacks); None turns them off inside."""
    _NODE_SCOPE.append(group)
    try:
        yield
    finally:
        _NODE_SCOPE.pop()


def active_node_group() -> Optional[NodeGroup]:
    """The innermost active node group, or None."""
    return _NODE_SCOPE[-1] if _NODE_SCOPE else None


def node_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole [N, ...] tensor under a node scope
    (``t`` off it)."""
    group = active_node_group()
    if group is None:
        return t
    lo, hi = group.rows
    return t[lo:hi]


def sender_total_(t: torch.Tensor) -> torch.Tensor:
    """A sum over the receivers of a per-sender count: the block's partial
    summed over the node group, in place (``t`` off the scope)."""
    group = active_node_group()
    if group is None:
        return t
    return all_reduce_sum_(t, group)


def whole_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's [R_r, ...] block of a per-node tensor gathered into the
    whole [N, ...] under a node scope (``t`` off it)."""
    group = active_node_group()
    if group is None:
        return t
    return gather_rows(t, group)


# The group of this process, set once by the launcher in each rank.
_PROCESS_GROUP: List[Union[ParamGroup, NodeGroup, SeedGroup]] = []


def set_process_group(group: Optional[Union[ParamGroup, NodeGroup, SeedGroup]]) -> None:
    _PROCESS_GROUP[:] = [] if group is None else [group]


def process_group() -> Optional[Union[ParamGroup, NodeGroup, SeedGroup]]:
    """This process's rank in a param, node or seed group, or None outside
    one."""
    return _PROCESS_GROUP[0] if _PROCESS_GROUP else None


def round_group() -> Optional[Union[ParamGroup, NodeGroup]]:
    """The group a round program splits its round over: this process's
    param or node group; None in a seed group (its members' rounds are whole)
    and outside a group."""
    group = process_group()
    return None if isinstance(group, SeedGroup) else group


def seed_group() -> Optional[SeedGroup]:
    """This process's seed group, or None."""
    group = process_group()
    return group if isinstance(group, SeedGroup) else None


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
    COLLECTIVE_COUNTS["all_reduces"] += 1
    COLLECTIVE_COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
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
    return _gather_rows(rows, group, dst, counted=True)


def _gather_rows(rows: torch.Tensor, group: ParamGroup, dst: Optional[int],
                 counted: bool) -> Optional[torch.Tensor]:
    """:func:`gather_rows` of an [R_r, ...] block; ``counted`` adds it to
    COLLECTIVE_COUNTS (the exchange's all_gather counts itself)."""
    counts = group.row_counts()
    top = max(counts)
    if counted:
        row_bytes = rows[0].numel() * rows.element_size() if rows.shape[0] else 0
        COLLECTIVE_COUNTS["gathers"] += 1
        COLLECTIVE_COUNTS["gather_bytes"] += (sum(counts) - rows.shape[0]) * row_bytes
        COLLECTIVE_COUNTS["gather_row_bytes_max"] = max(
            COLLECTIVE_COUNTS["gather_row_bytes_max"], row_bytes)
    padded = rows
    if rows.shape[0] < top:
        padded = torch.cat([rows, rows.new_zeros((top - rows.shape[0],) + tuple(rows.shape[1:]))])
    parts = _gather(padded, group, dst)
    return None if parts is None else torch.cat([p[:n] for p, n in zip(parts, counts)])


def gather_mask_rows(rows: torch.Tensor, group: NodeGroup) -> torch.Tensor:
    """Every rank's [R_r, N] 0/1 mask rows -> the whole bool [N, N], on
    every rank: one all_gather of a byte an entry (N² bytes, nothing
    parameter-wide)."""
    COLLECTIVE_COUNTS["mask_gathers"] += 1
    COLLECTIVE_COUNTS["mask_bytes"] += group.num_nodes * rows.shape[1]
    return gather_rows((rows > 0).to(torch.uint8), group) > 0


def barrier(group: ParamGroup) -> None:
    """Wait until every rank reaches this point."""
    _dist().barrier()
