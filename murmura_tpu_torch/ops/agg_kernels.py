"""Krum's two distance passes: CUDA kernels, their wrappers and their plain
PyTorch versions.

``pairwise_sq_distances``
    [N, M] squared distances D2[i, j] = |a_i - c|^2 + |b_j - c|^2
    - 2 (a_i - c) . (b_j - c), a Gram product and both squared norms
    streamed over P and combined at the end (dense Krum, ``tpu.exchange:
    allgather``), with an optional center row c that the kernel subtracts
    as it loads the values.  Replaces the Pallas kernel
    ``murmura_tpu/ops/pallas_agg.py: pairwise_sq_distances``, which takes
    rows its caller has centered already.
``circulant_sq_distances``
    [k, N] squared distances D2[o, i] = |own_i - bcast[(i + o) mod N]|^2 for
    all k offsets in one pass (circulant Krum, ``tpu.exchange: ppermute``).
    Replaces ``murmura_tpu/ops/pallas_agg.py: circulant_sq_distances``.
    The kernel stages all N rows in shared memory; where they would leave
    it tiles narrower than 16 columns (past 260 rows for two tensors, and
    past the cap) the wrapper splits the call into launches of at most
    :func:`circulant_split_rows` rows (:func:`circulant_split`), each on
    contiguous row views with the one offset 0, and reads own k times
    instead of once.

The kernels live in ``csrc/agg_distances.cu`` (design and bound notes
there).  Each wrapper checks device, dtype (float32), contiguity and shapes,
plans the launch (tile width, shared-memory ring, grid; cached per shape),
allocates the output and the per-block partials in one ``torch.empty`` and
launches on the current stream.  On a CUDA tensor it launches its kernel
or raises; on a CPU tensor it runs the plain version, which is what the
CPU tests exercise.  ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` counts plain-version calls, so a run can show which path it
took.
"""

import ctypes
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from murmura_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {"pairwise_sq_distances": 0, "circulant_sq_distances": 0}
PLAIN_CALLS: Dict[str, int] = {"pairwise_sq_distances": 0, "circulant_sq_distances": 0}

# The circulant kernel reads its offsets from a small device array.
MAX_OFFSETS = 256
# Launch constants, the same as csrc/agg_distances.cu's (checked when the
# library loads): threads a block, slots of the shared-memory ring, rows of
# a pairwise output tile, dynamic shared memory a block may take, circulant
# offsets a thread; and the shared memory of one SM.
THREADS = 256
STAGES = 3
PW_ROWS = 16
SMEM_MAX = 232448
CI_KT = 4
_SMEM_SM = 233472
# Ring bytes that leave room for two blocks on an SM; a plan takes the
# widest power-of-two tile under it, or under SMEM_MAX when none fits.
_RING_TARGET = 110 * 1024
# The narrowest tile a pairwise block tile may force: 128 columns, so that
# every row is copied in segments of at least 512 bytes; a block tile
# shrinks before its tile would.
_PW_MIN_TC = 128
# A circulant call whose one launch would take tiles narrower than this is
# split (circulant_needs_split): in narrow tiles a warp copies a few 8-byte
# words a row.  On an H100 (bench_torch_distances.py --circulant-split),
# one launch of 16-column tiles beat the split at every N and P measured;
# at P = 262,144 one launch of 8-column tiles took 1.8x the split's time,
# of 4 and 2 columns 7-60x.
_ONE_LAUNCH_MIN_TC = 16
# The tile width of a split call's launches: each takes the most rows whose
# two-tensor ring holds tiles this wide with two blocks an SM.
_SPLIT_MIN_TC = 32
# P-chunk budget of the plain circulant version (bytes per [N, chunk] copy),
# the JAX package's _CIRCULANT_CHUNK_BYTES.
_PLAIN_CHUNK_BYTES = 256 * 1024 * 1024

_SIGNED = False


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = _build.load("agg_distances")
    if not _SIGNED:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.agg_pairwise_sq_distances.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i64, i32, i32, i32, i32, i32, i32, i32, vp,
        ]
        lib.agg_pairwise_sq_distances.restype = i32
        lib.agg_circulant_sq_distances.argtypes = [
            vp, vp, vp, i32, vp, vp, i32, i64, i32, i32, i32, i32, i32, i32, vp,
        ]
        lib.agg_circulant_sq_distances.restype = i32
        consts = (ctypes.c_int * 5)()
        lib.agg_constants(consts)
        if tuple(consts) != (THREADS, STAGES, PW_ROWS, SMEM_MAX, CI_KT):
            raise RuntimeError(
                f"agg_distances.cu's constants {tuple(consts)} differ from the "
                f"wrapper's {(THREADS, STAGES, PW_ROWS, SMEM_MAX, CI_KT)}"
            )
        _SIGNED = True
    return lib


def check_cuda(name: str, *tensors: torch.Tensor, dtypes=(torch.float32,)) -> None:
    """Raise unless every tensor is a contiguous 2-D CUDA tensor on one
    device, of one of ``dtypes`` and all of the same dtype."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors (or CPU tensors for the plain version), got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} vs {dev})")
        if t.dtype not in dtypes or t.dtype != tensors[0].dtype:
            allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: the kernel takes {allowed} (one dtype), got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected [rows, P] tensors, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _vec(p: int, *tensors: Optional[torch.Tensor]) -> int:
    """2 (8-byte copies) when every row starts on an 8-byte boundary, else 1."""
    even = p % 2 == 0 and all(t is None or t.data_ptr() % 8 == 0 for t in tensors)
    return 2 if even else 1


def _ring(stage_bytes, min_tc: int, reserve: int) -> Optional[Tuple[int, int]]:
    """(tc_log2, shared bytes): the widest power-of-two tile of at least
    ``min_tc`` columns whose ring fits two blocks on an SM, else one block;
    None when even the narrowest tile does not fit.  ``reserve``: bytes the
    kernel's final reduction needs."""
    for limit in (_RING_TARGET, SMEM_MAX):
        for log2 in range(11, min_tc.bit_length() - 2, -1):
            ring = STAGES * stage_bytes(1 << log2)
            if ring <= limit:
                return log2, max(ring, reserve)
    return None


def _grid_x(tiles: int, smem: int, blocks_y: int, sms: int) -> int:
    """Blocks along P: every resident block busy, none without a tile."""
    per_sm = max(1, min(2, _SMEM_SM // (smem + 1024)))
    return max(1, min(tiles, per_sm * sms // blocks_y))


def _pow2_at_most(x: int, cap: int) -> int:
    return min(cap, 1 << (max(1, x).bit_length() - 1))


@functools.lru_cache(maxsize=256)
def pairwise_plan(n: int, m: int, p: int, same: bool, sms: int) -> Dict[str, int]:
    """Block tile (tm x tn warp tiles of 16 x 16, at most 8, halved until
    a ring of _PW_MIN_TC columns leaves room for two blocks on an SM), tile
    width, shared memory and grid of one pairwise launch.  A same-tensor
    call whose one block row covers all of a stages no rows of b."""
    tiles_n, tiles_m = math.ceil(n / PW_ROWS), math.ceil(m / PW_ROWS)

    def stage_bytes(tm, tn, tc):
        rows = tm * PW_ROWS + (0 if same and tiles_n <= tm else tn * PW_ROWS)
        return (rows * (tc + 8) + tc) * 4

    tm = _pow2_at_most(tiles_n, 4)
    tn = _pow2_at_most(tiles_m, 8 // tm)
    while tm * tn > 1 and STAGES * stage_bytes(tm, tn, _PW_MIN_TC) > _RING_TARGET:
        tm, tn = (tm // 2, tn) if tm >= tn else (tm, tn // 2)
    blocks_n, blocks_m = math.ceil(tiles_n / tm), math.ceil(tiles_m / tn)
    if blocks_n * blocks_m > 65535:
        raise ValueError(
            f"pairwise_sq_distances: {n} x {m} makes {blocks_n * blocks_m} output "
            f"blocks of {tm * PW_ROWS} x {tn * PW_ROWS}; the grid takes at most 65535"
        )
    tc_log2, smem = _ring(
        lambda tc: stage_bytes(tm, tn, tc), 8,
        (THREADS // 32) * (PW_ROWS * PW_ROWS + 2 * PW_ROWS) * 4,
    )
    gx = _grid_x(math.ceil(p / (1 << tc_log2)), smem, blocks_n * blocks_m, sms)
    return {"tc_log2": tc_log2, "smem": smem, "tm": tm, "tn": tn, "gx": gx}


@functools.lru_cache(maxsize=256)
def circulant_plan(n: int, p: int, k: int, same: bool, vec: int, sms: int) -> Dict[str, int]:
    """Tile width, shared memory and grid of one circulant launch.  Raises
    when N rows do not fit shared memory (the wrapper splits such calls
    first, and those whose tiles would be narrow: :func:`circulant_needs_split`)."""
    rows = n if same else 2 * n
    ring = _ring(lambda tc: rows * (tc + vec) * 4, vec, THREADS * CI_KT * 4)
    if ring is None:
        raise ValueError(
            f"circulant_sq_distances: the kernel stages all {n} rows of "
            f"{'the tensor' if same else 'both tensors'} in shared memory; "
            f"{n} rows do not fit"
        )
    tc_log2, smem = ring
    units = math.ceil(k / CI_KT) * n  # (offset group, own row), one a thread
    gy = math.ceil(units / min(units, THREADS))
    gx = _grid_x(math.ceil(p / (1 << tc_log2)), smem, gy, sms)
    return {"tc_log2": tc_log2, "smem": smem, "gx": gx, "gy": gy}


def circulant_row_cap(vec: int) -> int:
    """The most rows N of a two-tensor circulant launch that shared memory
    holds: 2N rows of the narrowest tile (``vec`` columns, one of padding)
    in every ring slot."""
    return SMEM_MAX // (STAGES * 2 * (2 * vec) * 4)


def circulant_split_rows(vec: int) -> int:
    """Rows a launch of a split call takes (see _SPLIT_MIN_TC)."""
    return _RING_TARGET // (STAGES * 2 * (_SPLIT_MIN_TC + vec) * 4)


def circulant_needs_split(n: int, same: bool, vec: int) -> bool:
    """Whether the wrapper splits a call: when its N rows would leave
    :func:`circulant_plan` tiles narrower than _ONE_LAUNCH_MIN_TC columns
    (a ring of such tiles does not fit two blocks an SM), or no tile at
    all: past 260 rows for two tensors, 521 for one (8-byte copies)."""
    rows = n if same else 2 * n
    return STAGES * rows * (_ONE_LAUNCH_MIN_TC + vec) * 4 > _RING_TARGET


def circulant_split(n: int, offsets: Sequence[int], cap: int) -> List[Tuple[int, int, int, int]]:
    """The launches of a circulant call whose N rows exceed ``cap``: for
    each offset index q and each chunk of at most ``cap`` own rows, the
    pieces (q, i0, i1, j0) such that D2[q, i0:i1] is the offset-0 distance
    between own[i0:i1] and bcast[j0:j0 + i1 - i0].  A chunk whose bcast rows
    wrap past row N - 1 is split there, so every view is contiguous."""
    pieces = []
    for q, o in enumerate(offsets):
        o = int(o) % n
        for i0 in range(0, n, cap):
            i1 = min(n, i0 + cap)
            j0 = (i0 + o) % n
            wrap = i0 + n - j0  # own row whose bcast row is row 0
            if j0 + (i1 - i0) <= n:
                pieces.append((q, i0, i1, j0))
            else:
                pieces += [(q, i0, wrap, j0), (q, wrap, i1, 0)]
    return pieces


def circulant_split_call(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int], cap: int,
    call: Callable[[torch.Tensor, torch.Tensor, Sequence[int]], torch.Tensor],
) -> torch.Tensor:
    """[k, N] distances from one ``call(own_view, bcast_view, [0])`` a piece
    of :func:`circulant_split` (the kernel on the card, the plain version in
    the CPU tests)."""
    n = own.shape[0]
    out = torch.empty((len(offsets), n), dtype=torch.float32, device=own.device)
    for q, i0, i1, j0 in circulant_split(n, offsets, cap):
        out[q, i0:i1] = call(own[i0:i1], bcast[j0:j0 + i1 - i0], [0])[0]
    return out


# ---------------------------------------------------------------------------
# pairwise
# ---------------------------------------------------------------------------


def pairwise_sq_distances_plain(
    a: torch.Tensor, b: Optional[torch.Tensor] = None, center: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The Gram/norm formula in float32 (``b=None``: all pairs of ``a``),
    on the rows minus ``center`` when one is given."""
    PLAIN_CALLS["pairwise_sq_distances"] += 1
    a = a.to(torch.float32)
    b = None if b is None else b.to(torch.float32)
    if center is not None:
        a = a - center
        b = None if b is None else b - center
    b = a if b is None else b
    sq_a = (a * a).sum(-1)
    sq_b = sq_a if b is a else (b * b).sum(-1)
    return sq_a[:, None] + sq_b[None, :] - 2.0 * (a @ b.T)


def pairwise_sq_distances(
    a: torch.Tensor, b: Optional[torch.Tensor] = None, center: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[N, M] squared distances between the rows of ``a`` and of ``b``
    (``b=None``: ``b`` is ``a``, and the kernel reads it once), each row
    minus ``center`` ([P]) when one is given."""
    if all(t is None or t.device.type == "cpu" for t in (a, b, center)):
        return pairwise_sq_distances_plain(a, b, center)
    name = "pairwise_sq_distances"
    same = b is None or b is a
    b = a if same else b
    check_cuda(name, a, b)
    n, p = a.shape
    m = b.shape[0]
    if b.shape[1] != p:
        raise ValueError(f"{name}: P differs ({p} vs {b.shape[1]})")
    if center is not None:
        if center.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes a float32 center, got {center.dtype}")
        if center.device != a.device or center.numel() != p or not center.is_contiguous():
            raise ValueError(
                f"{name}: center must be a contiguous row of P = {p} values on {a.device}"
            )
    vec = _vec(p, a, b, center)
    plan = pairwise_plan(n, m, p, same, _sm_count(a.device))
    gx = plan["gx"]
    work = torch.empty(n * m + gx * (n * m + n + m), dtype=torch.float32, device=a.device)
    err = _lib().agg_pairwise_sq_distances(
        a.data_ptr(), b.data_ptr(), None if center is None else center.data_ptr(),
        work.data_ptr(), work.data_ptr() + 4 * n * m, n, m, p, int(same), vec,
        plan["tc_log2"], plan["tm"], plan["tn"], gx, plan["smem"],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    raise_on(name, err)
    LAUNCHES[name] += 1
    return work.as_strided((n, m), (m, 1))


# ---------------------------------------------------------------------------
# circulant
# ---------------------------------------------------------------------------


def circulant_sq_distances_plain(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """Rolled subtract-square-sum, P-chunked so that at most one [N, chunk]
    float32 rolled copy per offset is alive at a time."""
    PLAIN_CALLS["circulant_sq_distances"] += 1
    n, p = bcast.shape
    chunk = max(1, min(p, _PLAIN_CHUNK_BYTES // max(1, n * max(bcast.element_size(), 4))))
    out = torch.zeros((len(offsets), n), dtype=torch.float32, device=bcast.device)
    for c0 in range(0, p, chunk):
        oc = own[:, c0:c0 + chunk]
        bc = bcast[:, c0:c0 + chunk]
        out += torch.stack([
            torch.square((oc - torch.roll(bc, -int(o), dims=0)).to(torch.float32)).sum(-1)
            for o in offsets
        ])
    return out


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The offsets (already reduced mod N) as an int32 device tensor, made
    once per (offsets, device) so that a call makes no host-to-device copy."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def circulant_sq_distances(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """[k, N] squared distances |own_i - bcast[(i + o) mod N]|^2 (own and
    bcast the same tensor: the kernel reads it once).  A call of many rows
    is split into launches of at most :func:`circulant_split_rows` rows."""
    if own.device.type == "cpu" and bcast.device.type == "cpu":
        return circulant_sq_distances_plain(own, bcast, offsets)
    _check_circulant(own, bcast, offsets)
    n, p = bcast.shape
    vec = _vec(p, own, bcast)
    if circulant_needs_split(n, own.data_ptr() == bcast.data_ptr(), vec):
        return circulant_split_call(own, bcast, offsets, circulant_split_rows(vec),
                                    circulant_launch)
    return circulant_launch(own, bcast, offsets)


def _check_circulant(own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int]) -> None:
    name = "circulant_sq_distances"
    check_cuda(name, own, bcast)
    if own.shape != bcast.shape:
        raise ValueError(f"{name}: own {tuple(own.shape)} != bcast {tuple(bcast.shape)}")
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{name}: takes 1..{MAX_OFFSETS} offsets, got {len(offsets)}")


def circulant_launch(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """One launch of the circulant kernel on CUDA tensors, however narrow
    the plan's tiles (:func:`circulant_sq_distances` splits first)."""
    name = "circulant_sq_distances"
    _check_circulant(own, bcast, offsets)
    k = len(offsets)
    n, p = bcast.shape
    same = own.data_ptr() == bcast.data_ptr()
    vec = _vec(p, own, bcast)
    plan = circulant_plan(n, p, k, same, vec, _sm_count(bcast.device))
    offs = _offsets_on(tuple(int(o) % n for o in offsets), bcast.device)
    gx = plan["gx"]
    work = torch.empty((gx + 1) * k * n, dtype=torch.float32, device=bcast.device)
    err = _lib().agg_circulant_sq_distances(
        own.data_ptr(), bcast.data_ptr(), offs.data_ptr(), k, work.data_ptr(),
        work.data_ptr() + 4 * k * n, n, p, int(same), vec, plan["tc_log2"],
        gx, plan["gy"], plan["smem"], torch.cuda.current_stream(bcast.device).cuda_stream,
    )
    raise_on(name, err)
    LAUNCHES[name] += 1
    return work.as_strided((k, n), (n, 1))
