"""Fused candidate selection: the CUDA kernel, its wrapper and its plain
PyTorch version.

``candidate_select(own, bcast, offsets, trim, median)``
    [N, P] coordinate-wise median (``median=True``) or ``trim``-trimmed
    mean over the static circulant candidate stack {own_i} ∪
    {bcast[(i + o) mod N]} (median and trimmed mean under ``tpu.exchange:
    ppermute``).  Replaces the Pallas kernel
    ``murmura_tpu/ops/pallas_agg.py: fused_candidate_select``.

The kernel lives in ``csrc/candidate_select.cu`` (design and bound notes
there).  It takes float32 or bfloat16 and computes in float32, rounding to
the input dtype once; the plain version does the same arithmetic in the same
order (a sort, then the middle pair's mean or the ascending window sum times
float32(1 / window)), so the two agree bit for bit.  On a CUDA tensor the
wrapper plans the launch (:func:`candidate_plan`: the staged path's tile
width, ring and grid, or the direct path for large N; copy and store widths
from the rows' alignment) and launches the kernel or raises; on a CPU tensor
it runs the plain version.  ``LAUNCHES`` and ``PLAIN_CALLS`` count both.
"""

import functools
import math
from typing import Dict, Sequence

import numpy as np
import torch

from murmura_tpu_torch.ops import _build
from murmura_tpu_torch.ops.agg_kernels import (
    MAX_OFFSETS, _offsets_on, _sm_count, check_cuda, raise_on,
)

NAME = "candidate_select"
LAUNCHES: Dict[str, int] = {NAME: 0}
PLAIN_CALLS: Dict[str, int] = {NAME: 0}
DTYPES = (torch.float32, torch.bfloat16)

# Launch constants, the same as csrc/candidate_select.cu's (checked when the
# library loads): threads a block, ring slots, adjacent columns a thread,
# narrowest staged tile, dynamic shared memory a block may take, the m with
# a static network (bit m set: the ring's 3 and k-regular(4)'s 5); and the
# shared memory of one SM.
THREADS = 256
STAGES = 3
CPT = 4
MIN_TC = 32
SMEM_MAX = 232448
STATIC_M = (1 << 3) | (1 << 5)
_SMEM_SM = 233472
# Ring bytes that leave room for two blocks on an SM; the widest tile
# under it, else under SMEM_MAX (one block an SM).
_RING_TARGET = 110 * 1024
_MAX_TC_LOG2 = 11

_LIB = None


def reset_counts() -> None:
    LAUNCHES[NAME] = 0
    PLAIN_CALLS[NAME] = 0


def bind(lib):
    """Set the C signatures on a loaded candidate_select library and check
    its launch constants against this module's."""
    import ctypes

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cand_select.argtypes = [
        vp, vp, vp, i32, vp, i32, i64, i32, i32, ctypes.c_float, i32,
        i32, i32, i32, i32, i32, vp,
    ]
    lib.cand_select.restype = i32
    consts = (ctypes.c_int * 6)()
    lib.cand_constants(consts)
    want = (THREADS, STAGES, CPT, MIN_TC, SMEM_MAX, STATIC_M)
    if tuple(consts) != want:
        raise RuntimeError(
            f"candidate_select.cu's constants {tuple(consts)} differ from the wrapper's {want}"
        )
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load("candidate_select"))
    return _LIB


@functools.lru_cache(maxsize=256)
def candidate_plan(n: int, p: int, elem: int, cb: int, sms: int) -> Dict[str, int]:
    """One launch's plan.  Staged path (``grid`` > 0): the widest
    power-of-two tile of at least MIN_TC columns whose ring of 2N rows
    leaves room for two blocks on an SM, else one; a persistent grid of at
    most that many blocks an SM, none without a tile.  Direct path
    (``grid`` 0): when no such tile fits, or when ``cb`` is 0 (rows that
    cp.async cannot copy: bfloat16 rows on 2 bytes)."""
    if cb:
        for limit in (_RING_TARGET, SMEM_MAX):
            for log2 in range(_MAX_TC_LOG2, MIN_TC.bit_length() - 2, -1):
                smem = STAGES * 2 * n * (1 << log2) * elem
                if smem <= limit:
                    per_sm = max(1, min(2, _SMEM_SM // (smem + 1024)))
                    tiles = math.ceil(p / (1 << log2))
                    return {"tc_log2": log2, "smem": smem, "grid": min(tiles, per_sm * sms)}
    return {"tc_log2": 0, "smem": 0, "grid": 0}


def _widest(choices, row_bytes: int, *tensors: torch.Tensor) -> int:
    """The first of ``choices`` (bytes) that divides the row length in bytes
    and every tensor's base address, else 0."""
    for w in choices:
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 0


def copy_bytes(p: int, own: torch.Tensor, bcast: torch.Tensor) -> int:
    """Width of the staged path's cp.async copies: 16, 8 or 4 bytes, the
    widest on which every row of own and bcast starts; 0 when none is."""
    return _widest((16, 8, 4), p * own.element_size(), own, bcast)


def store_elems(p: int, out: torch.Tensor) -> int:
    """Elements a store of the staged path writes: 4, 2 or 1, the widest
    word on which every output row starts."""
    elem = out.element_size()
    return _widest((4 * elem, 2 * elem), p * elem, out) // elem or 1


def _inv_keep(m: int, trim: int) -> float:
    """float32(1 / (m - 2 trim)): the trimmed mean multiplies by it."""
    return float(np.float32(1.0) / np.float32(m - 2 * trim))


def _check(own, bcast, offsets, trim: int, median: bool) -> int:
    """The candidate count m, after the checks both versions share."""
    if own.shape != bcast.shape or own.dim() != 2:
        raise ValueError(
            f"{NAME}: own {tuple(own.shape)} and bcast {tuple(bcast.shape)} must be one [N, P] shape"
        )
    k = len(offsets)
    if not 1 <= k <= MAX_OFFSETS:
        raise ValueError(f"{NAME}: takes 1..{MAX_OFFSETS} offsets, got {k}")
    m = k + 1
    if not median and (trim < 0 or m - 2 * trim < 1):
        raise ValueError(f"{NAME}: trim {trim} leaves no candidate of {m}")
    return m


def candidate_select_plain(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int],
    trim: int = 0, median: bool = False,
) -> torch.Tensor:
    """The candidate stack built P-chunked, sorted along the candidate axis
    in float32, reduced as the kernel reduces it, cast to the input dtype."""
    from murmura_tpu_torch.aggregation.base import circulant_candidate_map

    m = _check(own, bcast, offsets, trim, median)
    PLAIN_CALLS[NAME] += 1
    inv = torch.tensor(_inv_keep(m, trim), dtype=torch.float32, device=own.device)

    def reduce(cand):  # [m, N, c] -> [N, c]
        r = torch.sort(cand.to(torch.float32), dim=0).values
        if median:
            res = 0.5 * (r[(m - 1) // 2] + r[m // 2])
        else:
            acc = r[trim]
            for j in range(trim + 1, m - trim):  # ascending, as the kernel sums
                acc = acc + r[j]
            res = acc * inv
        return res.to(own.dtype)

    return circulant_candidate_map(own, bcast, offsets, reduce)


def launch(lib, own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int],
           trim: int, median: bool, out: torch.Tensor) -> None:
    """Plan and launch ``lib``'s kernel on checked CUDA tensors into out."""
    n, p = own.shape
    m = len(offsets) + 1
    trim = 0 if median else int(trim)
    cb = copy_bytes(p, own, bcast)
    plan = candidate_plan(n, p, own.element_size(), cb, _sm_count(own.device))
    offs = _offsets_on(tuple(int(o) % n for o in offsets), own.device)
    err = lib.cand_select(
        own.data_ptr(), bcast.data_ptr(), offs.data_ptr(), m - 1, out.data_ptr(),
        n, p, trim, int(median), _inv_keep(m, trim), int(own.dtype == torch.bfloat16),
        plan["tc_log2"], cb, store_elems(p, out), plan["grid"],
        plan["smem"], torch.cuda.current_stream(own.device).cuda_stream,
    )
    raise_on(NAME, err)


def candidate_select(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int],
    trim: int = 0, median: bool = False,
) -> torch.Tensor:
    """[N, P] median or trimmed mean over {own_i} ∪ {bcast[(i + o) mod N]}."""
    if own.device.type == "cpu" and bcast.device.type == "cpu":
        return candidate_select_plain(own, bcast, offsets, trim, median)
    _check(own, bcast, offsets, trim, median)
    check_cuda(NAME, own, bcast, dtypes=DTYPES)
    if own.numel() == 0:
        raise ValueError(f"{NAME}: empty input {tuple(own.shape)}")
    out = torch.empty_like(own)
    launch(_lib(), own, bcast, offsets, trim, median, out)
    LAUNCHES[NAME] += 1
    return out
