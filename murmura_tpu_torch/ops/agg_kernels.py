"""Krum's two distance passes: CUDA kernels, their wrappers and their plain
PyTorch versions.

``pairwise_sq_distances``
    [N, M] squared distances D2[i, j] = |a_i|^2 + |b_j|^2 - 2 a_i . b_j,
    a Gram product and both squared norms streamed over P and combined at
    the end (dense Krum, ``tpu.exchange: allgather``).  Replaces the Pallas
    kernel ``murmura_tpu/ops/pallas_agg.py: pairwise_sq_distances``.
``circulant_sq_distances``
    [k, N] squared distances D2[o, i] = |own_i - bcast[(i + o) mod N]|^2 for
    all k offsets in one pass (circulant Krum, ``tpu.exchange: ppermute``).
    Replaces ``murmura_tpu/ops/pallas_agg.py: circulant_sq_distances``.

The kernels live in ``csrc/agg_distances.cu`` (design and bound notes
there).  Each wrapper checks device, dtype (float32), contiguity and shapes,
allocates the output and the split-P partial buffers with ``torch.empty``
and launches on the current stream.  On a CUDA tensor it launches its
kernel or raises; on a CPU tensor it runs the plain version, which is what
the CPU tests exercise.  ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` counts plain-version calls, so a run can show which path it
took.
"""

import ctypes
import math
from typing import Dict, Optional, Sequence

import torch

from murmura_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {"pairwise_sq_distances": 0, "circulant_sq_distances": 0}
PLAIN_CALLS: Dict[str, int] = {"pairwise_sq_distances": 0, "circulant_sq_distances": 0}

# The circulant kernel reads its offsets from a small device array.
MAX_OFFSETS = 256
# Target resident blocks per SM when choosing the number of P slices.
_BLOCKS_PER_SM = 4
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
            vp, vp, vp, vp, vp, vp, i32, i32, i64, i64, i32, i32, vp,
        ]
        lib.agg_pairwise_sq_distances.restype = i32
        lib.agg_circulant_sq_distances.argtypes = [
            vp, vp, vp, i32, vp, vp, i32, i64, i64, i32, vp,
        ]
        lib.agg_circulant_sq_distances.restype = i32
        for fn in ("agg_pw_tile", "agg_pw_chunk", "agg_ci_pairs_per_block", "agg_ci_chunk"):
            getattr(lib, fn).restype = i32
        _SIGNED = True
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors (or CPU tensors for the plain version), got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} vs {dev})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected [rows, P] tensors, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _slices(p: int, chunk: int, tiles: int, device: torch.device):
    """(slice length, splits): P cut into slices of whole chunks, enough of
    them that tiles x splits blocks fill every SM a few times over."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, math.ceil(p / chunk))
    want = max(1, min(chunks, 65535, math.ceil(_BLOCKS_PER_SM * sms / tiles)))
    slice_len = math.ceil(chunks / want) * chunk
    return slice_len, max(1, math.ceil(p / slice_len))


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# pairwise
# ---------------------------------------------------------------------------


def pairwise_sq_distances_plain(
    a: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The Gram/norm formula in float32 (``b=None``: all pairs of ``a``)."""
    PLAIN_CALLS["pairwise_sq_distances"] += 1
    a = a.to(torch.float32)
    b = a if b is None else b.to(torch.float32)
    sq_a = (a * a).sum(-1)
    sq_b = sq_a if b is a else (b * b).sum(-1)
    return sq_a[:, None] + sq_b[None, :] - 2.0 * (a @ b.T)


def pairwise_sq_distances(
    a: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[N, M] squared distances between the rows of ``a`` and of ``b``
    (``b=None``: ``b`` is ``a``, and the kernel reads it once)."""
    if a.device.type == "cpu" and (b is None or b.device.type == "cpu"):
        return pairwise_sq_distances_plain(a, b)
    name = "pairwise_sq_distances"
    same = b is None or b is a
    b = a if same else b
    _check_cuda(name, a, b)
    n, p = a.shape
    m = b.shape[0]
    if b.shape[1] != p:
        raise ValueError(f"{name}: P differs ({p} vs {b.shape[1]})")
    lib = _lib()
    tile = lib.agg_pw_tile()
    tiles = math.ceil(n / tile) * math.ceil(m / tile)
    slice_len, splits = _slices(p, lib.agg_pw_chunk(), tiles, a.device)
    out = torch.empty((n, m), dtype=torch.float32, device=a.device)
    part_g = torch.empty((splits, n, m), dtype=torch.float32, device=a.device)
    part_sa = torch.empty((splits, n), dtype=torch.float32, device=a.device)
    part_sb = torch.empty((splits, m), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.agg_pairwise_sq_distances(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), part_g.data_ptr(),
        part_sa.data_ptr(), part_sb.data_ptr(), n, m, p, slice_len, splits,
        int(same), stream,
    )
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


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


def circulant_sq_distances(
    own: torch.Tensor, bcast: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """[k, N] squared distances |own_i - bcast[(i + o) mod N]|^2."""
    if own.device.type == "cpu" and bcast.device.type == "cpu":
        return circulant_sq_distances_plain(own, bcast, offsets)
    name = "circulant_sq_distances"
    _check_cuda(name, own, bcast)
    if own.shape != bcast.shape:
        raise ValueError(f"{name}: own {tuple(own.shape)} != bcast {tuple(bcast.shape)}")
    k = len(offsets)
    if not 1 <= k <= MAX_OFFSETS:
        raise ValueError(f"{name}: takes 1..{MAX_OFFSETS} offsets, got {k}")
    n, p = bcast.shape
    lib = _lib()
    groups = math.ceil(k * n / lib.agg_ci_pairs_per_block())
    slice_len, splits = _slices(p, lib.agg_ci_chunk(), groups, bcast.device)
    offs = torch.tensor(
        [int(o) % n for o in offsets], dtype=torch.int32
    ).to(bcast.device, non_blocking=True)
    out = torch.empty((k, n), dtype=torch.float32, device=bcast.device)
    part = torch.empty((splits, k, n), dtype=torch.float32, device=bcast.device)
    stream = torch.cuda.current_stream(bcast.device).cuda_stream
    err = lib.agg_circulant_sq_distances(
        own.data_ptr(), bcast.data_ptr(), offs.data_ptr(), k, out.data_ptr(),
        part.data_ptr(), n, p, slice_len, splits, stream,
    )
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out
