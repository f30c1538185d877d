"""Count-Sketch: the CUDA kernel, its wrapper, its plain PyTorch version and
the bucket-sorted table layout the kernel reads.

``count_sketch(v, tables)``
    [R, S] sketches out[r, s] = sum over p with hash[p] == s of
    sign[p] * v[r, p] (Sketchguard's filter space).  Replaces the Pallas
    kernel ``murmura_tpu/ops/pallas_sketch.py: count_sketch_pallas``.

The kernel lives in ``csrc/count_sketch.cu`` (design and bound notes
there).  It reads the hash and sign tables in a layout built once on the
host by :func:`sketch_layout`: every slice of ``SLICE_LEN`` columns sorted
by bucket, so that each thread of the kernel sums whole buckets in a fixed
order and the result is the same from run to run.  :func:`sketch_plan`
plans a launch (grid, buckets a thread, shared memory, partial buffer)
once per shape and card.  The plain version is ``index_add_``, which sums
in another order: the two agree to float32 reordering, not bit for bit.
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version.  ``LAUNCHES`` and ``PLAIN_CALLS`` count
both.
"""

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from murmura_tpu_torch.ops import _build
from murmura_tpu_torch.ops.agg_kernels import _sm_count, _vec, check_cuda, raise_on

NAME = "count_sketch"
LAUNCHES: Dict[str, int] = {NAME: 0}
PLAIN_CALLS: Dict[str, int] = {NAME: 0}

# Columns per slice of the layout: the kernel's ring of STAGES slots, each
# ROW_GROUP rows of float32 and the slice's 16-bit entries, fits one block.
SLICE_LEN = 4096
# Launch constants, the same as csrc/count_sketch.cu's (checked when the
# library loads): threads a walk block, ring slots, rows a walk serves,
# buckets a thread at most, dynamic shared memory a block may take.
THREADS = 512
STAGES = 3
ROW_GROUP = 4
KB_MAX = 8
SMEM_MAX = 232448

_LIB = None


def reset_counts() -> None:
    LAUNCHES[NAME] = 0
    PLAIN_CALLS[NAME] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("count_sketch")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sketch_count.argtypes = [
            vp, vp, vp, i32, i64, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp,
        ]
        lib.sketch_count.restype = i32
        consts = (ctypes.c_int * 5)()
        lib.sketch_constants(consts)
        if tuple(consts) != (THREADS, STAGES, ROW_GROUP, KB_MAX, SMEM_MAX):
            raise RuntimeError(
                f"count_sketch.cu's constants {tuple(consts)} differ from the "
                f"wrapper's {(THREADS, STAGES, ROW_GROUP, KB_MAX, SMEM_MAX)}"
            )
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=256)
def sketch_plan(rows: int, p: int, s: int, slice_len: int, sms: int) -> Dict[str, int]:
    """Grid (gx slice ranges x row groups x bucket chunks), buckets a thread
    (kb), shared memory and partial-buffer floats of one launch: one block
    an SM, so gx = SMs / (row groups x chunks), at most the slice count."""
    smem = STAGES * (ROW_GROUP * slice_len * 4 + slice_len * 2)
    if smem > SMEM_MAX:
        raise ValueError(
            f"{NAME}: a ring of {STAGES} slices of {slice_len} columns takes {smem} "
            f"bytes of shared memory; a block may take {SMEM_MAX}"
        )
    slices = max(1, math.ceil(p / slice_len))
    chunks = math.ceil(s / (KB_MAX * THREADS))
    kb = 1
    while kb < KB_MAX and kb * THREADS < s:
        kb *= 2
    gy = math.ceil(rows / ROW_GROUP)
    if gy > 65535 or chunks > 65535:
        raise ValueError(f"{NAME}: {rows} rows x {s} buckets exceed the launch grid")
    gx = max(1, min(slices, sms // (gy * chunks)))
    return {"gx": gx, "gy": gy, "chunks": chunks, "kb": kb, "smem": smem,
            "part_floats": gx * rows * s}


def sketch_layout(
    hash_table: np.ndarray, sign_table: np.ndarray, sketch_size: int,
    slice_len: int = SLICE_LEN,
) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's tables: (entries uint16 [slices L], starts int32
    [slices, S+1]).

    Slice t covers columns [t L, (t + 1) L).  Its entries, in
    ``entries[t L : t L + len]``, are its positions sorted by bucket (stably,
    so ascending within a bucket), each stored as the position inside the
    slice in the low 15 bits and the sign (set = -1) in the top bit; bucket
    s's run is ``starts[t, s] .. starts[t, s + 1]``.  The last slice's
    entries are padded with zeros to L, so that the kernel copies every
    slice's entries as whole 16-byte pieces (L is a multiple of 8).
    """
    if not 1 <= slice_len <= 1 << 15:
        raise ValueError(f"slice_len {slice_len} does not fit 15 bits of position")
    if slice_len % 8:
        raise ValueError(f"slice_len {slice_len} is not a multiple of 8")
    if not np.all(np.abs(sign_table) == 1.0):
        raise ValueError("the sign table must hold only +1 and -1")
    p = int(hash_table.shape[0])
    slices = max(1, math.ceil(p / slice_len))
    slice_id = np.arange(p, dtype=np.int64) // slice_len
    key = slice_id * sketch_size + hash_table.astype(np.int64)
    order = np.argsort(key, kind="stable")
    local = order - slice_id[order] * slice_len
    entries = np.zeros(slices * slice_len, dtype=np.uint16)
    entries[:p] = local | ((sign_table[order] < 0).astype(np.int64) << 15)
    counts = np.bincount(key, minlength=slices * sketch_size).reshape(slices, sketch_size)
    starts = np.zeros((slices, sketch_size + 1), dtype=np.int32)
    starts[:, 1:] = np.cumsum(counts, axis=1)
    return entries, starts


class SketchTables:
    """Hash and sign tables of one (model_dim, sketch_size, seed), with the
    kernel's layout, built once on the host.  Each side moves only what it
    reads to a device, once: the kernel its layout, the plain version the
    hash and sign tables."""

    def __init__(self, hash_table: np.ndarray, sign_table: np.ndarray, sketch_size: int,
                 slice_len: int = SLICE_LEN):
        self.sketch_size = int(sketch_size)
        self.model_dim = int(hash_table.shape[0])
        self.slice_len = int(slice_len)
        self.hash = np.asarray(hash_table, dtype=np.int32)
        self.sign = np.asarray(sign_table, dtype=np.float32)
        self.entries, self.starts = sketch_layout(
            self.hash, self.sign, self.sketch_size, self.slice_len)
        self._plain: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._kernel: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def plain_on(self, device) -> Dict[str, torch.Tensor]:
        """hash (int64) and sign on ``device``."""
        device = torch.device(device)
        if device not in self._plain:
            self._plain[device] = {
                "hash": torch.from_numpy(self.hash.astype(np.int64)).to(device),
                "sign": torch.from_numpy(self.sign).to(device),
            }
        return self._plain[device]

    def kernel_on(self, device) -> Dict[str, torch.Tensor]:
        """entries (int16 bits) and starts on ``device``."""
        device = torch.device(device)
        if device not in self._kernel:
            self._kernel[device] = {
                "entries": torch.from_numpy(self.entries.view(np.int16)).to(device),
                "starts": torch.from_numpy(self.starts).to(device),
            }
        return self._kernel[device]


def count_sketch_plain(v: torch.Tensor, tables: SketchTables) -> torch.Tensor:
    """``index_add_`` of the sign-flipped rows into their buckets."""
    PLAIN_CALLS[NAME] += 1
    t = tables.plain_on(v.device)
    out = torch.zeros((v.shape[0], tables.sketch_size), dtype=torch.float32, device=v.device)
    return out.index_add_(1, t["hash"], t["sign"] * v.to(torch.float32))


def count_sketch(v: torch.Tensor, tables: SketchTables) -> torch.Tensor:
    """[R, S] Count-Sketches of the float32 rows of ``v`` [R, P]."""
    if v.dim() != 2 or v.shape[1] != tables.model_dim:
        raise ValueError(
            f"{NAME}: expected [rows, {tables.model_dim}], got {tuple(v.shape)}"
        )
    if v.device.type == "cpu":
        return count_sketch_plain(v, tables)
    check_cuda(NAME, v)
    rows, p = v.shape
    s = tables.sketch_size
    if rows == 0:
        raise ValueError(f"{NAME}: empty input {tuple(v.shape)}")
    t = tables.kernel_on(v.device)
    plan = sketch_plan(rows, p, s, tables.slice_len, _sm_count(v.device))
    work = torch.empty(rows * s + plan["part_floats"], dtype=torch.float32, device=v.device)
    err = _lib().sketch_count(
        v.data_ptr(), t["entries"].data_ptr(), t["starts"].data_ptr(), rows, p, s,
        tables.slice_len, _vec(p, v), plan["kb"], plan["gx"], plan["chunks"], plan["smem"],
        work.data_ptr() + 4 * rows * s, work.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    raise_on(NAME, err)
    LAUNCHES[NAME] += 1
    return work.as_strided((rows, s), (s, 1))
