"""Count-Sketch in the PyTorch port (murmura_tpu_torch/ops/sketch.py,
ops/sketch_kernels.py) against the JAX package, on the CPU.

- ``make_sketch_tables`` draws the JAX package's hash and sign tables bit
  for bit (the same numpy RandomState stream).
- The plain version (``index_add_``, which the wrapper runs for CPU
  tensors) agrees with ``jax.ops.segment_sum`` (``ops/sketch.count_sketch``)
  and with ``count_sketch_pallas`` in interpret mode to within float32
  reordering: |Δ out[s]| <= 1e-5 · Σ_{p: hash=s} |v_p|.
- The bucket-sorted layout the kernel reads reproduces the sketch when it
  is summed the kernel's way (a numpy rendering of the two passes of
  csrc/count_sketch.cu: blocks over contiguous slice ranges, then the sum
  pass in block order), so the layout code and the summation order, which
  the card cannot check against the JAX package, are checked here; and the
  launch plan keeps the partial buffer to one [R, S] a block along P.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murmura_tpu.ops.pallas_sketch import count_sketch_pallas
from murmura_tpu.ops.sketch import count_sketch as jax_count_sketch
from murmura_tpu.ops.sketch import make_sketch_tables as jax_tables
from murmura_tpu_torch.ops import sketch_kernels as SK
from murmura_tpu_torch.ops.sketch import build_sketch_tables, count_sketch, make_sketch_tables


def _bucket_abs(v, hash_t, s):
    """Σ_{p: hash=s} |v_p| per row: the reordering tolerance's scale."""
    out = np.zeros((v.shape[0], s))
    for r in range(v.shape[0]):
        out[r] = np.bincount(hash_t, weights=np.abs(v[r]).astype(np.float64), minlength=s)
    return out


@pytest.mark.parametrize("model_dim,sketch_size,seed", [(5000, 100, 42), (20_000, 1000, 7), (1, 3, 0)])
def test_tables_are_the_jax_packages(model_dim, sketch_size, seed):
    h, s = make_sketch_tables(model_dim, sketch_size, seed)
    jh, js = jax_tables(model_dim, sketch_size, seed)
    assert h.dtype == jh.dtype and s.dtype == js.dtype
    assert np.array_equal(h, jh) and np.array_equal(s, js)


@pytest.mark.parametrize("rows,model_dim,sketch_size", [(3, 20_000, 1000), (16, 50_000, 1000), (2, 777, 7)])
def test_plain_matches_segment_sum_and_pallas(rows, model_dim, sketch_size):
    rng = np.random.default_rng(model_dim)
    v = rng.normal(size=(rows, model_dim)).astype(np.float32)
    tables = build_sketch_tables(model_dim, sketch_size, 42)
    SK.reset_counts()
    got = count_sketch(torch.from_numpy(v), tables).numpy()
    assert SK.PLAIN_CALLS["count_sketch"] == 1 and SK.LAUNCHES["count_sketch"] == 0
    assert got.shape == (rows, sketch_size)
    jh, js = (jnp.asarray(t) for t in jax_tables(model_dim, sketch_size, 42))
    limit = 1e-5 * _bucket_abs(v, tables.hash, sketch_size)
    for r in range(rows):
        ref = np.asarray(jax_count_sketch(jnp.asarray(v[r]), jh, js, sketch_size, use_pallas=False))
        assert np.all(np.abs(got[r] - ref) <= limit[r])
        if sketch_size <= 2048 and r == 0:
            pal = np.asarray(count_sketch_pallas(jnp.asarray(v[r]), jh, js, sketch_size, interpret=True))
            assert np.all(np.abs(got[r] - pal) <= limit[r])


def test_vector_input_gives_one_sketch():
    tables = build_sketch_tables(300, 11, 3)
    v = torch.from_numpy(np.random.default_rng(1).normal(size=300).astype(np.float32))
    assert torch.equal(count_sketch(v, tables), count_sketch(v[None], tables)[0])


def _kernel_way(v, entries, starts, slice_len, gx):
    """The two passes of csrc/count_sketch.cu in numpy float32: block x of
    the gx blocks along P sums each bucket's runs of entries over its
    contiguous slice range, in layout order and slice after slice, into one
    running sum a (row, bucket); then the sum pass: lane l of a warp adds
    the partials of blocks l, l + 32, ... in order, and the 32 lanes meet in
    the butterfly xor 16, 8, 4, 2, 1."""
    rows, p = v.shape
    slices, s1 = starts.shape
    part = np.zeros((gx, rows, s1 - 1), np.float32)
    for x in range(gx):
        t0, t1 = x * slices // gx, (x + 1) * slices // gx  # block x's slices
        acc = np.zeros((rows, s1 - 1), np.float32)
        for t in range(t0, t1):
            p0 = t * slice_len
            ent = entries[p0:p0 + min(slice_len, p - p0)].astype(np.int64)
            pos = ent & 0x7FFF
            sign = np.where(ent & 0x8000, -1.0, 1.0).astype(np.float32)
            vals = sign[None, :] * v[:, p0 + pos]  # [rows, len] in the layout's order
            run = np.diff(starts[t])
            for j in range(int(run.max(initial=0))):  # j-th entry of every longer run
                live = np.nonzero(run > j)[0]
                acc[:, live] = acc[:, live] + vals[:, starts[t, live] + j]
        part[x] = acc
    lanes = np.zeros((32, rows, s1 - 1), np.float32)
    for x in range(gx):
        lanes[x % 32] = lanes[x % 32] + part[x]
    for sh in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ sh]
    return lanes[0]


@pytest.mark.parametrize(
    "model_dim,sketch_size,slice_len,gx",
    [(5000, 37, 1024, 2), (3000, 5, 4096, 1), (1500, 200, 256, 6), (20_011, 1000, 4096, 5),
     (40_000, 7, 512, 40), (16_384, 100, 4096, 4), (70_001, 300, 1024, 33), (9000, 4096, 256, 3)],
)
def test_layout_reproduces_the_sketch(model_dim, sketch_size, slice_len, gx):
    h, s = make_sketch_tables(model_dim, sketch_size, 9)
    entries, starts = SK.sketch_layout(h, s, sketch_size, slice_len)
    slices = -(-model_dim // slice_len)
    assert entries.dtype == np.uint16 and starts.shape == (slices, sketch_size + 1)
    assert entries.shape == (slices * slice_len,) and not entries[model_dim:].any()
    assert int(starts[:, -1].sum()) == model_dim
    # Each slice's entries are a permutation of its positions, runs by bucket
    # (the last one a tail slice shorter than L unless L divides P).
    for t in range(slices):
        ln = min(slice_len, model_dim - t * slice_len)
        pos = entries[t * slice_len: t * slice_len + ln].astype(np.int64) & 0x7FFF
        assert np.array_equal(np.sort(pos), np.arange(ln))
        for b in (0, sketch_size - 1):
            run = pos[starts[t, b]:starts[t, b + 1]]
            assert np.all(h[t * slice_len + run] == b) and np.all(np.diff(run) > 0)
    v = np.random.default_rng(2).normal(size=(3, model_dim)).astype(np.float32)
    got = _kernel_way(v, entries, starts, slice_len, gx)
    tables = SK.SketchTables(h, s, sketch_size, slice_len)
    ref = SK.count_sketch_plain(torch.from_numpy(v), tables).numpy()
    assert np.all(np.abs(got - ref) <= 1e-5 * _bucket_abs(v, h, sketch_size))


@pytest.mark.parametrize(
    "rows,model_dim,sketch_size,sms",
    [(16, 6_603_710, 1000, 132), (64, 1 << 20, 1000, 132), (33, 20_011, 4096, 132),
     (1, 16_384, 1000, 132), (5, 40_000, 7, 114), (16, 100, 10_000, 132), (200, 50_000, 1000, 132)],
)
def test_plan_keeps_partials_to_one_row_a_block(rows, model_dim, sketch_size, sms):
    plan = SK.sketch_plan(rows, model_dim, sketch_size, SK.SLICE_LEN, sms)
    slices = -(-model_dim // SK.SLICE_LEN)
    blocks = plan["gx"] * plan["gy"] * plan["chunks"]
    assert plan["gy"] == -(-rows // SK.ROW_GROUP)
    assert plan["chunks"] * plan["kb"] * SK.THREADS >= sketch_size
    assert plan["kb"] <= SK.KB_MAX and plan["smem"] <= SK.SMEM_MAX
    # One block an SM, no block without a slice, partials of gx blocks only.
    assert 1 <= plan["gx"] <= slices and (blocks <= sms or plan["gx"] == 1)
    assert plan["part_floats"] == plan["gx"] * rows * sketch_size
    assert plan["part_floats"] <= blocks * rows * sketch_size
    if rows == 16 and model_dim == 6_603_710:  # the flagship: 33 x 16 x 1000, was 404 x 16 x 1000
        assert plan["gx"] == 33 and plan["part_floats"] == 528_000


def test_layout_refusals():
    h = np.zeros(10, np.int32)
    with pytest.raises(ValueError, match="15 bits"):
        SK.sketch_layout(h, np.ones(10, np.float32), 3, slice_len=1 << 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        SK.sketch_layout(h, np.ones(10, np.float32), 3, slice_len=1000 + 4)
    with pytest.raises(ValueError, match="shared memory"):
        SK.sketch_plan(2, 10, 3, 1 << 13, 132)
    with pytest.raises(ValueError, match="only \\+1 and -1"):
        SK.sketch_layout(h, np.zeros(10, np.float32), 3)
    tables = build_sketch_tables(10, 3, 0)
    with pytest.raises(ValueError, match="expected \\[rows, 10\\]"):
        count_sketch(torch.zeros((2, 11)), tables)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SK.count_sketch(torch.empty((2, 10), device="meta"), tables)


def test_each_side_moves_only_the_tables_it_reads():
    tables = build_sketch_tables(500, 7, 3)
    assert set(tables.plain_on("cpu")) == {"hash", "sign"}
    assert set(tables.kernel_on("cpu")) == {"entries", "starts"}
    assert tables.plain_on("cpu")["hash"] is tables.plain_on("cpu")["hash"]  # moved once
    assert torch.equal(tables.kernel_on("cpu")["starts"], torch.from_numpy(tables.starts))
