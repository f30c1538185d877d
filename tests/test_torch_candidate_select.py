"""Fused candidate selection in the PyTorch port (murmura_tpu_torch/ops/
candidate_kernels.py) against the JAX package, on the CPU.

The plain version (which the wrapper runs for CPU tensors) is held bit for
bit (``np.array_equal``) against both JAX paths: the Pallas kernel
``pallas_agg.fused_candidate_select`` in interpret mode, and the lax path
of ``make_coordinate_median`` / ``make_trimmed_mean`` over the circulant
candidate stack.  The plain version sums the trimmed window in ascending
order and multiplies by float32(1 / window), which is how XLA lowers the
JAX package's division by a constant, so equality is exact in float32 and
in bfloat16.  The kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.robust_stats import (
    make_coordinate_median as jax_median,
    make_trimmed_mean as jax_trimmed,
)
from murmura_tpu.ops import pallas_agg
from murmura_tpu_torch.aggregation import base
from murmura_tpu_torch.ops import candidate_kernels as C

TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _offsets(n):
    return sorted({1, 2, n - 2, n - 1})


def _states(n, p, dtype, seed):
    rng = np.random.default_rng(seed)
    own = rng.normal(size=(n, p)).astype(np.float32)
    bcast = own + 0.3 * rng.normal(size=(n, p)).astype(np.float32)
    bcast[: max(1, n // 5)] += 10.0 * rng.normal(size=(max(1, n // 5), p)).astype(np.float32)
    j_own = jnp.asarray(own).astype(dtype)
    j_b = jnp.asarray(bcast).astype(dtype)
    # The same bits on both sides: numpy has no bfloat16, so go through float32.
    t_own = torch.from_numpy(np.array(j_own.astype(jnp.float32))).to(TO_TORCH[dtype])
    t_b = torch.from_numpy(np.array(j_b.astype(jnp.float32))).to(TO_TORCH[dtype])
    return j_own, j_b, t_own, t_b


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("median,trim", [(True, 0), (False, 0), (False, 1)])
@pytest.mark.parametrize("n", [64, 16, 12, 10])
def test_plain_equals_pallas_interpret_and_lax(n, median, trim, dtype):
    p = 3001
    offsets = _offsets(n)
    j_own, j_b, t_own, t_b = _states(n, p, dtype, seed=n * 10 + trim)
    got = C.candidate_select(t_own, t_b, offsets, trim=trim, median=median)
    assert got.dtype == TO_TORCH[dtype] and got.shape == (n, p)

    pal = pallas_agg.fused_candidate_select(
        j_own, j_b, offsets, trim=trim, median=median, interpret=True
    )
    assert np.array_equal(_np(got), np.asarray(pal.astype(jnp.float32)))

    if median:
        rule = jax_median(exchange_offsets=offsets)
    else:
        m = len(offsets) + 1
        rule = jax_trimmed(trim_ratio=(trim + 0.5) / m, exchange_offsets=offsets)
    lax, _, _ = rule.aggregate(j_own, j_b, None, jnp.asarray(0.0), {}, JaxCtx())
    assert np.array_equal(_np(got), np.asarray(lax.astype(jnp.float32)))


def test_plain_chunked_equals_unchunked(monkeypatch):
    _, _, own, b = _states(16, 700, "float32", seed=3)
    whole = C.candidate_select_plain(own, b, [1, 2, 14, 15], trim=1)
    monkeypatch.setattr(base, "_CIRCULANT_CHUNK_BYTES", 16 * 5 * 4 * 64)  # 64-column chunks
    chunked = C.candidate_select_plain(own, b, [1, 2, 14, 15], trim=1)
    assert torch.equal(whole, chunked)


def test_nan_and_inf_sort_as_torch_sort():
    # NaN sorts after every number, as in torch.sort and the JAX lax path.
    own = torch.tensor([[1.0, float("nan"), -float("inf")], [2.0, 0.0, 5.0], [3.0, 1.0, 4.0]])
    b = torch.tensor([[float("inf"), 2.0, 1.0], [0.0, float("nan"), 2.0], [9.0, 3.0, 0.0]])
    got = C.candidate_select(own, b, [1, 2], median=True)
    lax, _, _ = jax_median(exchange_offsets=[1, 2]).aggregate(
        jnp.asarray(own.numpy()), jnp.asarray(b.numpy()), None, jnp.asarray(0.0), {}, JaxCtx()
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(lax))


def test_wrapper_counts_and_refusals():
    C.reset_counts()
    a = torch.zeros((4, 8))
    C.candidate_select(a, a, [1], median=True)
    assert C.PLAIN_CALLS == {"candidate_select": 1} and C.LAUNCHES == {"candidate_select": 0}
    with pytest.raises(ValueError, match="leaves no candidate"):
        C.candidate_select(a, a, [1, 2], trim=2)
    with pytest.raises(ValueError, match="one \\[N, P\\] shape"):
        C.candidate_select(a, a[:, :4], [1], median=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        m = torch.empty((4, 8), device="meta")
        C.candidate_select(m, m, [1], median=True)


class TestLaunchPlan:
    """The wrapper's plan (plain Python; the kernel runs on the card)."""

    FLAGSHIP_P = 6_603_710  # leaf.femnist.baseline, 2 mod 4
    H100_SMS = 132

    def test_flagship_plans(self):
        # [16, P] float32: 256-column tiles, a 96 kB ring, two blocks an SM.
        assert C.candidate_plan(16, self.FLAGSHIP_P, 4, 8, self.H100_SMS) == {
            "tc_log2": 8, "smem": 98304, "grid": 264}
        # bfloat16: twice the columns in the same bytes; at N = 64, 128.
        assert C.candidate_plan(16, self.FLAGSHIP_P, 2, 4, self.H100_SMS) == {
            "tc_log2": 9, "smem": 98304, "grid": 264}
        assert C.candidate_plan(64, self.FLAGSHIP_P, 2, 4, self.H100_SMS) == {
            "tc_log2": 7, "smem": 98304, "grid": 264}

    @pytest.mark.parametrize("elem,last", [(4, 302), (2, 605)])
    def test_large_n_takes_the_direct_path(self, elem, last):
        plan = C.candidate_plan(last, 10_000, elem, 4, self.H100_SMS)
        assert plan["tc_log2"] == 5 and plan["smem"] <= C.SMEM_MAX
        assert plan["grid"] == self.H100_SMS  # one block an SM
        assert C.candidate_plan(last + 1, 10_000, elem, 4, self.H100_SMS)["grid"] == 0
        assert C.candidate_plan(1300, 257, elem, 4, self.H100_SMS)["grid"] == 0

    def test_rows_that_cp_async_cannot_copy_take_the_direct_path(self):
        assert C.candidate_plan(16, 1001, 2, 0, self.H100_SMS)["grid"] == 0

    def test_fewer_tiles_than_blocks(self):
        plan = C.candidate_plan(5, 100, 4, 4, self.H100_SMS)
        assert plan["grid"] == -(-100 // (1 << plan["tc_log2"])) == 1

    @pytest.mark.parametrize(
        "dtype,p,copy,store",
        [(torch.float32, 1000, 16, 4), (torch.float32, 1002, 8, 2), (torch.float32, 1001, 4, 1),
         (torch.bfloat16, 1000, 16, 4), (torch.bfloat16, 1002, 4, 2), (torch.bfloat16, 1004, 8, 4),
         (torch.bfloat16, 1001, 0, 1)],
    )
    def test_copy_and_store_widths_follow_alignment(self, dtype, p, copy, store):
        x = torch.zeros((3, p), dtype=dtype)
        assert x.data_ptr() % 64 == 0
        assert C.copy_bytes(p, x, x) == copy
        assert C.store_elems(p, x) == store
        off = torch.zeros(3 * p + 1, dtype=dtype)[1:].view(3, p)  # one element off
        assert C.copy_bytes(p, off, x) == (4 if dtype == torch.float32 else 0)
