"""Krum's distance passes in the PyTorch port (murmura_tpu_torch/ops/
agg_kernels.py) against the JAX package: the lax path and the Pallas
kernels in interpret mode, as tests/test_pallas_agg.py runs them.

On the CPU each wrapper runs its plain version; the kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py, and
chip_smoke.py).  Tolerances follow tests/test_pallas_agg.py: rtol 1e-5,
atol 1e-4 on squared circulant distances; rtol 1e-4, atol 1e-2 on
pairwise distances (the Gram identity cancels; the pairwise inputs are
scaled so that the diagonal's cancellation noise, amplified by the square
root, stays inside that atol at the widest P here).

The pairwise plain version takes the center row the kernel subtracts as it
loads, and ``pairwise_l2_distances`` hands it the mean of ``a`` instead of
centered copies; its CPU result stays bit-equal to subtracting first.  The
launch plans (tile width, ring, grid) are plain Python and are checked
here; ``build_round_program`` defaults to the card and raises without one."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murmura_tpu.aggregation.base import (
    circulant_neighbor_distances as jax_circulant_distances,
    pairwise_l2_distances as jax_pairwise_distances,
)
from murmura_tpu.ops import pallas_agg
from murmura_tpu_torch.aggregation.base import (
    circulant_neighbor_distances,
    pairwise_l2_distances,
)
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.ops import agg_kernels as K


def _arrs(seed, n, p, m=None, scale=0.5):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(n, p)) * scale).astype(np.float32)
    b = (rng.normal(size=(m or n, p)) * scale).astype(np.float32)
    return a, b


def _deltas(offsets):
    return sorted({abs(b - a) for a in offsets for b in offsets if a != b})


# (n, p): aligned, ragged P, odd n, one column.
SHAPES = [(8, 256), (12, 300), (16, 1001), (5, 1)]


class TestPairwisePlain:
    @pytest.mark.parametrize("n,p", SHAPES)
    @pytest.mark.parametrize("same", [True, False])
    def test_plain_matches_pallas_interpret(self, n, p, same):
        # Both take the rows centered, as pairwise_l2_distances hands them.
        a, b = _arrs(n * 7 + p, n, p, scale=0.1)
        b = b - a.mean(axis=0, keepdims=True)
        a = a - a.mean(axis=0, keepdims=True)
        jb = None if same else jnp.asarray(b)
        ref = pallas_agg.pairwise_sq_distances(
            jnp.asarray(a), jnp.asarray(a) if same else jb, interpret=True
        )
        got = K.pairwise_sq_distances_plain(
            torch.from_numpy(a), None if same else torch.from_numpy(b)
        )
        np.testing.assert_allclose(
            np.sqrt(np.maximum(got.numpy(), 0)),
            np.sqrt(np.maximum(np.asarray(ref), 0)),
            rtol=1e-4, atol=1e-2,
        )

    @pytest.mark.parametrize("n,p,m", [(8, 256, 8), (10, 320, 6), (16, 1001, 16)])
    def test_distances_match_lax(self, n, p, m):
        a, b = _arrs(n + p + m, n, p, m, scale=0.1)
        ref = jax_pairwise_distances(jnp.asarray(a), jnp.asarray(b))
        got = pairwise_l2_distances(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-2)

    @pytest.mark.parametrize("n,p", SHAPES)
    def test_same_tensor_distances_match_lax(self, n, p):
        a, _ = _arrs(n + 3 * p, n, p, scale=0.1)
        ref = jax_pairwise_distances(jnp.asarray(a))
        got = pairwise_l2_distances(torch.from_numpy(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-2)

    def test_centering_guard_kept(self):
        # Clustered rows far from the origin: the centered Gram identity
        # must still resolve their small pairwise distances.
        rng = np.random.default_rng(3)
        base = rng.normal(size=(1, 512)).astype(np.float32) * 100.0
        a = base + rng.normal(size=(6, 512)).astype(np.float32) * 1e-2
        ref = jax_pairwise_distances(jnp.asarray(a))
        got = pairwise_l2_distances(torch.from_numpy(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-2)


class TestPairwiseCenter:
    @pytest.mark.parametrize("n,p,m", [(8, 256, 8), (12, 300, 5), (16, 1001, 16), (5, 1, 3)])
    @pytest.mark.parametrize("same", [True, False])
    def test_plain_center_matches_pallas_interpret(self, n, p, m, same):
        # Rows far from the origin, so that the center matters; the Pallas
        # kernel gets them centered, as its caller hands them.
        a, b = _arrs(n * 5 + p + m, n, p, m, scale=0.1)
        a, b = a + 3.0, b + 3.0
        c = a.mean(axis=0).astype(np.float32)
        ref = pallas_agg.pairwise_sq_distances(
            jnp.asarray(a - c), jnp.asarray(a - c if same else b - c), interpret=True
        )
        got = K.pairwise_sq_distances_plain(
            torch.from_numpy(a), None if same else torch.from_numpy(b),
            center=torch.from_numpy(c),
        )
        assert got.shape == (n, n if same else m)
        np.testing.assert_allclose(
            np.sqrt(np.maximum(got.numpy(), 0)),
            np.sqrt(np.maximum(np.asarray(ref), 0)),
            rtol=1e-4, atol=1e-2,
        )

    @pytest.mark.parametrize("n,p,m", [(8, 256, 8), (10, 320, 6), (16, 1001, 16), (5, 1, 3)])
    @pytest.mark.parametrize("same", [True, False])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_l2_distances_bit_equal_to_centered_copies(self, n, p, m, same, dtype):
        a, b = (torch.from_numpy(x + 2.0).to(dtype) for x in _arrs(n + 2 * p + m, n, p, m))
        got = pairwise_l2_distances(a, None if same else b)
        # The arithmetic before the center moved into the kernel: centered
        # float32 copies of both operands, then the Gram/norm formula.
        a32 = a.to(torch.float32)
        center = a32.mean(dim=0, keepdim=True)
        ac = (a32 - center).contiguous()
        bc = ac if same else (b.to(torch.float32) - center).contiguous()
        sq_a = (ac * ac).sum(-1)
        sq_b = sq_a if same else (bc * bc).sum(-1)
        want = torch.sqrt(torch.clamp(sq_a[:, None] + sq_b[None, :] - 2.0 * (ac @ bc.T), min=0.0))
        assert torch.equal(got, want)

    def test_center_none_is_the_old_formula(self):
        a, b = (torch.from_numpy(x) for x in _arrs(4, 6, 77, 5))
        zero = torch.zeros(77)
        assert torch.equal(
            K.pairwise_sq_distances_plain(a, b), K.pairwise_sq_distances_plain(a, b, center=zero)
        )


class TestLaunchPlans:
    FLAGSHIP_P = 6_603_710  # leaf.femnist.baseline
    H100_SMS = 132

    def test_flagship_plans(self):
        pw = K.pairwise_plan(16, 16, self.FLAGSHIP_P, False, self.H100_SMS)
        # 256-column tiles, a 3-slot ring of 34 kB slots, two blocks an SM.
        assert pw == {"tc_log2": 8, "smem": 104448, "tm": 1, "tn": 1, "gx": 264}
        # One tensor, one output tile: no b rows, so 512-column tiles.
        pw_same = K.pairwise_plan(16, 16, self.FLAGSHIP_P, True, self.H100_SMS)
        assert pw_same == {"tc_log2": 9, "smem": 105984, "tm": 1, "tn": 1, "gx": 264}
        # N = 64, one tensor: blocks of 64 x 32 (eight warp tiles) that
        # stage only rows of a; two tensors: 64 x 32 with rows of b would
        # force 64-column tiles, so 32 x 32 blocks of 128 columns.
        pw64 = K.pairwise_plan(64, 64, 1 << 20, True, self.H100_SMS)
        assert (pw64["tm"], pw64["tn"], pw64["tc_log2"]) == (4, 2, 7)
        pw64 = K.pairwise_plan(64, 64, 1 << 20, False, self.H100_SMS)
        assert (pw64["tm"], pw64["tn"], pw64["tc_log2"]) == (2, 2, 7)
        two = K.circulant_plan(16, self.FLAGSHIP_P, 4, False, 2, self.H100_SMS)
        assert two == {"tc_log2": 8, "smem": 99072, "gx": 264, "gy": 1}
        # One tensor: half the rows, twice the columns a tile.
        one = K.circulant_plan(16, self.FLAGSHIP_P, 4, True, 2, self.H100_SMS)
        assert one["tc_log2"] == 9 and one["smem"] <= 110 * 1024

    @pytest.mark.parametrize(
        "n,p,k,same,vec",
        [(16, 100_003, 4, False, 1), (3, 1, 2, False, 1), (70, 5000, 3, True, 2),
         (40, 777, 39, False, 1), (64, 1_048_576, 4, False, 2), (300, 4096, 8, False, 2),
         (2000, 64, 4, False, 2)],
    )
    def test_circulant_plan_fits(self, n, p, k, same, vec):
        plan = K.circulant_plan(n, p, k, same, vec, self.H100_SMS)
        tc = 1 << plan["tc_log2"]
        rows = n if same else 2 * n
        assert tc >= vec
        assert K.STAGES * rows * (tc + vec) * 4 <= plan["smem"] <= K.SMEM_MAX
        assert plan["smem"] >= K.THREADS * K.CI_KT * 4  # the final reduction
        units = -(-k // K.CI_KT) * n
        assert plan["gy"] * min(units, K.THREADS) >= units
        assert 1 <= plan["gx"] <= max(1, -(-p // tc))

    def test_circulant_plan_refuses_rows_beyond_shared_memory(self):
        with pytest.raises(ValueError, match="rows do not fit"):
            K.circulant_plan(5000, 1000, 4, False, 2, self.H100_SMS)
        K.circulant_plan(4000, 1000, 4, True, 2, self.H100_SMS)  # one tensor: fits

    @pytest.mark.parametrize("same", [True, False])
    @pytest.mark.parametrize("n,m,p", [(16, 16, 1000), (33, 20, 4099), (1, 17, 300), (256, 256, 1 << 20)])
    def test_pairwise_plan_fits(self, n, m, p, same):
        m = n if same else m
        plan = K.pairwise_plan(n, m, p, same, self.H100_SMS)
        tc = 1 << plan["tc_log2"]
        tm, tn = plan["tm"], plan["tn"]
        assert tm * tn in (1, 2, 4, 8) and tm <= -(-n // 16) and tn <= -(-m // 16)
        one_block_row = -(-n // (16 * tm)) == 1
        rows = 16 * tm + (0 if same and one_block_row else 16 * tn)
        assert tc % 8 == 0 and tc >= 128
        assert K.STAGES * (rows * (tc + 8) + tc) * 4 <= plan["smem"] <= K.SMEM_MAX
        assert 1 <= plan["gx"] <= -(-p // tc)

    def test_pairwise_plan_refuses_too_many_tiles(self):
        with pytest.raises(ValueError, match="output blocks"):
            K.pairwise_plan(20000, 20000, 100, False, self.H100_SMS)

    def test_copy_width_follows_alignment(self):
        x = torch.zeros((4, 10))
        assert K._vec(10, x, x) == 2
        assert K._vec(9, x[:, :9].contiguous()) == 1  # odd P: odd rows 4-byte aligned
        assert K._vec(10, x.view(-1)[1:31].view(3, 10)) == 1  # base off by one float
        assert K._vec(10, x, None) == 2


def test_build_round_program_runs_on_the_card_by_default(monkeypatch):
    assert inspect.signature(build_round_program).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.models.cnn import make_femnist_cnn

    data = build_federated_data("leaf.femnist", {"num_samples": 40}, num_nodes=4, seed=0)
    agg = build_aggregator("fedavg", {}, model_dim=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_round_program(make_femnist_cnn(variant="tiny"), agg, data)


class TestCirculantPlain:
    @pytest.mark.parametrize("n,p", SHAPES)
    @pytest.mark.parametrize("kind", ["offsets", "deltas"])
    @pytest.mark.parametrize("same", [False, True])
    def test_plain_matches_lax_and_pallas(self, n, p, kind, same):
        offsets = sorted({1, 2, n - 2, n - 1} - {0}) if n > 2 else [1]
        offs = offsets if kind == "offsets" else (_deltas(offsets) or [1])
        own, b = _arrs(n * 11 + p, n, p)
        if same:
            own = b
        lax = jax_circulant_distances(jnp.asarray(own), jnp.asarray(b), offs) ** 2
        pal = pallas_agg.circulant_sq_distances(
            jnp.asarray(own), jnp.asarray(b), offs, interpret=True
        )
        got = K.circulant_sq_distances_plain(
            torch.from_numpy(own), torch.from_numpy(b), offs
        ).numpy()
        np.testing.assert_allclose(got, np.asarray(lax), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(pal), rtol=1e-5, atol=1e-4)

    def test_plain_chunked_matches_unchunked(self, monkeypatch):
        own, b = _arrs(5, 8, 700)
        whole = K.circulant_sq_distances_plain(
            torch.from_numpy(own), torch.from_numpy(b), [1, 3]
        )
        monkeypatch.setattr(K, "_PLAIN_CHUNK_BYTES", 8 * 4 * 64)  # 64-column chunks
        chunked = K.circulant_sq_distances_plain(
            torch.from_numpy(own), torch.from_numpy(b), [1, 3]
        )
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-4)

    def test_distances_match_lax(self):
        own, b = _arrs(9, 16, 513)
        offsets = [1, 2, 14, 15]
        ref = jax_circulant_distances(jnp.asarray(own), jnp.asarray(b), offsets)
        got = circulant_neighbor_distances(
            torch.from_numpy(own), torch.from_numpy(b), offsets
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


class TestCirculantSplit:
    """Past the rows shared memory holds, the circulant wrapper splits a
    call into launches on contiguous row views with the one offset 0."""

    H100_SMS = 132

    @pytest.mark.parametrize("vec,cap", [(2, 2421), (1, 4842)])
    def test_row_cap_is_where_the_plan_stops_fitting(self, vec, cap):
        assert K.circulant_row_cap(vec) == cap
        K.circulant_plan(cap, 1000, 1, False, vec, self.H100_SMS)
        K.circulant_plan(2 * cap, 1000, 4, True, vec, self.H100_SMS)  # one tensor
        with pytest.raises(ValueError, match="rows do not fit"):
            K.circulant_plan(cap + 1, 1000, 1, False, vec, self.H100_SMS)

    @pytest.mark.parametrize("vec,rows", [(2, 138), (1, 142)])
    def test_split_launches_keep_32_column_tiles(self, vec, rows):
        assert K.circulant_split_rows(vec) == rows
        plan = K.circulant_plan(rows, 100_000, 1, False, vec, self.H100_SMS)
        assert plan["tc_log2"] == 5 and plan["smem"] <= K._RING_TARGET  # two blocks an SM
        assert K.circulant_plan(rows + 1, 100_000, 1, False, vec, self.H100_SMS)["tc_log2"] < 5

    @pytest.mark.parametrize(
        "vec,same,last", [(2, False, 260), (2, True, 521), (1, False, 276), (1, True, 552)]
    )
    def test_split_starts_where_tiles_narrow_below_16_columns(self, vec, same, last):
        assert not K.circulant_needs_split(last, same, vec)
        assert K.circulant_plan(last, 100_000, 4, same, vec, self.H100_SMS)["tc_log2"] == 4
        assert K.circulant_needs_split(last + 1, same, vec)
        assert K.circulant_plan(last + 1, 100_000, 4, same, vec, self.H100_SMS)["tc_log2"] < 4
        for n in (16, 64, 139):  # the flagships' calls, and 16-column tiles, stay one launch
            assert not K.circulant_needs_split(n, same, vec)
        assert K.circulant_needs_split(5000, same, vec)  # past the row cap too
        # A split call's launches take 32-column tiles and are never split again.
        assert not K.circulant_needs_split(K.circulant_split_rows(vec), False, vec)

    @pytest.mark.parametrize(
        "n,offsets,cap",
        [(40, [1, 2, 38, 39], 16), (2500, [1, 2, 2498, 2499], 2421), (2500, [1, 7], 138),
         (5000, [1, 7, 4999], 2421), (16, [3, 5], 16), (9, list(range(1, 9)), 4),
         (7, [0, 7, 13], 3)],
    )
    def test_split_covers_every_pair_once_with_contiguous_views(self, n, offsets, cap):
        pieces = K.circulant_split(n, offsets, cap)
        seen = np.zeros((len(offsets), n), dtype=int)
        for q, i0, i1, j0 in pieces:
            assert 0 < i1 - i0 <= cap  # every launch at or under the cap
            assert 0 <= j0 and j0 + (i1 - i0) <= n  # bcast rows contiguous, no wrap
            for i in range(i0, i1):
                assert j0 + (i - i0) == (i + offsets[q]) % n
            seen[q, i0:i1] += 1
        assert (seen == 1).all()

    @pytest.mark.parametrize("same", [False, True])
    def test_split_with_the_plain_version_equals_the_whole_call(self, same):
        own, b = (torch.from_numpy(x) for x in _arrs(40, 40, 301))
        own = b if same else own
        offsets = [1, 2, 17, 38, 39]
        calls = []

        def plain(o, bb, offs):
            calls.append(o.shape[0])
            return K.circulant_sq_distances_plain(o, bb, offs)

        got = K.circulant_split_call(own, b, offsets, 16, plain)
        assert max(calls) <= 16 and len(calls) == len(K.circulant_split(40, offsets, 16))
        want = K.circulant_sq_distances_plain(own, b, offsets)
        assert got.shape == want.shape == (len(offsets), 40)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


class TestWrapperDispatch:
    def test_cpu_tensors_take_the_plain_versions(self):
        K.reset_counts()
        a, b = _arrs(1, 4, 32)
        K.pairwise_sq_distances(torch.from_numpy(a), torch.from_numpy(b))
        K.circulant_sq_distances(torch.from_numpy(a), torch.from_numpy(a), [1])
        assert K.PLAIN_CALLS == {"pairwise_sq_distances": 1, "circulant_sq_distances": 1}
        assert K.LAUNCHES == {"pairwise_sq_distances": 0, "circulant_sq_distances": 0}

    @pytest.mark.parametrize("fn", ["pairwise", "circulant"])
    def test_other_devices_raise(self, fn):
        t = torch.empty((4, 8), device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            if fn == "pairwise":
                K.pairwise_sq_distances(t)
            else:
                K.circulant_sq_distances(t, t, [1])
