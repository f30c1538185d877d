"""Krum's distance passes in the PyTorch port (murmura_tpu_torch/ops/
agg_kernels.py) against the JAX package: the lax path and the Pallas
kernels in interpret mode, as tests/test_pallas_agg.py runs them.

On the CPU each wrapper runs its plain version; the kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py, and
chip_smoke.py).  Tolerances follow tests/test_pallas_agg.py: rtol 1e-5,
atol 1e-4 on squared circulant distances; rtol 1e-4, atol 1e-2 on
pairwise distances (the Gram identity cancels; the pairwise inputs are
scaled so that the diagonal's cancellation noise, amplified by the square
root, stays inside that atol at the widest P here)."""

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
