"""The PyTorch port's FEMNIST CNN family and flat layout against the JAX
package: JAX-initialised params carried over give the same logits and the
same gradients, and the flat [P] vector has ravel_pytree's order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.models.cnn import FEMNIST_VARIANTS, make_femnist_cnn as jax_cnn
from murmura_tpu.ops.losses import masked_cross_entropy as jax_ce
from murmura_tpu_torch.models.cnn import make_femnist_cnn
from murmura_tpu_torch.models.registry import build_model
from murmura_tpu_torch.ops.flatten import (
    make_flatteners,
    model_dimension,
    tree_leaves,
    tree_to_numpy,
    tree_to_torch,
)
from murmura_tpu_torch.ops.losses import masked_cross_entropy


def _jax_params(variant, seed=0):
    model = jax_cnn(variant=variant)
    return model, jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def _images(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 28, 28, 1)).astype(np.float32)


@pytest.mark.parametrize("variant", list(FEMNIST_VARIANTS))
def test_logits_match_jax(variant):
    jmodel, params = _jax_params(variant)
    x = _images(3)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    got = make_femnist_cnn(variant=variant).apply(
        tree_to_torch(params), torch.from_numpy(x)
    )
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["tiny", "baseline"])
def test_bf16_compute_logits_close_to_jax(variant):
    # bf16 rounds at other places in the two frameworks (conv outputs,
    # dense inputs); the logits agree to bf16 resolution, not bitwise.
    jmodel = jax_cnn(variant=variant, compute_dtype="bfloat16")
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    x = _images(4, seed=1)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    got = make_femnist_cnn(variant=variant, compute_dtype="bfloat16").apply(
        tree_to_torch(params), torch.from_numpy(x)
    )
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", ["tiny", "small"])
def test_gradients_match_jax(variant):
    jmodel, params = _jax_params(variant, seed=2)
    x = _images(6, seed=2)
    y = np.random.default_rng(2).integers(0, 62, size=6).astype(np.int32)
    m = np.array([1, 1, 1, 1, 0, 1], np.float32)

    def jloss(p):
        return jax_ce(jmodel.apply(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(m))[0]

    ref = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    model = make_femnist_cnn(variant=variant)
    tparams = tree_to_torch(params)

    def tloss(p):
        return masked_cross_entropy(
            model.apply(p, torch.from_numpy(x)),
            torch.from_numpy(y).long(),
            torch.from_numpy(m),
        )[0]

    got = torch.func.grad(tloss)(tparams)
    for g, r in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", list(FEMNIST_VARIANTS))
def test_flat_order_is_ravel_pytree(variant):
    _, params = _jax_params(variant)
    tparams = tree_to_torch(params)
    ravel, unravel, dim = make_flatteners(tparams)
    flat = ravel(tparams)
    ref, _ = ravel_pytree(params)
    assert dim == ref.size == model_dimension(tparams)
    assert np.array_equal(flat.numpy(), np.asarray(ref))
    # Round trip, bit-equal.
    assert torch.equal(ravel(unravel(flat)), flat)
    back = tree_to_numpy(unravel(flat))
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


def test_stacked_unravel_gives_views():
    _, params = _jax_params("tiny")
    tparams = tree_to_torch(params)
    ravel, unravel, dim = make_flatteners(tparams)
    flat = torch.stack([ravel(tparams), 2 * ravel(tparams)])
    views = unravel(flat)
    leaf = tree_leaves(views)[0]
    assert leaf.shape[0] == 2 and leaf.data_ptr() == flat.data_ptr()
    assert torch.equal(ravel(views, batch_dims=1), flat)


def test_baseline_dimension():
    model = build_model("leaf.femnist.baseline", {})
    params = model.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert model_dimension(params) == 6_603_710


@pytest.mark.parametrize("factory", ["leaf.celeba", "leaf.shakespeare"])
def test_other_factories_refused_by_name(factory):
    with pytest.raises(ValueError, match="not ported"):
        build_model(factory, {})


def test_registry_resolves_variants():
    assert build_model("leaf.femnist.tiny", {}).name == "leaf.femnist.tiny"
    assert build_model("examples.leaf.LEAFFEMNISTModel", {}).name == "leaf.femnist.baseline"
    assert build_model("leaf.femnist", {"variant": "small"}).name == "leaf.femnist.small"
