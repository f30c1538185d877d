"""The last two model families, ``im2col``, the sequence and LEAF adapters
and ``list-components`` of the PyTorch port against the JAX package, on
the CPU.

- The Shakespeare char-LSTM (models/lstm.py): JAX-initialised params
  carried over leaf for leaf (the flat order is ravel_pytree's) give the
  same logits (float32 within 1e-5) and the same gradients of the masked
  cross-entropy (rtol 1e-4, atol 1e-5, the CNN family's rule) at hidden 16
  and seq_len 12; under bfloat16 compute the logits and the gradients
  within two bf16 ulps (2^-7) of their largest value (PERF.md section 2:
  both packages round the same float32 values to bf16, and a float32 sum
  that lands on the other side of a rounding boundary moves that operand
  by one ulp, 2^-8 relative; measured: the logits equal, the gradients
  3e-5 of the largest apart); one forward at the
  published widths (vocab 81, embed 8, hidden 256, 2 layers, seq_len 80),
  float32 within 1e-5.  Integer tokens go through ``vmap(grad(...))``
  over the node axis.
- The CelebA CNN (models/cnn.py) at 84x84x3 with channels 32-64-128 and
  fc 256: logits within 1e-5 and gradients within the CNN rule, in both
  ``conv_impl``s; the registry builds both models at P = 818,137 and
  3,370,818.
- ``conv2d(impl="im2col")`` against the JAX package's ``im2col`` and the
  port's ``direct`` (float32 within 1e-5; bfloat16 within 2e-2, each
  framework rounding its own product), and the FEMNIST tiny CNN's
  gradients through ``im2col`` equal to ``direct``'s within the CNN rule.
- ``make_synthetic_sequences`` and the three LEAF synthetic fallbacks
  (femnist, celeba, shakespeare; dirichlet and iid) bit-equal to the JAX
  package's, and the CelebA (PIL) and Shakespeare JSON loaders on the LEAF
  fixtures of tests/test_datasets.py bit-equal too.
- ``list-components``: every row, and the aggregators, attacks and
  topologies rows equal to the JAX CLI's row for row; an unknown category
  exits 1.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from jax.flatten_util import ravel_pytree

import murmura_tpu.cli as jax_cli
from murmura_tpu.data.leaf import load_leaf_federated as jax_leaf
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.data.synthetic import make_synthetic_sequences as jax_sequences
from murmura_tpu.models.cnn import make_celeba_cnn as jax_celeba
from murmura_tpu.models.core import conv2d as jax_conv2d
from murmura_tpu.models.lstm import make_char_lstm as jax_lstm
from murmura_tpu.ops.losses import masked_cross_entropy as jax_ce
from murmura_tpu_torch import cli
from murmura_tpu_torch.data.leaf import load_leaf_federated
from murmura_tpu_torch.data.registry import build_federated_data
from murmura_tpu_torch.data.synthetic import make_synthetic_sequences
from murmura_tpu_torch.models.cnn import make_celeba_cnn, make_femnist_cnn
from murmura_tpu_torch.models.core import conv2d
from murmura_tpu_torch.models.lstm import make_char_lstm
from murmura_tpu_torch.models.registry import build_model
from murmura_tpu_torch.ops.flatten import (
    make_flatteners,
    model_dimension,
    tree_leaves,
    tree_to_torch,
)
from murmura_tpu_torch.ops.losses import masked_cross_entropy

SMALL_LSTM = dict(vocab_size=30, embed_dim=8, hidden=16, num_layers=2, seq_len=12)


def _init(jmodel, seed):
    return jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(seed)))


def _grads_pair(jmodel, model, params, x, y, m, tx):
    """Gradients of the masked cross-entropy in both packages."""
    def jloss(p):
        return jax_ce(jmodel.apply(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(m))[0]

    ref = jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.asarray, params))

    def tloss(p):
        return masked_cross_entropy(model.apply(p, tx), torch.from_numpy(y).long(),
                                    torch.from_numpy(m))[0]

    got = torch.func.grad(tloss)(tree_to_torch(params))
    return tree_leaves(got), jax.tree_util.tree_leaves(ref)


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# the char-LSTM


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_lstm_logits_and_gradients_match_jax(dtype):
    jmodel = jax_lstm(**SMALL_LSTM, compute_dtype=dtype)
    model = make_char_lstm(**SMALL_LSTM, compute_dtype=dtype)
    params = _init(jmodel, 3)
    x = _tokens(6, 12, 30, 3)
    y = np.random.default_rng(4).integers(0, 30, size=6).astype(np.int32)
    m = np.array([1, 1, 0, 1, 1, 1], np.float32)
    # Integer tokens stay integer into the embedding.
    tx = torch.from_numpy(x).long()
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    got = model.apply(tree_to_torch(params), tx).detach().numpy()
    # bfloat16: two bf16 ulps (2^-7) of the largest value (PERF.md section 2).
    tol = 1e-5 if dtype is None else 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0 if dtype else tol, atol=tol)
    g_got, g_ref = _grads_pair(jmodel, model, params, x, y, m, tx)
    assert len(g_got) == len(g_ref)
    if dtype is None:
        for g, r in zip(g_got, g_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    else:
        scale = max(float(np.abs(np.asarray(r)).max()) for r in g_ref)
        worst = max(float(np.abs(g.numpy() - np.asarray(r)).max())
                    for g, r in zip(g_got, g_ref))
        assert worst <= 2.0 ** -7 * scale, (worst, scale)


def test_lstm_flat_order_and_published_widths():
    jmodel = jax_lstm()
    params = _init(jmodel, 0)
    tparams = tree_to_torch(params)
    ravel, _, dim = make_flatteners(tparams)
    ref, _ = ravel_pytree(params)
    assert dim == ref.size == 818_137
    assert np.array_equal(ravel(tparams).numpy(), np.asarray(ref))
    x = _tokens(2, 80, 81, 5)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    got = make_char_lstm().apply(tparams, torch.from_numpy(x).long()).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_lstm_vmapped_gradient_takes_integer_tokens():
    # The round's vmap(grad(node_loss)) over the node axis, tokens int64.
    model = make_char_lstm(**SMALL_LSTM)
    g = torch.Generator().manual_seed(0)
    per_node = [model.init(g, "cpu") for _ in range(3)]
    stacked = [torch.stack(ls) for ls in zip(*[tree_leaves(p) for p in per_node])]
    from murmura_tpu_torch.ops.flatten import tree_unflatten

    params = tree_unflatten(per_node[0], stacked)
    x = torch.from_numpy(np.stack([_tokens(4, 12, 30, s) for s in range(3)])).long()

    def loss(p, xb):
        return model.apply(p, xb).logsumexp(-1).mean()

    batched = torch.func.vmap(torch.func.grad(loss))(params, x)
    for i in range(3):
        one = torch.func.grad(loss)(per_node[i], x[i])
        for a, b in zip(tree_leaves(batched), tree_leaves(one)):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the CelebA CNN and im2col


@pytest.mark.parametrize("impl", ["direct", "im2col"])
def test_celeba_logits_and_gradients_match_jax(impl):
    jmodel = jax_celeba(conv_impl=impl)
    model = make_celeba_cnn(conv_impl=impl)
    params = _init(jmodel, 1)
    x = np.random.default_rng(1).random((2, 84, 84, 3)).astype(np.float32)
    y = np.array([0, 1], np.int32)
    m = np.ones(2, np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    got = model.apply(tree_to_torch(params), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    g_got, g_ref = _grads_pair(jmodel, model, params, x, y, m, torch.from_numpy(x))
    for g, r in zip(g_got, g_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_registry_builds_the_two_families():
    dims = {}
    for factory in ("leaf.shakespeare", "leaf.celeba", "examples.leaf.LEAFCelebAModel"):
        model = build_model(factory, {})
        dims[factory] = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    assert dims == {"leaf.shakespeare": 818_137, "leaf.celeba": 3_370_818,
                    "examples.leaf.LEAFCelebAModel": 3_370_818}
    small = build_model("leaf.shakespeare", {"hidden": 16, "seq_len": 12, "vocab_size": 30})
    assert small.input_shape == (12,) and small.num_classes == 30
    assert build_model("leaf.celeba", {"conv_impl": "im2col"}).input_shape == (84, 84, 3)
    with pytest.raises(ValueError, match="Unknown conv_impl"):
        conv2d({"w": torch.zeros(3, 3, 1, 1), "b": torch.zeros(1)}, torch.zeros(1, 1, 4, 4),
               impl="winograd")
    with pytest.raises(ValueError, match="Unknown model factory"):
        build_model("leaf.reddit", {})


@pytest.mark.parametrize("k, cin, cout", [(3, 3, 8), (5, 4, 6)])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_im2col_matches_jax_and_direct(k, cin, cout, dtype):
    rng = np.random.default_rng(k)
    p = {"w": rng.normal(size=(k, k, cin, cout)).astype(np.float32) * 0.2,
         "b": rng.normal(size=(cout,)).astype(np.float32)}
    x = rng.normal(size=(2, 11, 9, cin)).astype(np.float32)
    jd = None if dtype is None else jnp.bfloat16
    ref = np.asarray(jax_conv2d({k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x),
                                dtype=jd, impl="im2col"))
    tp = {k_: torch.from_numpy(v) for k_, v in p.items()}
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    td = None if dtype is None else torch.bfloat16
    got = conv2d(tp, tx, td, "im2col").permute(0, 2, 3, 1).numpy()
    direct = conv2d(tp, tx, td, "direct").permute(0, 2, 3, 1).numpy()
    tol = 1e-5 if dtype is None else 2e-2 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got, direct, atol=tol, rtol=0)


def test_femnist_im2col_gradients_equal_direct():
    params = make_femnist_cnn(variant="tiny").init(torch.Generator().manual_seed(2), "cpu")
    x = np.random.default_rng(2).normal(size=(4, 28, 28, 1)).astype(np.float32)
    y = np.array([1, 5, 9, 61], np.int32)
    m = np.ones(4, np.float32)
    grads = {}
    for impl in ("direct", "im2col"):
        model = make_femnist_cnn(variant="tiny", conv_impl=impl)
        grads[impl] = torch.func.grad(lambda p: masked_cross_entropy(
            model.apply(p, torch.from_numpy(x)), torch.from_numpy(y).long(),
            torch.from_numpy(m))[0])(params)
    for a, b in zip(tree_leaves(grads["im2col"]), tree_leaves(grads["direct"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the adapters


def _arrays(fa):
    return {k: getattr(fa, k) for k in ("x", "y", "mask", "num_samples", "x_test", "y_test",
                                        "mask_test", "num_classes")}


def _assert_bit_equal(got, ref):
    a, b = _arrays(got), _arrays(ref)
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.array_equal(a[k], b[k]), k


def test_synthetic_sequences_bit_equal():
    for kw in ({}, {"num_samples": 50, "seq_len": 7, "vocab_size": 13, "seed": 4}):
        got, ref = make_synthetic_sequences(**kw), jax_sequences(**kw)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    params = {"num_samples": 300, "seq_len": 10, "vocab_size": 20,
              "partition_method": "dirichlet", "alpha": 0.3}
    for adapter in ("synthetic_sequences", "synthetic_seq"):
        got = build_federated_data(adapter, params, num_nodes=4, seed=2, max_samples=40)
        _assert_bit_equal(got, jax_data(adapter, params, num_nodes=4, seed=2, max_samples=40))
        assert got.x.dtype == np.int32 and got.num_classes == 20


@pytest.mark.parametrize("dataset, params", [
    ("femnist", {"num_samples": 300}),
    ("celeba", {"num_samples": 120}),
    ("shakespeare", {}),
    ("shakespeare", {"num_samples": 400, "partition_method": "iid", "seq_len": 20}),
])
def test_leaf_synthetic_fallbacks_bit_equal(dataset, params):
    got = build_federated_data(f"leaf.{dataset}", params, num_nodes=4, seed=5)
    _assert_bit_equal(got, jax_data(f"leaf.{dataset}", params, num_nodes=4, seed=5))
    want = {"femnist": (28, 28, 1), "celeba": (84, 84, 3),
            "shakespeare": (params.get("seq_len", 80),)}[dataset]
    assert got.x.shape[2:] == want


@pytest.fixture
def shakespeare_dir(tmp_path):
    # tests/test_datasets.py's fixture, with a test/ split for one user.
    d = tmp_path / "shakespeare" / "train"
    d.mkdir(parents=True)
    ctx = "to be or not to be that is the question".ljust(80, "X")
    blob = {
        "users": ["hamlet", "ophelia"],
        "num_samples": [3, 2],
        "user_data": {
            "hamlet": {"x": [ctx] * 3, "y": ["a", "b", "~"]},
            "ophelia": {"x": [ctx] * 2, "y": ["c", "—"]},
        },
    }
    (d / "all_data_0.json").write_text(json.dumps(blob))
    t = tmp_path / "shakespeare" / "test"
    t.mkdir()
    (t / "all_data_0.json").write_text(json.dumps({
        "users": ["hamlet"], "user_data": {"hamlet": {"x": [ctx[::-1]], "y": ["z"]}}}))
    return tmp_path / "shakespeare"


@pytest.fixture
def celeba_dir(tmp_path):
    # tests/test_datasets.py's fixture.
    from PIL import Image

    root = tmp_path / "celeba"
    (root / "train").mkdir(parents=True)
    img_dir = root / "raw" / "img_align_celeba"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(2)
    names = [f"img_{i}.jpg" for i in range(6)]
    for nm in names:
        Image.fromarray(rng.integers(0, 255, size=(109, 89, 3), dtype=np.uint8)).save(
            img_dir / nm)
    blob = {
        "users": ["celeb_a", "celeb_b"],
        "num_samples": [4, 2],
        "user_data": {
            "celeb_a": {"x": names[:4], "y": [0, 1, 0, 1]},
            "celeb_b": {"x": names[4:], "y": [1, 0]},
        },
    }
    (root / "train" / "all_data_0.json").write_text(json.dumps(blob))
    return root


@pytest.mark.parametrize("holdout", [0.0, 0.25])
def test_json_loaders_bit_equal(shakespeare_dir, celeba_dir, holdout):
    for dataset, root in (("shakespeare", shakespeare_dir), ("celeba", celeba_dir)):
        params = {"data_path": str(root), "holdout_fraction": holdout}
        got = load_leaf_federated(dataset, params, num_nodes=2, seed=0)
        _assert_bit_equal(got, jax_leaf(dataset, params, num_nodes=2, seed=0))
        if dataset == "shakespeare":
            assert got.x.dtype == np.int32 and int((got.y[got.mask > 0] == 80).sum()) == 2
        else:
            assert got.x.shape[-3:] == (84, 84, 3) and got.x.max() <= 1.0
    with pytest.raises(FileNotFoundError, match="LEAF data path not found"):
        load_leaf_federated("celeba", {"data_path": str(celeba_dir / "nope")}, 2)


# ---------------------------------------------------------------------------
# list-components


def _jax_rows(monkeypatch, category):
    rows = {}

    class Recording(jax_cli.Table):
        def add_row(self, *cells, **kw):
            rows[cells[0]] = cells[1]
            return super().add_row(*cells, **kw)

    monkeypatch.setattr(jax_cli, "Table", Recording)
    result = CliRunner().invoke(jax_cli.app, ["list-components", category])
    assert result.exit_code == 0, result.output
    return rows


def _port_rows(capsys, *argv):
    cli.main(["list-components", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "murmura_tpu_torch components"
    return dict(line.split(None, 1) for line in lines[1:])


def test_list_components_rows_match_the_jax_cli(monkeypatch, capsys):
    rows = _port_rows(capsys)
    assert list(rows) == ["topologies", "aggregators", "attacks", "backends", "models",
                          "datasets"]
    assert "distributed is not ported" in rows["backends"]
    for category in ("aggregators", "attacks", "topologies"):
        assert _port_rows(capsys, category) == _jax_rows(monkeypatch, category)
    for category in ("models", "datasets"):
        assert _port_rows(capsys, category) == _jax_rows(monkeypatch, category)
    with pytest.raises(SystemExit) as e:
        cli.main(["list-components", "planets"])
    assert e.value.code == 1
    assert "Available: topologies" in capsys.readouterr().err
