"""The MLP, the wearables family and the evidential round of the PyTorch
port against the JAX package.

- ``layernorm`` (population variance) within rtol/atol 1e-5;
- the plain MLP and the wearable MLP at the UCI HAR widths (561 -> 256 ->
  128 -> 6), JAX-initialised weights carried over: outputs within rtol/atol
  1e-5, with JAX's own dropout masks in training mode, and with bfloat16
  parameters (promoted to float32 as ``jnp`` promotes them) within 1e-5;
- ``evidential_loss`` and ``uncertainty_metrics`` within rtol 1e-5, and the
  loss's gradient within rtol 1e-4, atol 1e-6;
- the registry's model widths (P counted from the layer sizes);
- one evidential wearable-MLP round with dropout 0.3 (UCI HAR widths, 8
  nodes, Krum f=1 under a gaussian attack of std 1, two local epochs, the
  KL term annealed to round 3 of 10), fed the JAX round's own shuffle and
  dropout masks: post-round parameters within a scaled delta of 1e-4, the
  same Krum selection, the eval loss, vacuity, entropy and strength within
  rtol 1e-4, the accuracy within 1e-6;
- the three wearables configs run on the CPU through the factories, with
  finite evidential history columns.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.core import layernorm as jax_layernorm
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.models.mlp import make_wearable_mlp as jax_wearable_mlp
from murmura_tpu.ops.losses import evidential_loss as jax_evidential_loss
from murmura_tpu.ops.losses import uncertainty_metrics as jax_uncertainty
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.models.core import layernorm
from murmura_tpu_torch.models.mlp import make_mlp, make_wearable_mlp
from murmura_tpu_torch.models.registry import build_model
from murmura_tpu_torch.ops.flatten import model_dimension, tree_to_torch
from murmura_tpu_torch.ops.losses import evidential_loss, uncertainty_metrics
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "examples" / "configs"


def _params(jmodel, seed):
    return jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))


def _jax_masks(key, widths, batch, keep):
    """JAX's dropout masks for one node's step key (models/mlp.py: one key
    a layer from split(key, n_layers), bernoulli(keep, [B, width]))."""
    keys = jax.random.split(key, len(widths))
    return [np.array(jax.random.bernoulli(k, keep, (batch, w))) for k, w in zip(keys, widths)]


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(7, 33)) + 1.5).astype(np.float32)
    p = {"scale": rng.normal(size=33).astype(np.float32),
         "bias": rng.normal(size=33).astype(np.float32)}
    ref = np.asarray(jax_layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("evidential", [False, True])
def test_mlp_forward_matches_jax(evidential):
    jmodel = jax_mlp(24, (32, 16), 5, evidential=evidential)
    params = _params(jmodel, 1)
    x = np.random.default_rng(1).normal(size=(9, 24)).astype(np.float32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    got = make_mlp(24, (32, 16), 5, evidential=evidential).apply(
        tree_to_torch(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_wearable_mlp_matches_jax_with_jax_dropout_masks():
    jmodel = jax_wearable_mlp()  # UCI HAR: 561 -> 256 -> 128 -> Evidential(6)
    params = _params(jmodel, 2)
    x = np.random.default_rng(2).normal(size=(16, 561)).astype(np.float32)
    model = make_wearable_mlp()
    assert model.dropout_widths == (256, 128) and model.evidential
    tparams = tree_to_torch(params)
    # Eval mode: no dropout.
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    got = model.apply(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    # Training mode: JAX's masks for its key, injected into the port.
    key = jax.random.PRNGKey(5)
    ref_train = np.asarray(jmodel.apply(params, jnp.asarray(x), key, True))
    masks = [torch.from_numpy(m) for m in _jax_masks(key, (256, 128), 16, 0.7)]
    got_train = model.apply(tparams, torch.from_numpy(x), masks)
    np.testing.assert_allclose(got_train.detach().numpy(), ref_train, rtol=1e-5, atol=1e-5)
    assert not np.allclose(ref_train, ref)


def test_mlp_with_bfloat16_parameters_matches_jax():
    # No compute dtype: jnp promotes float32 inputs times bfloat16 weights
    # to float32; the port's dense and layernorm promote the same way.
    jmodel = jax_mlp(24, (32, 16), 5, evidential=True)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    jmodel.init(jax.random.PRNGKey(3)))
    x = np.random.default_rng(3).normal(size=(6, 24)).astype(np.float32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16), params)
    got = make_mlp(24, (32, 16), 5, evidential=True).apply(tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lambda_t", [0.0, 0.06])
def test_evidential_loss_and_uncertainty_match_jax(lambda_t):
    rng = np.random.default_rng(4)
    alpha = (1.0 + np.exp(rng.normal(size=(12, 6)))).astype(np.float32)
    y = rng.integers(0, 6, size=12).astype(np.int32)
    m = (rng.random(12) < 0.8).astype(np.float32)
    ref = float(jax_evidential_loss(jnp.asarray(alpha), jnp.asarray(y), jnp.asarray(m), 6,
                                    lambda_t))
    ta = torch.from_numpy(alpha).requires_grad_(True)
    got = evidential_loss(ta, torch.from_numpy(y).long(), torch.from_numpy(m), 6, lambda_t)
    np.testing.assert_allclose(float(got.detach()), ref, rtol=1e-5)
    ref_g = np.asarray(jax.grad(lambda a: jax_evidential_loss(
        a, jnp.asarray(y), jnp.asarray(m), 6, lambda_t))(jnp.asarray(alpha)))
    (g,) = torch.autograd.grad(got, ta)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-4, atol=1e-6)
    ref_u = jax_uncertainty(jnp.asarray(alpha))
    got_u = uncertainty_metrics(torch.from_numpy(alpha))
    for k in ("probs", "vacuity", "entropy", "strength"):
        np.testing.assert_allclose(got_u[k].numpy(), np.asarray(ref_u[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize(
    "factory,params,dims,p",
    [
        ("mlp", {}, (32, 64, 32, 10), None),
        ("mlp", {"input_dim": 20, "hidden_dims": [8], "num_classes": 3, "evidential": True},
         (20, 8, 3), None),
        # 561*256+256 + 2*256 + 256*128+128 + 2*128 + 128*6+6
        ("examples.wearables.uci_har", {}, (561, 256, 128, 6), 178_310),
        ("wearables.pamap2", {}, (4000, 512, 256, 128, 12), 2_216_076),
        ("wearables.ppg_dalia", {}, (192, 256, 128, 64, 7), None),
        ("wearables.pamap2", {"hidden_dims": [64], "dropout": 0.0}, (4000, 64, 12), None),
    ],
)
def test_registry_builds_the_mlps(factory, params, dims, p):
    model = build_model(factory, params)
    tparams = model.init(torch.Generator().manual_seed(0), "cpu")
    want = sum(a * b + b + (2 * b if i < len(dims) - 2 else 0)
               for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
    assert model_dimension(tparams) == want == (p or want)
    assert model.input_shape == (dims[0],) and model.num_classes == dims[-1]
    assert model.evidential == (factory != "mlp" or bool(params.get("evidential")))


N = 8
SEED = 11


def _spread_init(init):
    """Node 0's initial weights for every node plus per-node gaussian offsets
    of distinct scales (Krum's scores then sit far apart)."""
    rng = np.random.default_rng(SEED)
    scale = 0.02 * (1.0 + np.arange(N) / N)

    def leaf(a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape).astype(np.float32)
        return (a[:1] + scale.reshape((N,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)

    return jax.tree_util.tree_map(leaf, init)


def test_evidential_dropout_round_matches_jax():
    data = jax_data("wearables.uci_har", {"num_samples": 480, "partition_method": "dirichlet",
                                          "alpha": 0.5}, num_nodes=N, seed=SEED)
    hp = dict(local_epochs=2, batch_size=16, lr=0.05, seed=SEED, total_rounds=10)
    jattack = jax_gaussian(N, 0.2, noise_std=1.0, seed=SEED)
    kw = {"num_compromised": 1}
    jprog = jax_build_round(jax_wearable_mlp(), jax_make_krum(**kw), data, attack=jattack, **hp)
    init = _spread_init(jprog.init_params)
    adj = (np.ones((N, N)) - np.eye(N)).astype(np.float32)
    comp = jattack.compromised.astype(np.float32)
    round_idx = 3.0
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 3)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    j_params, _, j_metrics = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key,
        jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(round_idx, jnp.float32), d)
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))

    # The JAX round's draws (core/rounds.py): split(key) -> train/attack;
    # split(train_key, local_epochs); split(epoch_key) -> perm/step; a
    # step's node keys split(fold_in(step_key, t), N); per node and layer
    # bernoulli(keep, [B, width]).
    train_key, attack_key = jax.random.split(key)
    steps = int(data.steps_per_epoch(16).max())
    batch = int(data.effective_batch(16).max())
    u, dropout = [], []
    for epoch_key in jax.random.split(train_key, 2):
        perm_key, step_key = jax.random.split(epoch_key)
        u.append(np.array(jax.random.uniform(perm_key, data.mask.shape)))
        per_step = []
        for t in range(steps):
            node_keys = jax.random.split(jax.random.fold_in(step_key, t), N)
            per_node = [_jax_masks(k, (256, 128), batch, 0.7) for k in node_keys]
            per_step.append([np.stack([m[layer] for m in per_node]) for layer in range(2)])
        dropout.append(per_step)
    noise = np.asarray(jax.random.normal(attack_key, (int(comp.sum()), j_flat.shape[1])))

    prog = build_round_program(
        make_wearable_mlp(), make_krum(**kw), data,
        attack=make_gaussian_attack(N, 0.2, noise_std=1.0, seed=SEED),
        init_params=init, device="cpu", **hp)
    assert prog.evidential and prog.model_dim == 178_310
    flat, _, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.from_numpy(comp),
        round_idx, draws={"u": u, "noise": noise, "dropout": dropout})
    scaled = float(np.max(np.abs(flat.numpy() - j_flat)) / max(1.0, np.max(np.abs(j_flat))))
    assert scaled <= 1e-4
    assert np.array_equal(metrics["agg_selected_index"].numpy(),
                          np.asarray(j_metrics["agg_selected_index"]))
    assert not bool(metrics["agg_selected_own"].all())

    j_eval = jax.jit(jprog.eval_step)(j_params, d)
    t_eval = prog.eval_step(flat)
    assert set(t_eval) == set(j_eval) == {"loss", "accuracy", "vacuity", "entropy", "strength"}
    for k in ("loss", "vacuity", "entropy", "strength"):
        np.testing.assert_allclose(t_eval[k].numpy(), np.asarray(j_eval[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(t_eval["accuracy"].numpy(), np.asarray(j_eval["accuracy"]),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["uci_har_byzantine", "uci_har_dirichlet", "pamap2_dirichlet"])
def test_wearables_configs_run_on_cpu(name):
    # As committed but for the data size (fewer synthetic samples) and two
    # rounds; the model keeps its published widths.
    config = load_config(CONFIGS / f"{name}.yaml")
    config.data.params = {**config.data.params, "num_samples": 40 * config.topology.num_nodes}
    config.experiment.rounds = 2
    network = build_network_from_config(config, device="cpu")
    assert network.program.evidential
    history = network.train(rounds=2)
    assert history["round"] == [1, 2]
    for k in ("mean_vacuity", "mean_entropy", "mean_strength", "mean_loss"):
        assert len(history[k]) == 2 and np.all(np.isfinite(history[k])), k
    assert bool(torch.isfinite(network.flat).all())
    if name == "uci_har_byzantine":
        assert len(history["agg_selected_index"]) == 2
