"""The ALIE, IPM, directed-deviation and label-flip attacks of the PyTorch
port against the JAX package.

- each broadcast attack's ``apply`` on the same [N, P] rows: ALIE under
  both estimators with ``z`` given and from ``alie_z_max``, IPM with its
  default and a given epsilon, directed deviation with lambda -5 and 0.3.
  Float32 within rtol 1e-6 (the two frameworks sum the N rows of the
  statistics in other orders); bfloat16 bit-equal, every colluder row the
  same bits, the honest rows untouched;
- ``alie_z_max`` equal; ``poison_labels`` bit-equal, with its ``flip_fraction``
  guard;
- the factories: each attack built from a config equal to the JAX
  package's (compromised set, ``trains_locally``, the broadcast it makes),
  and each ConfigError raised where the JAX package raises one;
- one round per attack (16 nodes, k-regular(4), the tiny FEMNIST CNN)
  against the JAX round program fed the same shuffle: post-round
  parameters within a scaled delta of 1e-4 and the rule's decisions equal;
  label flip with its poisoned labels and its compromised nodes training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.attacks import ATTACKS as JAX_ATTACKS
from murmura_tpu.attacks.alie import alie_z_max as jax_alie_z_max
from murmura_tpu.attacks.label_flip import poison_labels as jax_poison_labels
from murmura_tpu.config import load_config as jax_load_config
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.cnn import make_femnist_cnn as jax_cnn
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu.utils.factories import ConfigError as JaxConfigError
from murmura_tpu.utils.factories import build_attack as jax_build_attack
from murmura_tpu.utils.factories import build_network_from_config as jax_build_network
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.attacks import ATTACKS
from murmura_tpu_torch.attacks.alie import alie_z_max
from murmura_tpu_torch.attacks.label_flip import poison_labels
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.models.cnn import make_femnist_cnn
from murmura_tpu_torch.utils.factories import ConfigError, build_attack, build_network_from_config

N = 16
SEED = 7
OFFSETS = [1, 2, 14, 15]

# (label, type, constructor kwargs)
BROADCAST_ATTACKS = [
    ("alie omniscient z 1.5", "alie", {"z": 1.5}),
    ("alie omniscient z_max", "alie", {}),
    ("alie coalition z 1.5", "alie", {"z": 1.5, "estimator": "coalition"}),
    ("alie coalition z_max", "alie", {"estimator": "coalition"}),
    ("ipm default epsilon", "ipm", {}),
    ("ipm epsilon 0.5", "ipm", {"epsilon": 0.5}),
    ("directed lambda -5", "directed_deviation", {}),
    ("directed lambda 0.3", "directed_deviation", {"lambda_param": 0.3}),
]


def _rows(seed, n=N, p=1001):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.normal(size=(1, p)) + rng.normal(size=(n, p))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,kind,kw", BROADCAST_ATTACKS, ids=[a[0] for a in BROADCAST_ATTACKS])
def test_broadcast_attack_matches_jax(label, kind, kw, dtype):
    flat = _rows(3)
    jatk = JAX_ATTACKS[kind](N, 0.25, seed=SEED, **kw)
    atk = ATTACKS[kind](N, 0.25, seed=SEED, **kw)
    assert np.array_equal(atk.compromised, jatk.compromised)
    assert atk.trains_locally == jatk.trains_locally
    comp = jatk.compromised.astype(np.float32)
    jflat = jnp.asarray(flat).astype(getattr(jnp, dtype))
    ref = np.asarray(jatk.apply(jflat, jnp.asarray(comp), jax.random.PRNGKey(0), 0))
    tflat = torch.from_numpy(flat).to(getattr(torch, dtype))
    got = atk.apply(tflat, torch.from_numpy(comp))
    assert got.dtype == tflat.dtype and ref.dtype == np.dtype(jflat.dtype)
    got32, ref32 = got.float().numpy(), ref.astype(np.float32)
    idx = np.flatnonzero(jatk.compromised)
    assert len(idx) == 4
    # The honest rows pass through as they were; under the colluding
    # attacks every colluder row is one vector, bit for bit.
    assert np.array_equal(got32[~jatk.compromised], tflat.float().numpy()[~jatk.compromised])
    if kind != "directed_deviation":
        assert all(np.array_equal(got32[i], got32[idx[0]]) for i in idx)
    if dtype == "bfloat16":
        assert np.array_equal(got32, ref32)
    else:
        np.testing.assert_allclose(got32, ref32, rtol=1e-6, atol=0)
    assert not np.array_equal(got32[idx], tflat.float().numpy()[idx])


def test_attacks_refuse_a_per_node_view():
    # The JAX package passes a non-N-row input through; no port path
    # builds one, so the port raises instead.
    for kind in ("alie", "ipm", "directed_deviation", "gaussian"):
        atk = ATTACKS[kind](N, 0.25, seed=SEED)
        with pytest.raises(ValueError, match="built for 16 nodes got 1 rows"):
            atk.apply(torch.zeros((1, 5)), torch.zeros(1))


@pytest.mark.parametrize("n,m", [(10, 2), (16, 3), (16, 8), (16, 9), (64, 12), (5, 1), (3, 0)])
def test_alie_z_max_matches_jax(n, m):
    assert alie_z_max(n, m) == jax_alie_z_max(n, m)


@pytest.mark.parametrize("flip_fraction,seed", [(1.0, 42), (0.5, 3), (0.05, 9)])
def test_poison_labels_bit_equal(flip_fraction, seed):
    data = jax_data("wearables.uci_har", {"num_samples": 400, "partition_method": "dirichlet",
                                          "alpha": 0.5}, num_nodes=10, seed=seed)
    comp = JAX_ATTACKS["label_flip"](10, 0.3, seed=seed).compromised
    ref = jax_poison_labels(data.y, data.mask, comp, 6, flip_fraction, seed)
    got = poison_labels(data.y, data.mask, comp, 6, flip_fraction, seed)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert (got != data.y).any() and np.array_equal(got[~comp], data.y[~comp])
    jatk = JAX_ATTACKS["label_flip"](10, 0.3, flip_fraction=flip_fraction, seed=seed)
    atk = ATTACKS["label_flip"](10, 0.3, flip_fraction=flip_fraction, seed=seed)
    assert atk.trains_locally and jatk.trains_locally
    assert np.array_equal(atk.data_poison_fn(data.y, data.mask, 6),
                          jatk.data_poison_fn(data.y, data.mask, 6))
    flat = torch.from_numpy(_rows(1, n=10))
    assert torch.equal(atk.apply(flat, torch.from_numpy(comp.astype(np.float32))), flat)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="flip_fraction"):
            poison_labels(data.y, data.mask, comp, 6, bad, seed)


def _config(tmp_path, attack, over=None):
    raw = {
        "experiment": {"name": "attack-factory", "seed": 5, "rounds": 1},
        "topology": {"type": "fully", "num_nodes": 10},
        "aggregation": {"algorithm": "fedavg", "params": {}},
        "attack": {"enabled": True, "percentage": 0.3, **attack},
        "training": {"local_epochs": 1, "batch_size": 16},
        "data": {"adapter": "wearables.uci_har", "params": {"num_samples": 200}},
        "model": {"factory": "wearables.uci_har", "params": {}},
    }
    for k, v in (over or {}).items():
        raw[k].update(v)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


@pytest.mark.parametrize("attack", [
    {"type": "alie", "params": {"z": 0.7}},
    {"type": "alie", "params": {"estimator": "coalition"}},
    {"type": "ipm", "params": {"epsilon": 2.0}},
    {"type": "directed_deviation", "params": {"lambda_param": -2.0, "seed": 3}},
    {"type": "label_flip", "params": {"flip_fraction": 0.5}},
], ids=["alie", "alie-coalition", "ipm", "directed", "label_flip"])
def test_factory_builds_the_attacks_as_jax(tmp_path, attack):
    path = _config(tmp_path, attack)
    jatk = jax_build_attack(jax_load_config(path))
    atk = build_attack(load_config(path))
    assert atk.name == jatk.name == attack["type"]
    assert np.array_equal(atk.compromised, jatk.compromised)
    assert atk.trains_locally == jatk.trains_locally
    assert (atk.data_poison_fn is None) == (jatk.data_poison_fn is None)
    flat = _rows(4, n=10, p=33)
    comp = jatk.compromised.astype(np.float32)
    ref = np.asarray(jatk.apply(jnp.asarray(flat), jnp.asarray(comp), jax.random.PRNGKey(0), 0))
    got = atk.apply(torch.from_numpy(flat), torch.from_numpy(comp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("attack,over,match", [
    ({"type": "alie", "params": {"estimator": "bogus"}}, {}, "estimator"),
    ({"type": "alie", "params": {"estimator": "coalition"}}, {"attack": {"percentage": 0.1}},
     "at least 2 compromised"),
    ({"type": "label_flip", "params": {"flip_fraction": 0.0}}, {}, "flip_fraction"),
    ({"type": "label_flip", "params": {"flip_fraction": 1.5}}, {}, "flip_fraction"),
    ({"type": "label_flip", "params": {}},
     {"data": {"params": {"num_samples": 200, "holdout_fraction": 0.0}}}, "clean eval split"),
], ids=["alie-estimator", "alie-coalition-of-one", "flip-0", "flip-1.5", "flip-no-eval-split"])
def test_factory_config_errors_match_jax(tmp_path, attack, over, match):
    path = _config(tmp_path, attack, over)
    with pytest.raises(JaxConfigError, match=match):
        jax_build_network(jax_load_config(path))
    with pytest.raises(ConfigError, match=match):
        build_network_from_config(load_config(path), device="cpu")


def test_alie_coalition_of_two_builds(tmp_path):
    # The guard counts the colluders: 2 of 10 is enough.
    path = _config(tmp_path, {"type": "alie", "params": {"estimator": "coalition"}},
                   {"attack": {"percentage": 0.2}})
    assert build_attack(load_config(path)).compromised.sum() == 2


def _scaled_delta(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


@pytest.fixture(scope="module")
def femnist():
    return jax_data("leaf.femnist", {"num_samples": 640}, num_nodes=N, seed=SEED)


def _spread_init(jprog):
    """Node 0's initial parameters plus per-node offsets of distinct scales
    (as test_torch_round.py: the rules' decisions are then far from ties)."""
    rng = np.random.default_rng(SEED)
    scale = 0.02 * (1.0 + np.arange(N) / N)

    def leaf(a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape).astype(np.float32)
        return (a[:1] + scale.reshape((N,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)

    return jax.tree_util.tree_map(leaf, jprog.init_params)


# (label, attack type, attack kwargs, rule, rule kwargs, decision stats)
ROUNDS = [
    ("alie geometric_median dense", "alie", {"z": 1.5}, "geometric_median",
     {"max_candidates": 5}, ("agg_num_candidates",)),
    ("alie coalition trimmed_mean circulant", "alie", {"estimator": "coalition"},
     "trimmed_mean", {"max_candidates": 5, "trim_ratio": 0.2, "exchange_offsets": OFFSETS},
     ("agg_num_candidates", "agg_trimmed_per_side")),
    ("ipm balance circulant", "ipm", {}, "balance", {"exchange_offsets": OFFSETS},
     ("agg_acceptance_rate",)),
    ("directed krum dense", "directed_deviation", {}, "krum",
     {"num_compromised": 1, "max_candidates": 5}, ("agg_selected_index", "agg_selected_own")),
    ("label_flip trimmed_mean dense", "label_flip", {}, "trimmed_mean",
     {"max_candidates": 5, "trim_ratio": 0.2}, ("agg_num_candidates",)),
]


@pytest.mark.parametrize("label,kind,akw,rule,rkw,decisions", ROUNDS,
                         ids=[r[0] for r in ROUNDS])
def test_one_round_per_attack_matches_jax(femnist, label, kind, akw, rule, rkw, decisions):
    data = femnist
    jattack = JAX_ATTACKS[kind](N, 0.2, seed=SEED, **akw)
    attack = ATTACKS[kind](N, 0.2, seed=SEED, **akw)
    if jattack.data_poison_fn is not None:
        # The factories poison the shared arrays before the round copies them.
        data = jax_data("leaf.femnist", {"num_samples": 640}, num_nodes=N, seed=SEED)
        clean = data.y.copy()
        data.y = jattack.data_poison_fn(data.y, data.mask, data.num_classes)
        assert np.array_equal(attack.data_poison_fn(clean, data.mask, data.num_classes), data.y)
    hp = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)
    jprog = jax_build_round(jax_cnn(variant="tiny"), JAX_AGGREGATORS[rule](**rkw), data,
                            attack=jattack, **hp)
    init = _spread_init(jprog)
    adj = jax_topology("k-regular", N, k=4).mask()
    comp = jattack.compromised.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    j_params, _, j_metrics = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key, jnp.asarray(adj),
        jnp.asarray(comp), jnp.asarray(0.0, jnp.float32),
        {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()},
    )
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
    # The JAX round's shuffle (core/rounds.py: split(key) -> train/attack;
    # split(train_key, local_epochs); split(epoch_key) -> perm/step).
    train_key, _ = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))

    prog = build_round_program(make_femnist_cnn(variant="tiny"), AGGREGATORS[rule](**rkw), data,
                               attack=attack, init_params=init, device="cpu", **hp)
    flat, _, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.from_numpy(comp), 0.0,
        draws={"u": [u]},
    )
    assert _scaled_delta(flat.numpy(), j_flat) <= 1e-4
    assert set(metrics) == set(j_metrics)
    for k in decisions:
        assert np.array_equal(metrics[k].numpy(), np.asarray(j_metrics[k])), k
    init_flat = prog.init_flat.numpy()
    idx = np.flatnonzero(attack.compromised)
    # Compromised nodes train under label flip and ALIE's coalition
    # estimator, and stay frozen under the other attacks: their own rows
    # before aggregation are what the rule saw, so check through a rerun
    # of local training with the identity rule.
    local, _, _ = build_round_program(
        make_femnist_cnn(variant="tiny"), AGGREGATORS["fedavg"](), data, attack=attack,
        init_params=init, device="cpu", **hp,
    ).train_step(prog.init_flat, {}, torch.zeros((N, N)), torch.from_numpy(comp), 0.0,
                 draws={"u": [u]})
    moved = not np.array_equal(local.numpy()[idx], init_flat[idx])
    assert moved == attack.trains_locally
