"""One full FL round of the PyTorch port against the JAX package's round
program: k-regular(4) over 16 nodes, the tiny FEMNIST CNN in float32, 20%
gaussian attack (std 10), Krum and every other ported rule, in both
exchange modes.

The JAX round's own random draws are fed to the port through its RNG seam:
the epoch shuffle ``u`` and the attack's [C, P] noise, derived here from the
round key exactly as murmura_tpu/core/rounds.py splits it.  The post-round
[N, P] parameters agree to a scaled delta of 1e-4 (max |port - jax| over
max(1, max |jax|)), Krum's selection and the filters' acceptance are
equal.  Also here: the numpy layers
the round reads (data, topology, compromised-set selection, the attack)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.attacks.base import select_compromised as jax_select
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.cnn import make_femnist_cnn as jax_cnn
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.attacks.base import select_compromised
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.data.registry import build_federated_data
from murmura_tpu_torch.models.cnn import make_femnist_cnn
from murmura_tpu_torch.ops.flatten import model_dimension
from murmura_tpu_torch.topology.generators import create_topology

N = 16
SEED = 7
OFFSETS = [1, 2, 14, 15]
DATA_PARAMS = {"num_samples": 640}


def _scaled_delta(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


@pytest.fixture(scope="module")
def setup():
    data = jax_data("leaf.femnist", DATA_PARAMS, num_nodes=N, seed=SEED)
    attack = jax_gaussian(N, 0.2, noise_std=10.0, seed=SEED)
    return data, attack


def _spread_init(jprog):
    """Node 0's initial params for every node, plus per-node gaussian
    offsets of distinct scales.  With the JAX package's own init every pair
    of honest nodes sits at nearly the same distance (independent draws of
    one distribution), so Krum's scores tie to within the Gram identity's
    float32 cancellation noise and either package may pick either
    candidate; distinct spreads separate the scores far beyond that noise,
    so equal selection is a real check."""
    rng = np.random.default_rng(SEED)
    scale = 0.02 * (1.0 + np.arange(N) / N)

    def leaf(a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape).astype(np.float32)
        return (a[:1] + scale.reshape((N,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)

    return jax.tree_util.tree_map(leaf, jprog.init_params)


def _round_pair(setup, jax_agg, agg):
    """One seeded round through the JAX round program and through the port
    from the same spread initial parameters, with the JAX round's own draws
    fed to the port.  Returns (jprog, j_params, j_flat, j_metrics, prog,
    flat, metrics)."""
    data, jattack = setup
    hp = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)
    jprog = jax_build_round(jax_cnn(variant="tiny"), jax_agg, data, attack=jattack, **hp)
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

    # The JAX round's draws (core/rounds.py: split(key) -> train/attack;
    # split(train_key, local_epochs); split(epoch_key) -> perm/step).
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))
    noise = np.asarray(
        jax.random.normal(attack_key, (int(comp.sum()), j_flat.shape[1]), jnp.float32)
    )

    prog = build_round_program(
        make_femnist_cnn(variant="tiny"), agg, data,
        attack=make_gaussian_attack(N, 0.2, noise_std=10.0, seed=SEED),
        init_params=init, device="cpu", **hp,
    )
    init_ref = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(init))
    assert np.array_equal(prog.init_flat.numpy(), init_ref)
    flat, _, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.from_numpy(comp), 0.0,
        draws={"u": [u], "noise": noise},
    )
    return jprog, j_params, j_flat, j_metrics, prog, flat, metrics


@pytest.mark.parametrize("mode", ["allgather", "ppermute"])
def test_one_round_matches_jax(setup, mode):
    kw = {"num_compromised": 1, "max_candidates": len(OFFSETS) + 1}
    if mode == "ppermute":
        kw["exchange_offsets"] = OFFSETS
    jprog, j_params, j_flat, j_metrics, prog, flat, metrics = _round_pair(
        setup, jax_make_krum(**kw), make_krum(**kw)
    )
    assert np.array_equal(
        metrics["agg_selected_index"].numpy(), np.asarray(j_metrics["agg_selected_index"])
    )
    assert np.array_equal(
        metrics["agg_selected_own"].numpy(), np.asarray(j_metrics["agg_selected_own"])
    )
    # Krum really selected here (c=1 < (5-2)/2), not the own-state fallback.
    assert not bool(metrics["agg_selected_own"].all())
    assert _scaled_delta(flat.numpy(), j_flat) <= 1e-4
    # The circulant path takes each distance as a direct subtract-square-
    # sum.  The dense path goes through the Gram identity, centered on the
    # broadcast mean, which the three std-10 noise rows pull far from the
    # honest cluster: its float32 cancellation leaves each score about 1e-4
    # relative off the exact value in either package, so the dense scores
    # agree to 1e-3.
    score_tol = 1e-4 if mode == "ppermute" else 1e-3
    assert _scaled_delta(metrics["agg_krum_score"].numpy(), j_metrics["agg_krum_score"]) <= score_tol

    j_eval = jax.jit(jprog.eval_step)(
        j_params, {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    )
    t_eval = prog.eval_step(flat)
    np.testing.assert_allclose(
        t_eval["loss"].numpy(), np.asarray(j_eval["loss"]), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        t_eval["accuracy"].numpy(), np.asarray(j_eval["accuracy"]), atol=1e-6
    )


def test_seeded_round_runs_and_freezes_compromised(setup):
    """Without injected draws the port draws its own (torch.Generator) and
    still keeps compromised nodes' own state untrained."""
    data, _ = setup
    attack = make_gaussian_attack(N, 0.2, noise_std=10.0, seed=SEED)
    prog = build_round_program(
        make_femnist_cnn(variant="tiny"),
        make_krum(num_compromised=3, max_candidates=5), data,
        attack=attack, local_epochs=1, batch_size=16, lr=0.05, seed=SEED, device="cpu",
    )
    from murmura_tpu_torch.core.rounds import round_generators

    adj = torch.from_numpy(create_topology("k-regular", N, k=4).mask())
    comp = torch.from_numpy(attack.compromised.astype(np.float32))
    flat, _, metrics = prog.train_step(
        prog.init_flat, {}, adj, comp, 0.0,
        generators=round_generators(SEED, 0, "cpu"),
    )
    # c=3 with m=5 fails the Krum constraint: every node keeps its own
    # state, so compromised rows are exactly their (frozen) initial rows.
    assert bool(metrics["agg_selected_own"].all())
    idx = np.flatnonzero(attack.compromised)
    assert torch.equal(flat[idx], prog.init_flat[idx])
    honest = np.flatnonzero(~attack.compromised)
    assert not torch.equal(flat[honest], prog.init_flat[honest])
    again, _, _ = prog.train_step(
        prog.init_flat, {}, adj, comp, 0.0,
        generators=round_generators(SEED, 0, "cpu"),
    )
    assert torch.equal(flat, again)


@pytest.mark.parametrize(
    "adapter,params",
    [
        ("leaf.femnist", {"num_samples": 640}),
        ("leaf.femnist", {"num_samples": 500, "partition_method": "iid",
                          "holdout_fraction": 0.0}),
        ("synthetic", {"num_samples": 300, "input_dim": 12, "num_classes": 4,
                       "partition_method": "dirichlet", "alpha": 0.3}),
    ],
)
def test_data_matches_jax(adapter, params):
    ref = jax_data(adapter, params, num_nodes=8, seed=3, max_samples=None)
    got = build_federated_data(adapter, params, num_nodes=8, seed=3, max_samples=None)
    for name in ("x", "y", "mask", "num_samples", "x_test", "y_test", "mask_test"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b), name
    assert got.num_classes == ref.num_classes


@pytest.mark.parametrize(
    "kind,kw",
    [("ring", {}), ("fully", {}), ("erdos", {"p": 0.3, "seed": 5}),
     ("k-regular", {"k": 4}), ("k-regular", {"k": 3}), ("k-regular", {"k": 20})],
)
def test_topology_matches_jax(kind, kw):
    ref = jax_topology(kind, 16, **kw)
    got = create_topology(kind, 16, **kw)
    assert np.array_equal(got.adjacency, ref.adjacency)
    assert got.circulant_offsets() == ref.circulant_offsets()


@pytest.mark.parametrize("n,pct,seed", [(16, 0.2, 7), (10, 0.05, 1), (33, 0.5, 42), (8, 0.0, 3)])
def test_compromised_selection_matches_jax(n, pct, seed):
    assert np.array_equal(select_compromised(n, pct, seed), jax_select(n, pct, seed))


def test_gaussian_attack_matches_jax():
    flat = np.random.default_rng(0).normal(size=(N, 100)).astype(np.float32)
    jatk = jax_gaussian(N, 0.2, noise_std=10.0, seed=SEED)
    comp = jatk.compromised.astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jatk.apply(jnp.asarray(flat), jnp.asarray(comp), key, 0))
    noise = np.array(jax.random.normal(key, (int(comp.sum()), 100), jnp.float32))
    got = make_gaussian_attack(N, 0.2, noise_std=10.0, seed=SEED).apply(
        torch.from_numpy(flat), torch.from_numpy(comp), noise=torch.from_numpy(noise)
    )
    assert np.array_equal(got.numpy(), ref)
    honest = ~jatk.compromised
    assert np.array_equal(got.numpy()[honest], flat[honest])


RULE_PARAMS = {
    "fedavg": {},
    "median": {"max_candidates": len(OFFSETS) + 1},
    "trimmed_mean": {"max_candidates": len(OFFSETS) + 1, "trim_ratio": 0.2},
    "geometric_median": {"max_candidates": len(OFFSETS) + 1},
    "balance": {},
    "sketchguard": {},
}


@pytest.mark.parametrize("mode", ["allgather", "ppermute"])
@pytest.mark.parametrize("rule", sorted(RULE_PARAMS))
def test_one_round_of_each_rule_matches_jax(setup, rule, mode):
    """The other ported rules in the same round: parameters to a scaled
    delta of 1e-4, the same stats, and equal acceptance and candidate
    counts."""
    kw = dict(RULE_PARAMS[rule])
    if mode == "ppermute":
        kw["exchange_offsets"] = OFFSETS
    if rule == "sketchguard":
        kw["model_dim"] = model_dimension(
            make_femnist_cnn(variant="tiny").init(torch.Generator().manual_seed(0), "cpu")
        )
    _, _, j_flat, j_metrics, _, flat, metrics = _round_pair(
        setup, JAX_AGGREGATORS[rule](**kw), AGGREGATORS[rule](**kw)
    )
    assert _scaled_delta(flat.numpy(), j_flat) <= 1e-4
    assert set(metrics) == set(j_metrics)
    for k in ("agg_acceptance_rate", "agg_num_candidates", "agg_num_neighbors"):
        if k in metrics:
            assert np.array_equal(metrics[k].numpy(), np.asarray(j_metrics[k])), k
    if rule in ("balance", "sketchguard"):
        # The three std-10 rows are rejected somewhere: the filter decided.
        assert float(metrics["agg_acceptance_rate"].min()) < 1.0
