"""Evidential trust in the PyTorch port against the JAX package, on the same
own/bcast/adj, state and probe batches.

- ``evidential_trust_metric`` (accuracy, vacuity, entropy, strength of
  Dirichlet alphas) within rtol 1e-5, alone and through both probes;
- the rule in both exchanges (dense on a circulant and on an irregular
  graph, and circulant), with the strength guard, the EMA and the
  tightening threshold each on and off, over two chained rounds (the
  second at another round index and on moved states): accepted counts and
  per-edge acceptances equal (the rates within an ulp), mean trust, vacuity and entropy within rtol
  1e-5, the output within atol/rtol 1e-5, the carried state within rtol
  1e-5 with the same edges seen, and the state tensors handed in left as
  they were.  The threshold within rtol 1e-6: both packages compute the
  schedule in float32, but XLA's float32 exp is not correctly rounded and
  torch's is, so the two can sit one ulp apart (an acceptance would flip
  only for a trust inside that ulp);
- a NaN-strength row (a NaN weight) and an inf-strength row (a head bias
  whose alphas overflow the sum), with the guard on and off: the same
  acceptances, the NaN reaching ``mean_vacuity`` and ``mean_entropy`` where
  JAX lets it through, and ``record_round_metrics`` taking it;
- the sparse exchange refused by name;
- one evidential wearable-MLP round (UCI HAR widths, dropout 0.3, 8 nodes
  fully connected, a gaussian attack of std 10) in both exchanges, fed the
  JAX round's own shuffle, dropout masks and noise: post-round parameters
  within a scaled delta of 1e-4, accepted counts equal.

The models are the evidential plain MLP (and the wearable MLP), with
JAX-initialised weights carried over.  Nodes sit around node 0's weights
with distinct spreads (0.2 to 0.4), so the honest neighbours' trusts
spread over 0.16-0.41 and a threshold of 0.25 splits them far from any
tie; two nodes broadcast noise of std 10, whose Dirichlet strength the
guard catches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.evidential_trust import make_evidential_trust as jax_make_et
from murmura_tpu.aggregation.probe import circulant_probe_eval as jax_circulant_probe
from murmura_tpu.aggregation.probe import evidential_trust_metric as jax_et_metric
from murmura_tpu.aggregation.probe import pairwise_probe_eval as jax_pairwise_probe
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.models.mlp import make_wearable_mlp as jax_wearable_mlp
from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.aggregation.evidential_trust import make_evidential_trust
from murmura_tpu_torch.aggregation.probe import (
    circulant_probe_eval,
    evidential_trust_metric,
    pairwise_probe_eval,
)
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.core.network import empty_history, record_round_metrics
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.models.mlp import make_mlp, make_wearable_mlp
from murmura_tpu_torch.ops.flatten import make_flatteners, tree_to_torch

N = 12
B = 10
IN_DIM, HIDDEN, K = 20, (32, 16), 5
OFFSETS = [1, 2, 10, 11]  # k-regular(4) on 12 nodes
POISONED = [2, 7]
TOTAL_ROUNDS = 10
STATS = ("acceptance_rate", "mean_trust", "mean_vacuity", "mean_entropy", "threshold")


def _circulant_adj(n, offsets):
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
    return adj


def _irregular_adj(n, seed):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < 0.5, 1)
    return (upper | upper.T).astype(np.float32)


def _setup(seed):
    """(jax ctx, port ctx, own, bcast, unravel): spread evidential-MLP
    states, two of them broadcasting noise of std 10, and per-node probe
    batches with a few padded slots."""
    jmodel = jax_mlp(IN_DIM, HIDDEN, K, evidential=True)
    template = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    flat0, j_unravel = ravel_pytree(template)
    model = make_mlp(IN_DIM, HIDDEN, K, evidential=True)
    rng = np.random.default_rng(seed)
    spread = 0.2 * (1.0 + np.arange(N) / N)
    own = (np.asarray(flat0)[None] + spread[:, None] * rng.normal(size=(N, flat0.size)))
    own = own.astype(np.float32)
    bcast = own.copy()
    bcast[POISONED] += (10.0 * rng.normal(size=(len(POISONED), flat0.size))).astype(np.float32)
    px = rng.normal(size=(N, B, IN_DIM)).astype(np.float32)
    py = rng.integers(0, K, size=(N, B)).astype(np.int32)
    pm = (rng.random((N, B)) < 0.9).astype(np.float32)
    jctx = JaxCtx(apply_fn=jmodel.apply, unravel=j_unravel, probe_x=jnp.asarray(px),
                  probe_y=jnp.asarray(py), probe_mask=jnp.asarray(pm), evidential=True,
                  num_classes=K, total_rounds=TOTAL_ROUNDS)
    _, t_unravel, _ = make_flatteners(tree_to_torch(template))
    tctx = AggContext(apply_fn=model.apply, unravel=t_unravel,
                      probe_x=torch.from_numpy(px), probe_y=torch.from_numpy(py).long(),
                      probe_mask=torch.from_numpy(pm), evidential=True, num_classes=K,
                      total_rounds=TOTAL_ROUNDS)
    return jctx, tctx, own, bcast, t_unravel


def test_metric_matches_jax():
    rng = np.random.default_rng(0)
    alpha = (1.0 + np.exp(2.0 * rng.normal(size=(16, 6)))).astype(np.float32)
    y = rng.integers(0, 6, size=16).astype(np.int32)
    m = (rng.random(16) < 0.8).astype(np.float32)
    ref = jax_et_metric(jnp.asarray(alpha), jnp.asarray(y), jnp.asarray(m))
    got = evidential_trust_metric(torch.from_numpy(alpha), torch.from_numpy(y).long(),
                                  torch.from_numpy(m))
    assert set(got) == set(ref) == {"accuracy", "vacuity", "entropy", "strength"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("offsets", [None, OFFSETS])
def test_probes_with_the_metric_match_jax(offsets):
    jctx, tctx, _, bcast, _ = _setup(1)
    if offsets is None:
        ref = jax_pairwise_probe(jnp.asarray(bcast), jctx, jax_et_metric)
        got = pairwise_probe_eval(torch.from_numpy(bcast), tctx, evidential_trust_metric)
    else:
        ref = jax_circulant_probe(jnp.asarray(bcast), offsets, jctx, jax_et_metric)
        got = circulant_probe_eval(torch.from_numpy(bcast), offsets, tctx,
                                   evidential_trust_metric)
    for k in ("vacuity", "entropy", "strength"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, err_msg=k)
    assert np.array_equal(got["accuracy"].numpy(), np.asarray(ref["accuracy"]))


def _states(jrule_state, rule_state):
    return ({k: jnp.asarray(np.asarray(v)) for k, v in jrule_state.items()},
            {k: torch.as_tensor(np.asarray(v)) for k, v in rule_state.items()})


def _accepted(state, threshold, adj, offsets):
    """Per-edge acceptances [N, N] from the carried trust: the trust the
    rule thresholded (EMA on) at the graph's edges."""
    edges = adj > 0 if offsets is None else _circulant_adj(N, offsets) > 0
    return (np.asarray(state["smoothed_trust"]) >= np.asarray(threshold)[:, None]) & edges


def _assert_same_acceptances(got, ref, degree):
    """Equal accepted counts per node; the rates within rtol 1e-6 (under jit
    XLA divides by a constant k as a product with its float32 reciprocal,
    one ulp from torch's division when k is not a power of 2)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.rint(got * degree), np.rint(ref * degree))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def _check_round(j_out, t_out, kw, adj, offsets):
    (j_new, j_state, j_stats), (t_new, t_state, t_stats) = j_out, t_out
    assert set(t_stats) == set(j_stats) == set(STATS)
    degree = len(offsets) if offsets else adj.sum(axis=1)
    _assert_same_acceptances(t_stats["acceptance_rate"].numpy(), j_stats["acceptance_rate"],
                             degree)
    for k in ("mean_trust", "mean_vacuity", "mean_entropy"):
        np.testing.assert_allclose(t_stats[k].numpy(), np.asarray(j_stats[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(t_stats["threshold"].numpy(), np.asarray(j_stats["threshold"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(j_new), rtol=1e-5, atol=1e-5)
    assert set(t_state) == set(j_state) == {"smoothed_trust", "trust_seen"}
    assert np.array_equal(t_state["trust_seen"].numpy(), np.asarray(j_state["trust_seen"]))
    np.testing.assert_allclose(t_state["smoothed_trust"].numpy(),
                               np.asarray(j_state["smoothed_trust"]), rtol=1e-5, atol=1e-7)
    if kw.get("use_adaptive_trust", True):
        t_acc = _accepted(t_state, t_stats["threshold"].numpy(), adj, offsets)
        j_acc = _accepted(j_state, np.asarray(j_stats["threshold"]), adj, offsets)
        assert np.array_equal(t_acc, j_acc)
        return t_acc
    return None


RULES = {
    "all on": {"trust_threshold": 0.5},
    "no guard": {"trust_threshold": 0.5, "strength_guard": False},
    "no ema": {"trust_threshold": 0.5, "use_adaptive_trust": False},
    "no tightening": {"trust_threshold": 0.25, "use_tightening_threshold": False},
}


@pytest.mark.parametrize("graph", ["dense", "irregular", "circulant"])
@pytest.mark.parametrize("variant", sorted(RULES))
def test_rule_matches_jax_over_two_rounds(variant, graph):
    kw = dict(RULES[variant])
    offsets = OFFSETS if graph == "circulant" else None
    if offsets:
        kw["exchange_offsets"] = offsets
    adj = _irregular_adj(N, 5) if graph == "irregular" else _circulant_adj(N, OFFSETS)
    jctx, tctx, own, bcast, _ = _setup(3)
    jrule, rule = jax_make_et(**kw), make_evidential_trust(**kw)
    j_state, t_state = _states(jrule.init_state(N), rule.init_state(N))
    rng = np.random.default_rng(9)
    accepted = []
    for round_idx in (0.0, 1.0):
        handed = {k: v.clone() for k, v in t_state.items()}
        j_out = jrule.aggregate(jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
                                jnp.asarray(round_idx, jnp.float32), j_state, jctx)
        t_out = rule.aggregate(torch.from_numpy(own), torch.from_numpy(bcast),
                               torch.from_numpy(adj), round_idx, t_state, tctx)
        # The rule writes no tensor it was handed.
        assert all(torch.equal(handed[k], t_state[k]) for k in handed)
        acc = _check_round(j_out, t_out, kw, adj, offsets)
        rates = t_out[2]["acceptance_rate"].numpy()
        # The threshold decided: some edge was rejected, some accepted.
        assert rates.min() < 1.0 and rates.max() > 0.0, rates
        if acc is not None:
            accepted.append(acc)
        j_state, t_state = j_out[1], t_out[1]
        own = (own + 0.05 * rng.normal(size=own.shape)).astype(np.float32)
        bcast = own.copy()
        bcast[POISONED] += (10.0 * rng.normal(size=(2, own.shape[1]))).astype(np.float32)
    if variant == "no guard":
        # The noise broadcasts (vacuity ~ 0) are accepted somewhere.
        poisoned_cols = accepted[0][:, POISONED]
        assert poisoned_cols.any()
    elif variant != "no ema":
        assert not accepted[0][:, POISONED].any() and not accepted[1][:, POISONED].any()


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("offsets", [None, OFFSETS], ids=["dense", "circulant"])
def test_nan_and_inf_strength_rows_match_jax(offsets, guard):
    jctx, tctx, own, bcast, t_unravel = _setup(4)
    # No padded probe slots: an inf strength times a mask of 0 would be NaN.
    ones = np.ones((N, B), np.float32)
    jctx = dataclasses.replace(jctx, probe_mask=jnp.asarray(ones))
    tctx = dataclasses.replace(tctx, probe_mask=torch.from_numpy(ones))
    # Node 2 broadcasts a NaN weight (every output NaN); node 7 a head bias
    # whose alphas sum to +inf (strength inf, vacuity 0, entropy 0).
    flat7 = torch.from_numpy(bcast[7].copy())
    t_unravel(flat7)["head"]["b"].fill_(3e38)  # a view into flat7
    bcast[7] = flat7.numpy()
    bcast[2, 0] = np.nan
    kw = {"trust_threshold": 0.5, "strength_guard": guard}
    if offsets:
        kw["exchange_offsets"] = offsets
    adj = _circulant_adj(N, OFFSETS)
    jrule, rule = jax_make_et(**kw), make_evidential_trust(**kw)
    j_state, t_state = _states(jrule.init_state(N), rule.init_state(N))
    metrics = pairwise_probe_eval(torch.from_numpy(bcast), tctx, evidential_trust_metric)
    assert torch.isnan(metrics["strength"][:, 2]).all()
    assert torch.isinf(metrics["strength"][:, 7]).all()
    j_new, j_state2, j_stats = jrule.aggregate(
        jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj), jnp.asarray(0.0, jnp.float32),
        j_state, jctx)
    t_new, t_state2, t_stats = rule.aggregate(
        torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj), 0.0, t_state, tctx)
    _assert_same_acceptances(t_stats["acceptance_rate"].numpy(), j_stats["acceptance_rate"],
                             len(offsets) if offsets else adj.sum(axis=1))
    for k in ("mean_trust", "mean_vacuity", "mean_entropy"):
        got, ref = t_stats[k].numpy(), np.asarray(j_stats[k])
        assert np.array_equal(np.isnan(got), np.isnan(ref)), k
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7, err_msg=k)
    # NaN vacuity and entropy reach the stats; the inf row's are finite.
    assert np.isnan(t_stats["mean_vacuity"].numpy()).any()
    j_st, t_st = np.asarray(j_state2["smoothed_trust"]), t_state2["smoothed_trust"].numpy()
    assert np.array_equal(np.isnan(t_st), np.isnan(j_st))
    np.testing.assert_allclose(t_st, j_st, rtol=1e-5, atol=1e-7)
    edges = adj > 0
    accepted = (np.nan_to_num(t_st, nan=-1.0) >= t_stats["threshold"].numpy()[:, None]) & edges
    assert not accepted[:, 2].any()
    # The guard zeroes the non-finite strength; without it the inf row's
    # trust is finite and it is accepted.
    assert accepted[:, 7].any() != guard
    np.testing.assert_allclose(np.nan_to_num(t_new.numpy()), np.nan_to_num(np.asarray(j_new)),
                               rtol=1e-5, atol=1e-5)
    history = empty_history()
    record_round_metrics(
        history, 1, {"loss": np.zeros(N), "accuracy": np.zeros(N),
                     **{f"agg_{k}": v for k, v in t_stats.items()}},
        np.zeros(N), evidential=False, has_attack=False)
    assert np.isnan(history["agg_mean_vacuity"][0])
    # The guard zeroes the NaN row's trust; without it the NaN reaches the mean.
    assert np.isfinite(history["agg_mean_trust"][0]) == guard


def test_sparse_exchange_refused_by_name():
    with pytest.raises(ValueError, match="not ported"):
        build_aggregator("evidential_trust", {"exchange_offsets": [1], "sparse_exchange": True})


def _jax_masks(key, widths, batch, keep):
    keys = jax.random.split(key, len(widths))
    return [np.array(jax.random.bernoulli(k, keep, (batch, w))) for k, w in zip(keys, widths)]


@pytest.mark.parametrize("exchange", ["dense", "circulant"])
def test_evidential_mlp_round_matches_jax(exchange):
    n, seed = 8, 11
    data = jax_data("wearables.uci_har", {"num_samples": 320, "partition_method": "dirichlet",
                                          "alpha": 0.5}, num_nodes=n, seed=seed)
    hp = dict(local_epochs=1, batch_size=16, lr=0.05, seed=seed, total_rounds=10,
              probe_size=20)
    kw = {"trust_threshold": 0.5}
    if exchange == "circulant":
        kw["exchange_offsets"] = list(range(1, n))
    jattack = jax_gaussian(n, 0.25, noise_std=10.0, seed=seed)
    jprog = jax_build_round(jax_wearable_mlp(), jax_make_et(**kw), data, attack=jattack, **hp)
    rng = np.random.default_rng(seed)
    scale = 0.2 * (1.0 + np.arange(n) / n)
    init = jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((n,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)
    adj = (np.ones((n, n)) - np.eye(n)).astype(np.float32)
    comp = jattack.compromised.astype(np.float32)
    round_idx = 3.0
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    j_params, _, j_metrics = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key,
        jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(round_idx, jnp.float32), d)
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))

    # The JAX round's draws (test_torch_wearables.py spells out the order).
    train_key, attack_key = jax.random.split(key)
    steps = int(data.steps_per_epoch(16).max())
    batch = int(data.effective_batch(16).max())
    perm_key, step_key = jax.random.split(jax.random.split(train_key, 1)[0])
    u = [np.array(jax.random.uniform(perm_key, data.mask.shape))]
    dropout = [[
        [np.stack([m[layer] for m in per_node]) for layer in range(2)]
        for per_node in (
            [_jax_masks(k, (256, 128), batch, 0.7)
             for k in jax.random.split(jax.random.fold_in(step_key, t), n)]
            for t in range(steps))
    ]]
    noise = np.array(jax.random.normal(attack_key, (int(comp.sum()), j_flat.shape[1])))

    prog = build_round_program(
        make_wearable_mlp(), make_evidential_trust(**kw), data,
        attack=make_gaussian_attack(n, 0.25, noise_std=10.0, seed=seed),
        init_params=init, device="cpu", **hp)
    flat, state, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.from_numpy(comp),
        round_idx, draws={"u": u, "noise": noise, "dropout": dropout})
    scaled = float(np.max(np.abs(flat.numpy() - j_flat)) / max(1.0, np.max(np.abs(j_flat))))
    assert scaled <= 1e-4
    assert set(metrics) == set(j_metrics) == {f"agg_{k}" for k in STATS}
    _assert_same_acceptances(metrics["agg_acceptance_rate"].numpy(),
                             j_metrics["agg_acceptance_rate"], n - 1)
    rates = metrics["agg_acceptance_rate"].numpy()
    assert rates.min() < 1.0 and rates.max() > 0.0
    np.testing.assert_allclose(metrics["agg_mean_trust"].numpy(),
                               np.asarray(j_metrics["agg_mean_trust"]), rtol=1e-4, atol=1e-6)


def test_rule_is_registered_with_its_state():
    rule = build_aggregator("evidential_trust", {"max_eval_samples": 50, "total_rounds": 9})
    assert rule.name == "evidential_trust"
    state = rule.init_state(5)
    assert {k: (v.shape, v.dtype) for k, v in state.items()} == {
        "smoothed_trust": ((5, 5), np.float32), "trust_seen": ((5, 5), np.float32)}
