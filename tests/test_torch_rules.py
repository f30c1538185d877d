"""The ported aggregation rules against their JAX counterparts on the same
own/bcast/adj, dense and circulant: fedavg, median, trimmed mean, geometric
median, BALANCE and Sketchguard.

Nodes sit around a common model with distinct spreads and a few of them
broadcast gaussian noise (std 10, the flagship's).  Outputs must be
allclose at rtol 1e-5 (atol 1e-5 on values of order 1, for the
geometric median's Weiszfeld steps, whose distances go through the Gram
identity in the dense path); acceptance, candidate counts and carried state
must be equal; thresholds and the other float stats allclose at rtol 1e-5,
except the dense geometric median's weight statistics (rtol 1e-4): they are
inverse distances from the iterate, and in the dense path those distances
come through the Gram identity, centred on a broadcast mean that the noise
rows pull far off, whose float32 cancellation moves them by about 1e-5
relative in either package.
The honest and poisoned distances sit far from the filters' thresholds, so
an equal acceptance checks the rule and not the rounding.  ``gamma`` small
enough that no neighbor passes drives BALANCE's and Sketchguard's
closest-neighbor fallback.  Sketchguard carries its acceptance window over
four rounds, so the attack factor of the fourth round reads three carried
rates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu_torch.aggregation import AGGREGATORS, build_aggregator
from murmura_tpu_torch.aggregation.base import AggContext

P = 2003
TOTAL_ROUNDS = 10


def _circulant_adj(n, offsets):
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
    return adj


def _states(n, poisoned, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, P))
    spread = 0.2 * (1.0 + np.arange(n) / n)
    own = (base + spread[:, None] * rng.normal(size=(n, P))).astype(np.float32)
    bcast = own.copy()
    bcast[poisoned] += (10.0 * rng.normal(size=(len(poisoned), P))).astype(np.float32)
    return own, bcast


CASES = {
    # name: (n, offsets of the k-regular graph, poisoned rows)
    "k4": (16, [1, 2, 14, 15], [3, 7, 12]),
    "ring": (10, [1, 9], [4]),
    "k6": (12, [1, 2, 3, 9, 10, 11], [0, 5]),
}
CANDIDATE_RULES = ("median", "trimmed_mean", "geometric_median")


def _params(rule, n, offsets, mode, extra):
    kw = dict(extra)
    if rule in CANDIDATE_RULES:
        kw["max_candidates"] = len(offsets) + 1
    if mode == "circulant":
        kw["exchange_offsets"] = offsets
    if rule == "sketchguard":
        kw.update(model_dim=P, sketch_size=200)
    return kw


def _stat_rtol(rule, kw):
    dense_gm = rule == "geometric_median" and "exchange_offsets" not in kw
    return 1e-4 if dense_gm else 1e-5


def _run_both(rule, kw, own, bcast, adj, rounds=1):
    jr, tr = JAX_AGGREGATORS[rule](**kw), AGGREGATORS[rule](**kw)
    n = own.shape[0]
    j_state = {k: jnp.asarray(v) for k, v in jr.init_state(n).items()}
    t_state = {k: torch.as_tensor(v) for k, v in tr.init_state(n).items()}
    out = []
    for r in range(rounds):
        j_new, j_state, j_stats = jr.aggregate(
            jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
            jnp.asarray(float(r), jnp.float32), j_state, JaxCtx(total_rounds=TOTAL_ROUNDS),
        )
        t_new, t_state, t_stats = tr.aggregate(
            torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj),
            float(r), t_state, AggContext(total_rounds=TOTAL_ROUNDS),
        )
        out.append((np.asarray(j_new), {k: np.asarray(v) for k, v in j_stats.items()},
                    {k: np.asarray(v) for k, v in j_state.items()},
                    t_new.numpy(), {k: v.numpy() for k, v in t_stats.items()},
                    {k: v.numpy() for k, v in t_state.items()}))
    return out


EXACT_STATS = ("num_neighbors", "num_candidates", "trimmed_per_side", "acceptance_rate",
               "compression_ratio")


def _assert_round(j_new, j_stats, j_state, t_new, t_stats, t_state, stat_rtol=1e-5):
    assert t_new.dtype == j_new.dtype
    np.testing.assert_allclose(t_new, j_new, rtol=1e-5, atol=1e-5)
    assert set(t_stats) == set(j_stats)
    for k in j_stats:
        if k in EXACT_STATS:
            assert np.array_equal(t_stats[k], j_stats[k]), k
        else:
            np.testing.assert_allclose(t_stats[k], j_stats[k], rtol=stat_rtol, err_msg=k)
    assert set(t_state) == set(j_state)
    for k in j_state:
        assert np.array_equal(t_state[k], j_state[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["dense", "circulant"])
@pytest.mark.parametrize(
    "rule", ["fedavg", "median", "trimmed_mean", "geometric_median", "balance", "sketchguard"]
)
def test_rule_matches_jax(rule, mode, case):
    n, offsets, poisoned = CASES[case]
    own, bcast = _states(n, poisoned, seed=n + len(rule))
    kw = _params(rule, n, offsets, mode, {})
    rounds = 4 if rule == "sketchguard" else 1
    for got in _run_both(rule, kw, own, bcast, _circulant_adj(n, offsets), rounds):
        _assert_round(*got, stat_rtol=_stat_rtol(rule, kw))


@pytest.mark.parametrize("mode", ["dense", "circulant"])
@pytest.mark.parametrize("rule", ["balance", "sketchguard"])
def test_closest_neighbor_fallback_matches_jax(rule, mode):
    n, offsets, poisoned = CASES["k4"]
    own, bcast = _states(n, poisoned, seed=3)
    kw = _params(rule, n, offsets, mode, {"gamma": 1e-3})
    rounds = 4 if rule == "sketchguard" else 1
    results = _run_both(rule, kw, own, bcast, _circulant_adj(n, offsets), rounds)
    for got in results:
        _assert_round(*got)
        # Nothing passes the threshold: each node accepts its closest neighbor only.
        assert np.array_equal(got[4]["acceptance_rate"], np.full(n, 1.0 / len(offsets), np.float32))
    if rule == "sketchguard":
        # Three carried rates of 0.25 < 0.3: the fourth round's threshold is boosted.
        np.testing.assert_allclose(
            results[3][4]["threshold"] / results[2][4]["threshold"],
            1.5 * np.exp(-1.0 / TOTAL_ROUNDS), rtol=1e-5,
        )


@pytest.mark.parametrize("rule", ["fedavg", "median", "trimmed_mean", "geometric_median", "balance"])
def test_dense_rule_on_an_irregular_graph(rule):
    # Per-node candidate counts (and trim depths) differ across nodes.
    rng = np.random.default_rng(5)
    n = 12
    upper = np.triu(rng.random((n, n)) < 0.4, 1)
    adj = (upper | upper.T).astype(np.float32)
    own, bcast = _states(n, [4], seed=5)
    kw = {"max_candidates": int(adj.sum(1).max()) + 1} if rule in CANDIDATE_RULES else {}
    for got in _run_both(rule, kw, own, bcast, adj):
        _assert_round(*got, stat_rtol=_stat_rtol(rule, kw))


@pytest.mark.parametrize("rule", ["fedavg", "median", "trimmed_mean", "geometric_median"])
def test_fully_connected_without_candidate_cap(rule):
    n = 9
    own, bcast = _states(n, [2, 6], seed=40)
    adj = (np.ones((n, n)) - np.eye(n)).astype(np.float32)
    for got in _run_both(rule, {}, own, bcast, adj):
        _assert_round(*got, stat_rtol=_stat_rtol(rule, {}))


@pytest.mark.parametrize("rule", sorted(AGGREGATORS))
def test_sparse_exchange_refused_by_name(rule):
    # The sparse edge-mask exchange runs on the circulant paths
    # (tests/test_torch_sparse.py); without offsets it is refused by name.
    kw = {"sparse_exchange": True}
    if rule == "sketchguard":
        kw["model_dim"] = 10
    with pytest.raises(ValueError, match="sparse_exchange requires exchange_offsets"):
        AGGREGATORS[rule](**kw)


def test_build_aggregator_injects_model_dim_and_drops_total_rounds():
    agg = build_aggregator("sketchguard", {"total_rounds": 7, "sketch_size": 5}, model_dim=40)
    state = {k: torch.as_tensor(v) for k, v in agg.init_state(3).items()}
    x = torch.ones((3, 40))
    _, _, stats = agg.aggregate(x, x, torch.ones((3, 3)) - torch.eye(3), 0.0, state, AggContext())
    assert torch.equal(stats["compression_ratio"], torch.full((3,), 8.0))
