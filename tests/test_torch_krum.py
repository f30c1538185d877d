"""Krum in the PyTorch port against murmura_tpu.aggregation.krum on the same
own/bcast/adj: dense (candidate blocks over the pairwise distances) and
circulant (delta vectors over the circulant distances), with gaussian-
poisoned broadcast rows and the c < (m-2)/2 own-state fallback.

``selected_index`` and ``selected_own`` must be equal; outputs and
``krum_score`` allclose at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.aggregation.base import AggContext, candidate_indices
from murmura_tpu_torch.aggregation.krum import make_krum


def _circulant_adj(n, offsets):
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
        adj[(np.arange(n) + o) % n, np.arange(n)] = 1.0
    return adj


def _states(n, p, poisoned, seed):
    """Nodes spread around a common model with distinct spreads (no
    near-ties in the scores); ``poisoned`` rows broadcast gaussian noise
    (std 10, the flagship's).  The honest spread keeps the pairwise
    distances well above the Gram identity's float32 cancellation noise,
    which differs between the two frameworks' matmuls."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, p)) * 0.5
    spread = 0.5 * (1.0 + np.arange(n) / n)
    own = (base + spread[:, None] * rng.normal(size=(n, p))).astype(np.float32)
    bcast = own.copy()
    bcast[poisoned] += (10.0 * rng.normal(size=(len(poisoned), p))).astype(np.float32)
    return own, bcast


def _compare(jax_agg, agg, own, bcast, adj):
    j_new, _, j_stats = jax_agg.aggregate(
        jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
        jnp.asarray(0.0, jnp.float32), {}, JaxCtx(),
    )
    t_new, _, t_stats = agg.aggregate(
        torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj),
        0.0, {}, AggContext(),
    )
    assert np.array_equal(
        t_stats["selected_index"].numpy(), np.asarray(j_stats["selected_index"])
    )
    assert np.array_equal(
        t_stats["selected_own"].numpy(), np.asarray(j_stats["selected_own"])
    )
    np.testing.assert_allclose(
        t_stats["krum_score"].numpy(), np.asarray(j_stats["krum_score"]), rtol=1e-5
    )
    np.testing.assert_allclose(t_new.numpy(), np.asarray(j_new), rtol=1e-5)
    return t_stats


CASES = [
    # (n, offsets of the k-regular graph, poisoned rows)
    (16, [1, 2, 14, 15], [3, 7, 12]),
    (12, [1, 2, 10, 11], [0]),
    (10, [1, 9], []),
    (16, [1, 2, 3, 13, 14, 15], [1, 2, 5]),
]


@pytest.mark.parametrize("n,offsets,poisoned", CASES)
@pytest.mark.parametrize("c", [0, 1, 3])
@pytest.mark.parametrize("mode", ["dense", "circulant"])
def test_krum_matches_jax(n, offsets, poisoned, c, mode):
    own, bcast = _states(n, 257, poisoned, seed=n + c)
    adj = _circulant_adj(n, offsets)
    kw = {"num_compromised": c, "max_candidates": len(offsets) + 1}
    if mode == "circulant":
        kw["exchange_offsets"] = offsets
    stats = _compare(jax_make_krum(**kw), make_krum(**kw), own, bcast, adj)
    m = len(offsets) + 1
    if not c < (m - 2) / 2:
        # The Krum constraint fails at every node: all keep their own state.
        assert bool(stats["selected_own"].all())


@pytest.mark.parametrize("c", [0, 1, 2])
def test_dense_krum_fully_connected(c):
    n = 9
    own, bcast = _states(n, 300, [2, 6], seed=40 + c)
    adj = (np.ones((n, n)) - np.eye(n)).astype(np.float32)
    _compare(jax_make_krum(num_compromised=c), make_krum(num_compromised=c), own, bcast, adj)


def test_dense_krum_irregular_graph():
    # Erdős–Rényi-like adjacency: per-node candidate counts differ, so the
    # constraint and trim depth vary per node.
    rng = np.random.default_rng(5)
    n = 12
    upper = np.triu(rng.random((n, n)) < 0.4, 1)
    adj = (upper | upper.T).astype(np.float32)
    own, bcast = _states(n, 200, [4], seed=5)
    m = int(adj.sum(1).max()) + 1
    kw = {"num_compromised": 1, "max_candidates": m}
    _compare(jax_make_krum(**kw), make_krum(**kw), own, bcast, adj)


def test_krum_isolates_poisoned_rows():
    own, bcast = _states(16, 257, [3, 7, 12], seed=9)
    adj = _circulant_adj(16, [1, 2, 14, 15])
    agg = make_krum(num_compromised=1, max_candidates=5)
    _, _, stats = agg.aggregate(
        torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj),
        0.0, {}, AggContext(),
    )
    # No node adopts a poisoned broadcast (a poisoned node keeping its own
    # true state is fine).
    sel = stats["selected_index"].tolist()
    assert all(s == i for i, s in enumerate(sel) if s in (3, 7, 12))


def test_candidate_indices_match_jax():
    from murmura_tpu.aggregation.base import candidate_indices as jax_candidates

    adj = _circulant_adj(10, [1, 3])
    for m_cap in (3, 5, 10):
        ci, vi = candidate_indices(torch.from_numpy(adj), m_cap)
        jci, jvi = jax_candidates(jnp.asarray(adj), m_cap)
        assert np.array_equal(ci.numpy(), np.asarray(jci))
        assert np.array_equal(vi.numpy(), np.asarray(jvi))


@pytest.mark.parametrize("rule", ["fedavg", "median", "trimmed_mean", "ubar"])
def test_other_rules_refused_by_name(rule):
    # The sparse edge-mask exchange without its offsets is refused by name
    # instead of running another exchange.
    params = {"sparse_exchange": True}
    with pytest.raises(ValueError, match="sparse_exchange requires exchange_offsets"):
        build_aggregator(rule, params)


def test_krum_f_alias_is_num_compromised():
    # Reference configs (uci_har_byzantine.yaml) name the tolerance "f".
    own, bcast = _states(16, 257, [3, 7, 12], seed=9)
    adj = _circulant_adj(16, [1, 2, 14, 15])
    args = (torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj), 0.0, {},
            AggContext())
    _, _, by_f = build_aggregator("krum", {"f": 1, "max_candidates": 5}).aggregate(*args)
    _, _, by_c = make_krum(num_compromised=1, max_candidates=5).aggregate(*args)
    assert torch.equal(by_f["selected_index"], by_c["selected_index"])
    assert not bool(by_f["selected_own"].all())
    with pytest.raises(ValueError, match="aliases"):
        build_aggregator("krum", {"f": 1, "num_compromised": 2})
