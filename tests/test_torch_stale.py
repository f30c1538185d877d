"""Bounded-staleness gossip in the port against the JAX package, on the CPU.

- The fold (core/stale.py) against the JAX package's ``make_stale_fold`` on
  hand-made inputs, the cases of tests/test_staleness.py's TestFoldSemantics
  (discount serving, an age past the bound, the scrub gate, the round-0
  empty cache, a link-dropped edge of a delivering sender, a dead receiver)
  with the audit taps on: the served broadcast, the cache, the ages, which
  edges are re-added, the stale stats and taps bit-equal; the re-added
  weights ``discount ** age`` within rtol 1e-6 (XLA's float32 ``exp`` and
  torch's may differ by an ulp).
- Fractional weights reach the rules unchanged: the candidate order of
  ``adj + 2 I`` with fresh (1.0) and stale (0.7, 0.49) neighbours, ties
  between them included, is the JAX package's; Krum's picks on such an
  adjacency are equal, and fedavg's weighted mean within rtol 1e-5.
- Three chained stale rounds of the 16-32-4 MLP (8 nodes, k-regular(4),
  Krum c = 0) through both round programs from the same spread initial
  parameters, each round fed the JAX round's own shuffle, under allgather
  and ppermute, on a hand-made schedule: a straggler whose cache is warm, a
  straggler whose cache never filled, a NaN-injected (quarantined) sender
  with a warm cache, a dead receiver and a dropped link.  The ages, the
  stale stats and taps and Krum's picks equal, every round; the parameters
  and the cache within a scaled 1e-4 (max |port - jax| / max(1, max |jax|):
  each package trains its own rows, so the cached rows carry the same
  float32 noise as the parameters).  In the port the cache rows are
  bit-equal to what the fold served.
- Under ppermute the circulant Krum reads no adjacency, so a straggler's
  cache row (zero before its first delivery) enters its neighbours'
  candidate sets even when no edge is re-added, in both packages.
- A fused run of stale_gossip.yaml is bit-equal to per-round dispatch.
- Staleness without faults, and a base mask of the wrong shape, are
  refused with the JAX package's messages.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation.base import candidate_indices as jax_candidate_indices
from murmura_tpu.aggregation.fedavg import make_fedavg as jax_make_fedavg
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.core import stale as J
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.faults.schedule import FaultSpec as JaxSpec
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu_torch.aggregation.base import AggContext, candidate_indices
from murmura_tpu_torch.aggregation.fedavg import make_fedavg
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.core import stale as T
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
N = 8
SEED = 3
DATA = {"num_samples": 640, "input_dim": 16, "num_classes": 4}
HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)
OFFSETS = [1, 2, 6, 7]  # k-regular(4) on 8 nodes


def _ring(n=6):
    base = np.zeros((n, n), np.float32)
    for i in range(n):
        base[i, (i + 1) % n] = base[i, (i - 1) % n] = 1.0
    return base


def _scaled_delta(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# the fold on hand-made inputs


def _fold_case(name):
    """(spec kwargs, bcast, adj, cache, age, recv_ok, scrub_ok) of one case,
    on the 6-node ring with P = 3."""
    n, p = 6, 3
    base = _ring(n)
    adj = base.copy()
    bcast = np.arange(n * p, dtype=np.float32).reshape(n, p)
    cache = -np.ones((n, p), np.float32)
    age = np.zeros(n, np.float32)
    ones = np.ones(n, np.float32)
    recv, scrub = ones.copy(), ones.copy()
    spec = dict(max_staleness=2, discount=0.5)
    if name == "discount_serving":
        adj[:, 2] = 0.0
        age[4] = 1.0  # a second straggler, one round older: 0.25
        adj[:, 4] = 0.0
    elif name == "age_past_bound":
        spec["max_staleness"] = 1
        adj[:, 2] = 0.0
        age[2] = 1.0
    elif name == "scrub_gate":
        adj[:, 2] = 0.0
        scrub[2] = 0.0
        bcast[:] = 7.0
        cache[:] = -3.0
    elif name == "round0_empty_cache":
        adj[:, 4] = 0.0
        cache[:] = 0.0
        age[:] = spec["max_staleness"] + 1
    elif name == "link_dropped_delivering_sender":
        adj[0, 1] = 0.0
    elif name == "dead_receiver":
        adj[:, 2] = 0.0
        adj[1, :] = 0.0
        recv[1] = 0.0
    return spec, base, bcast, adj, cache, age, recv, scrub


FOLD_CASES = ["discount_serving", "age_past_bound", "scrub_gate", "round0_empty_cache",
              "link_dropped_delivering_sender", "dead_receiver"]


@pytest.mark.parametrize("discount", [0.5, 0.7, 1.0])
@pytest.mark.parametrize("name", FOLD_CASES)
def test_fold_matches_jax(name, discount):
    spec_kw, base, bcast, adj, cache, age, recv, scrub = _fold_case(name)
    spec_kw["discount"] = discount
    jspec = J.StalenessSpec(base_mask=base, **spec_kw)
    tspec = T.StalenessSpec(base_mask=base, **spec_kw)
    assert tspec.age_cap == jspec.age_cap
    jf = J.make_stale_fold(jspec, audit=True)
    tf = T.make_stale_fold(tspec, audit=True)
    jb, ja, ju, js = jf(jnp.asarray(bcast), jnp.asarray(adj),
                        {J.CACHE_KEY: jnp.asarray(cache), J.AGE_KEY: jnp.asarray(age)},
                        jnp.asarray(recv), jnp.asarray(scrub))
    tb, ta, tu, ts = tf(torch.from_numpy(bcast), torch.from_numpy(adj),
                        {T.CACHE_KEY: torch.from_numpy(cache), T.AGE_KEY: torch.from_numpy(age)},
                        torch.from_numpy(recv), torch.from_numpy(scrub))
    assert T.STALE_STATE_KEYS == J.STALE_STATE_KEYS
    # Bit-equal: the served rows, the cache, the ages, which edges exist.
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for k in T.STALE_STATE_KEYS:
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)
    np.testing.assert_array_equal(ta.numpy() > 0, np.asarray(ja) > 0)
    np.testing.assert_array_equal(ta.numpy()[adj > 0], np.asarray(ja)[adj > 0])
    # The re-added weights: discount ** age through each package's float32 exp.
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)
    assert set(ts) == set(js) == {"stale_used", "stale_expired", "tap_stale_used",
                                  "tap_stale_age"}
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)


def test_fold_semantics_on_the_cases():
    """The port's fold does what each case is about (not only what JAX does)."""
    def run(name):
        spec_kw, base, bcast, adj, cache, age, recv, scrub = _fold_case(name)
        fold = T.make_stale_fold(T.StalenessSpec(base_mask=base, **spec_kw), audit=True)
        out = fold(torch.from_numpy(bcast), torch.from_numpy(adj),
                   {T.CACHE_KEY: torch.from_numpy(cache), T.AGE_KEY: torch.from_numpy(age)},
                   torch.from_numpy(recv), torch.from_numpy(scrub))
        return (base, cache) + tuple(out)

    base, cache, b, a, u, s = run("discount_serving")
    assert torch.equal(b[2], torch.from_numpy(cache[2]))
    assert torch.allclose(a[:, 2][base[:, 2] > 0], torch.tensor(0.5))
    assert torch.allclose(a[:, 4][base[:, 4] > 0], torch.tensor(0.25))
    assert u[T.AGE_KEY].tolist() == [0, 0, 1, 0, 2, 0]
    assert float(s["stale_used"]) == 4.0 and float(s["stale_expired"]) == 0.0
    _, _, _, a, u, s = run("age_past_bound")
    assert float(a[:, 2].sum()) == 0.0 and float(u[T.AGE_KEY][2]) == 2.0
    _, cache, _, a, u, s = run("scrub_gate")
    assert float(a[:, 2].sum()) == 0.0 and torch.equal(u[T.CACHE_KEY][2], torch.full((3,), -3.0))
    assert float(s["stale_expired"]) == 0.0
    _, _, _, a, _, s = run("round0_empty_cache")
    assert float(a[:, 4].sum()) == 0.0 and float(s["stale_used"]) == 0.0
    _, _, _, a, _, s = run("link_dropped_delivering_sender")
    assert float(a[0, 1]) == 0.0 and float(s["stale_used"]) == 0.0
    _, _, _, a, _, _ = run("dead_receiver")
    assert float(a[1].sum()) == 0.0


# ---------------------------------------------------------------------------
# fractional weights reach the rules unchanged


def _fractional_adj():
    """k-regular(4) on 8 nodes with stale re-added edges: 0.7 and 0.49
    beside fresh 1.0 edges, in every order around the node index."""
    adj = jax_topology("k-regular", N, k=4).mask().astype(np.float32)
    for (i, j), w in {(0, 1): 0.7, (0, 6): 0.49, (3, 4): 0.7, (3, 5): 0.7, (5, 3): 0.49,
                      (7, 0): 0.7, (7, 6): 0.49}.items():
        adj[i, j] = w
    return adj


def test_candidate_order_with_fractional_weights_is_the_jax_packages():
    adj = _fractional_adj()
    for m_cap in (3, 4, 5, N):
        ci, valid = candidate_indices(torch.from_numpy(adj), m_cap)
        jci, jvalid = jax_candidate_indices(jnp.asarray(adj), m_cap)
        np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # Fresh neighbours rank before stale ones, ties by index.
    ci, _ = candidate_indices(torch.from_numpy(adj), 5)
    assert ci[0].tolist() == [0, 2, 7, 1, 6]
    assert ci[3].tolist() == [3, 1, 2, 4, 5]


def _spread_rows(seed, n=N, p=301):
    rng = np.random.default_rng(seed)
    spread = 0.2 * (1.0 + np.arange(n) / n)
    own = (rng.normal(size=(1, p)) + spread[:, None] * rng.normal(size=(n, p))).astype(
        np.float32)
    bcast = own.copy()
    bcast[[2, 5]] += (10.0 * rng.normal(size=(2, p))).astype(np.float32)
    return own, bcast


@pytest.mark.parametrize("c,m_cap", [(0, None), (1, None), (0, 3), (1, 5)])
def test_krum_and_fedavg_on_fractional_weights_match_jax(c, m_cap):
    own, bcast = _spread_rows(c + 10 * (m_cap or 0))
    adj = _fractional_adj()
    kw = {"num_compromised": c, "max_candidates": m_cap}
    args = (jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
            jnp.asarray(0.0, jnp.float32), {}, JaxCtx(audit=True))
    _, _, js = jax_make_krum(**kw).aggregate(*args)
    tn, _, ts = make_krum(**kw).aggregate(torch.from_numpy(own), torch.from_numpy(bcast),
                                          torch.from_numpy(adj), 0.0, {}, AggContext(audit=True))
    for k in ("selected_index", "selected_own", "tap_selected_by", "tap_considered_by"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    jn, _, js = jax_make_fedavg().aggregate(*args)
    tn, _, ts = make_fedavg().aggregate(torch.from_numpy(own), torch.from_numpy(bcast),
                                        torch.from_numpy(adj), 0.0, {}, AggContext())
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# three chained stale rounds through both round programs

NAN_NODE, WARM, COLD, DEAD = 2, 3, 1, 5


def _schedule(r):
    """Round r's (adjacency, alive): k-regular(4); node DEAD dead; node
    COLD straggles in rounds 0-1 (its cache never fills, then it delivers
    in round 2); node WARM delivers in round 0 and straggles after (age 1,
    then 2); node NAN_NODE diverges from round 1 (quarantined with a warm
    cache); the link 0-7 drops in round 2."""
    adj = jax_topology("k-regular", N, k=4).mask().astype(np.float32)
    alive = np.ones(N, np.float32)
    alive[DEAD] = 0.0
    adj = adj * alive[:, None] * alive[None, :]
    if r < 2:
        adj[:, COLD] = 0.0
    if r >= 1:
        adj[:, WARM] = 0.0
    if r == 2:
        adj[0, 7] = adj[7, 0] = 0.0
    return adj, alive


@pytest.fixture(scope="module", params=["allgather", "ppermute"])
def stale_rounds(request):
    """Three rounds of each package: per round, (jax flat, state, metrics)
    and (port flat, state, metrics, the port's cache before the round)."""
    circulant = request.param == "ppermute"
    kw = {"exchange_offsets": OFFSETS} if circulant else {}
    data = jax_data("synthetic", DATA, num_nodes=N, seed=SEED)
    base = jax_topology("k-regular", N, k=4).mask().astype(np.float32)
    spec = dict(nan_quarantine=True, nan_inject_nodes=(NAN_NODE,), nan_inject_from_round=1)
    stale = dict(max_staleness=2, discount=0.7, base_mask=base)
    jprog = jax_build_round(jax_mlp(16, [32], 4), jax_make_krum(**kw), data,
                            faults=JaxSpec(**spec), audit_taps=True,
                            staleness=J.StalenessSpec(**stale), **HP)
    rng = np.random.default_rng(SEED)
    scale = 0.05 * (1.0 + np.arange(N) / N)
    init = jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((N,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)
    prog = build_round_program(make_mlp(16, [32], 4), make_krum(**kw), data,
                               faults=FaultSpec(**spec), init_params=init, audit_taps=True,
                               staleness=T.StalenessSpec(**stale), device="cpu", **HP)
    assert set(prog.init_agg_state) == set(T.STALE_STATE_KEYS)
    step = jax.jit(jprog.train_step)
    j_params = jax.tree_util.tree_map(jnp.asarray, init)
    j_state = jprog.init_agg_state
    t_flat, t_state = prog.init_flat, prog.init_agg_state
    comp = np.zeros(N, np.float32)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    jax_rounds, port_rounds = [], []
    for r in range(3):
        adj, alive = _schedule(r)
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), r)
        j_params, j_state, j_metrics = step(
            j_params, j_state, key, jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(alive),
            jnp.asarray(float(r), jnp.float32), d)
        train_key, _ = jax.random.split(key)
        perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
        u = np.array(jax.random.uniform(perm_key, data.mask.shape))
        prev_cache = t_state[T.CACHE_KEY].clone()
        t_flat, t_state, t_metrics = prog.train_step(
            t_flat, t_state, torch.from_numpy(adj), torch.from_numpy(comp), float(r),
            draws={"u": [u]}, alive=torch.from_numpy(alive))
        jax_rounds.append((np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params)),
                           {k: np.asarray(v) for k, v in j_state.items()},
                           {k: np.asarray(v) for k, v in j_metrics.items()}))
        port_rounds.append((t_flat.clone(), {k: v.clone() for k, v in t_state.items()},
                            t_metrics, prev_cache))
    return request.param, jax_rounds, port_rounds


def test_stale_rounds_match_jax(stale_rounds):
    exchange, jax_rounds, port_rounds = stale_rounds
    for r, ((j_flat, j_state, j_m), (t_flat, t_state, t_m, _)) in enumerate(
            zip(jax_rounds, port_rounds)):
        assert set(t_m) == set(j_m), r
        for k in ("agg_stale_used", "agg_stale_expired", "agg_tap_stale_used",
                  "agg_tap_stale_age", "agg_alive", "agg_tap_alive", "agg_quarantined",
                  "agg_tap_quarantined", "agg_selected_index", "agg_selected_own",
                  "agg_tap_selected_by", "agg_tap_considered_by"):
            np.testing.assert_array_equal(t_m[k].numpy(), j_m[k], err_msg=f"{k} round {r}")
        np.testing.assert_array_equal(t_state[T.AGE_KEY].numpy(), j_state[J.AGE_KEY])
        assert _scaled_delta(t_state[T.CACHE_KEY].numpy(), j_state[J.CACHE_KEY]) <= 1e-4
        assert np.isfinite(j_flat).all() and bool(torch.isfinite(t_flat).all())
        assert _scaled_delta(t_flat.numpy(), j_flat) <= 1e-4, r
    # The schedule did what it is meant to: round 0 serves nothing (cold
    # caches), round 1 serves WARM at age 1, round 2 at age 2; COLD and
    # the dead node never delivered, so their edges count as expired: four
    # receivers each in round 0, and in round 1 one fewer, NAN_NODE being
    # one of COLD's receivers and quarantined; NAN_NODE is withheld, not
    # expired.
    ages = [m["agg_tap_stale_age"].tolist() for _, _, m, _ in port_rounds]
    assert ages[0] == [0.0] * N
    assert ages[1][WARM] == 1.0 and ages[2][WARM] == 2.0
    assert ages[1][NAN_NODE] == ages[2][NAN_NODE] == 0.0
    assert [float(m["agg_stale_expired"]) for _, _, m, _ in port_rounds][:2] == [8.0, 7.0]


def test_cache_holds_exactly_what_was_served(stale_rounds):
    _, _, port_rounds = stale_rounds
    for r, (_, state, m, prev_cache) in enumerate(port_rounds):
        cache, age = state[T.CACHE_KEY], state[T.AGE_KEY]
        for i in range(N):
            if age[i] > 0:  # did not deliver: the row is the previous cache's
                assert torch.equal(cache[i], prev_cache[i]), (r, i)
            else:
                assert not torch.equal(cache[i], prev_cache[i]), (r, i)


def test_cold_cache_under_ppermute_enters_circulant_krum(stale_rounds):
    """Round 0 under ppermute: COLD did not deliver and its cache is the
    zero row; the circulant rule reads no adjacency, so COLD's neighbours
    rank that zero row among their candidates (the JAX package does the
    same, test_stale_rounds_match_jax).  Under allgather its edges are
    dropped and nobody can pick it."""
    exchange, _, port_rounds = stale_rounds
    _, state, m, prev_cache = port_rounds[0]
    assert not prev_cache[COLD].any() and not state[T.CACHE_KEY][COLD].any()
    picked = m["agg_tap_selected_by"][COLD]
    considered = m["agg_tap_considered_by"][COLD]
    if exchange == "ppermute":
        assert float(considered) == len(OFFSETS)
    else:
        assert float(considered) == 0.0 and float(picked) == 0.0


# ---------------------------------------------------------------------------
# fused dispatch, refusals


def test_fused_stale_run_is_bit_equal_to_per_round():
    def network():
        config = load_config(ROOT / "examples" / "configs" / "stale_gossip.yaml")
        config.experiment.verbose = False
        config.telemetry.enabled = False
        config.telemetry.audit_taps = False
        return build_network_from_config(config, device="cpu")

    a, b = network(), network()
    ha = a.train(5)
    hb = b.train(5, rounds_per_dispatch=2)
    assert ha == hb and ha["agg_stale_used"][2:] != [0.0] * 3
    assert torch.equal(a.flat, b.flat)
    for k in a.agg_state:
        assert torch.equal(a.agg_state[k], b.agg_state[k]), k


def test_staleness_refusals_are_the_jax_packages():
    data = jax_data("synthetic", DATA, num_nodes=N, seed=SEED)
    base = jax_topology("k-regular", N, k=4).mask()
    cases = [
        (dict(staleness=(base, 2)), "requires the fault model"),
        (dict(staleness=(np.zeros((N - 1, N - 1), np.float32), 2), faults=True),
         "does not match this build's exchange layout"),
    ]
    for kw, match in cases:
        mask, bound = kw["staleness"]
        faults = kw.get("faults")
        with pytest.raises(ValueError, match=match) as got:
            build_round_program(make_mlp(16, [32], 4), make_krum(), data, device="cpu",
                                faults=FaultSpec() if faults else None,
                                staleness=T.StalenessSpec(bound, base_mask=mask), **HP)
        with pytest.raises(ValueError, match=match) as ref:
            jax_build_round(jax_mlp(16, [32], 4), jax_make_krum(), data,
                            faults=JaxSpec() if faults else None,
                            staleness=J.StalenessSpec(bound, base_mask=mask), **HP)
        assert str(got.value) == str(ref.value)
    for bad in (dict(max_staleness=0), dict(max_staleness=1, discount=0.0)):
        with pytest.raises(ValueError) as got:
            T.StalenessSpec(**bad)
        with pytest.raises(ValueError) as ref:
            J.StalenessSpec(**bad)
        assert str(got.value) == str(ref.value)
