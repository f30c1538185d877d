"""The sparse [k, N] edge-mask exchange of the PyTorch port against the JAX
package's (topology/sparse.py, the rules' sparse branches, the stale fold's
and the pipeline's sparse modes, the sparse round), on 16 nodes and the
exponential offsets (1, 2, 4, 8).

- ``exponential_offsets``, ``SparseTopology`` (its edge masks, sender
  in-degrees, dense views) and their refusals equal the JAX package's;
- every rule's sparse branch against the JAX rule on the same own, bcast
  and [k, N] mask, two chained rounds, with audit taps: an all-ones mask, a
  faulted one (random drops, a node with no live in-edge) and a one_peer
  round.  The tolerances of the rules' dense and circulant tests: outputs
  within rtol/atol 1e-5, the decisions (Krum's picks, acceptances,
  candidate counts, trim depths, stage rates) and the audit taps equal,
  other stats within rtol 1e-5 (evidential trust's threshold rtol 1e-6, its
  carried trust rtol 1e-5, as in tests/test_torch_evidential_trust.py);
- an all-ones mask reproduces the port's static circulant path bit for
  bit, except two rules.  Sketchguard's static path filters on the [N, N]
  pairwise sketch distances (the Gram identity) and its sparse path on the
  circulant ones (direct sums): equal acceptances, outputs within rtol/atol
  1e-6.  The trimmed mean's static path is the candidate kernel's plain
  version, which multiplies the kept sum by the reciprocal of its count,
  and its sparse path divides by the count, as the JAX package's sparse
  branch does: outputs within one float32 ulp (rtol 2^-23; measured 1.19e-7
  at most, on a third of the elements);
- the stale fold's sparse mode bit-equal to the JAX fold (the re-added
  weights ``discount ** age`` within rtol 1e-6, one float32 ``exp`` each);
- the pipeline's ``[N, k]`` buffer equal to the JAX package's, a pipelined
  sparse network bit-equal to the delayed recursion, and three chained
  pipelined sparse rounds against the JAX program on the same draws
  (scaled 1e-4, picks equal);
- one faulted sparse round (a dead node, a NaN node, an attacker
  overflowing to inf) against the JAX round on the same draws: parameters
  within a scaled 1e-4, the fault stats and picks equal;
- every rule through ``build_network_from_config`` on ``exponential`` and
  ``one_peer``, a telemetry run's in-degrees from the edge masks, and the
  refusals (a sparse program on a dense topology, other offsets,
  ``one_peer`` with staleness).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.attacks.ipm import make_ipm_attack as jax_ipm
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.core import pipeline as JP
from murmura_tpu.core import stale as JS
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.faults.schedule import FaultSpec as JaxFaultSpec
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.topology import sparse as JT
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.attacks.ipm import make_ipm_attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core import pipeline as P
from murmura_tpu_torch.core import stale as TS
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops.flatten import make_flatteners, tree_to_torch
from murmura_tpu_torch.telemetry.writer import events_of_type
from murmura_tpu_torch.topology import sparse as TT
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils.factories import build_network_from_config

N = 16
OFFSETS = (1, 2, 4, 8)
K = len(OFFSETS)
B = 10
IN_DIM, HIDDEN, CLASSES = 12, (16,), 4
POISONED = [3, 11]
TOTAL_ROUNDS = 10


def _scaled_delta(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# topology/sparse.py


@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 17, 64, 100, 256, 1000])
@pytest.mark.parametrize("horizon", [None, 3, 12])
def test_exponential_offsets_match_jax(n, horizon):
    try:
        ref = JT.exponential_offsets(n, horizon)
    except ValueError as e:
        with pytest.raises(ValueError, match="self-loop"):
            TT.exponential_offsets(n, horizon)
        assert "self-loop" in str(e)
        return
    assert TT.exponential_offsets(n, horizon) == ref


def test_exponential_offsets_refusals():
    with pytest.raises(ValueError, match="num_nodes >= 2"):
        TT.exponential_offsets(1)
    # 2^4 mod 16 == 0: a self-loop offset.
    with pytest.raises(ValueError, match="self-loop"):
        TT.exponential_offsets(16, horizon=5)
    # Past log2(n) at n = 12, 2^i mod 12 revisits 4 and 8: deduped.
    assert TT.exponential_offsets(12, horizon=6) == JT.exponential_offsets(12, horizon=6)


@pytest.mark.parametrize("kind", ["exponential", "one_peer"])
@pytest.mark.parametrize("n", [5, 16, 64])
def test_sparse_topology_views_match_jax(kind, n):
    ref, got = jax_topology(kind, n), create_topology(kind, n)
    assert isinstance(got, TT.SparseTopology)
    assert got.offsets == ref.offsets and got.schedule == ref.schedule
    assert got.degree == ref.degree and got.is_connected() == ref.is_connected()
    assert got.circulant_offsets() == ref.circulant_offsets()
    assert got.neighbors == ref.neighbors
    assert np.array_equal(got.adjacency, ref.adjacency)
    assert np.array_equal(got.mask(), ref.mask())
    rng = np.random.default_rng(n)
    for r in range(2 * got.degree + 1):
        assert np.array_equal(got.edge_mask(r), ref.edge_mask(r)), r
        mask = got.edge_mask(r) * (rng.random((got.degree, n)) < 0.7)
        assert np.array_equal(got.in_degree_from_edge_mask(mask),
                              ref.in_degree_from_edge_mask(mask))


@pytest.mark.parametrize("kwargs, match", [
    ({"num_nodes": 1, "offsets": (1,)}, "num_nodes >= 2"),
    ({"num_nodes": 8, "offsets": (1, 8)}, "zero"),
    ({"num_nodes": 8, "offsets": (1, 9)}, "collide"),
    ({"num_nodes": 8, "offsets": ()}, "at least one offset"),
    ({"num_nodes": 8, "offsets": (1,), "schedule": "random"}, "schedule"),
])
def test_sparse_topology_refusals_are_the_jax_packages(kwargs, match):
    with pytest.raises(ValueError, match=match) as ref:
        JT.SparseTopology(**kwargs)
    with pytest.raises(ValueError, match=match) as got:
        TT.SparseTopology(**kwargs)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the rules' sparse branches


def _masks():
    rng = np.random.default_rng(4)
    faulted = (rng.random((K, N)) < 0.75).astype(np.float32)
    faulted[:, 5] = 0.0  # node 5 receives from nobody this round
    faulted[:, 9] = 0.0
    faulted[2, 9] = 1.0  # node 9 from one neighbour only
    return {
        "all_ones": np.ones((K, N), np.float32),
        "faulted": faulted,
        "one_peer": JT.SparseTopology(N, OFFSETS, "one_peer").edge_mask(1),
    }


MASKS = _masks()


def _setup(evidential):
    """(jax ctx, port ctx, own, bcast): MLP states spread around one model,
    two rows broadcasting noise of std 10, per-node probe batches."""
    jmodel = jax_mlp(IN_DIM, HIDDEN, CLASSES, evidential=evidential)
    template = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    flat0, j_unravel = ravel_pytree(template)
    model = make_mlp(IN_DIM, HIDDEN, CLASSES, evidential=evidential)
    rng = np.random.default_rng(6)
    spread = 0.2 * (1.0 + np.arange(N) / N)
    own = (np.asarray(flat0)[None] + spread[:, None] * rng.normal(size=(N, flat0.size)))
    own = own.astype(np.float32)
    bcast = own.copy()
    bcast[POISONED] += (10.0 * rng.normal(size=(len(POISONED), flat0.size))).astype(np.float32)
    px = rng.normal(size=(N, B, IN_DIM)).astype(np.float32)
    py = rng.integers(0, CLASSES, size=(N, B)).astype(np.int32)
    pm = (rng.random((N, B)) < 0.9).astype(np.float32)
    jctx = JaxCtx(apply_fn=jmodel.apply, unravel=j_unravel, probe_x=jnp.asarray(px),
                  probe_y=jnp.asarray(py), probe_mask=jnp.asarray(pm), evidential=evidential,
                  num_classes=CLASSES, total_rounds=TOTAL_ROUNDS, audit=True)
    _, t_unravel, _ = make_flatteners(tree_to_torch(template))
    tctx = AggContext(apply_fn=model.apply, unravel=t_unravel,
                      probe_x=torch.from_numpy(px), probe_y=torch.from_numpy(py).long(),
                      probe_mask=torch.from_numpy(pm), evidential=evidential,
                      num_classes=CLASSES, total_rounds=TOTAL_ROUNDS, audit=True)
    return jctx, tctx, own, bcast


RULE_PARAMS = {
    "krum": {"num_compromised": 1},
    "fedavg": {},
    "median": {},
    "trimmed_mean": {"trim_ratio": 0.2},
    "geometric_median": {},
    "balance": {},
    "sketchguard": {"sketch_size": 64},
    "ubar": {"rho": 0.8},
    "evidential_trust": {"trust_threshold": 0.5},
}
EXACT = {"num_neighbors", "num_candidates", "trimmed_per_side", "selected_index",
         "selected_own", "compression_ratio", "stage1_acceptance_rate",
         "stage2_acceptance_rate", "tap_selected_by", "tap_considered_by"}


def _rule_kwargs(rule, p, sparse=True):
    kw = dict(RULE_PARAMS[rule], exchange_offsets=list(OFFSETS), sparse_exchange=sparse)
    if rule == "sketchguard":
        kw["model_dim"] = p
    return kw


def _run_rule(rule, mask_name, rounds=2):
    jctx, tctx, own, bcast = _setup(evidential=rule == "evidential_trust")
    kw = _rule_kwargs(rule, own.shape[1])
    jr, tr = JAX_AGGREGATORS[rule](**kw), AGGREGATORS[rule](**kw)
    mask = MASKS[mask_name]
    j_state = {k: jnp.asarray(v) for k, v in jr.init_state(N).items()}
    t_state = {k: torch.as_tensor(v) for k, v in tr.init_state(N).items()}
    out = []
    for r in range(rounds):
        j_new, j_state, j_stats = jr.aggregate(
            jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(mask),
            jnp.asarray(float(r), jnp.float32), j_state, jctx)
        t_new, t_state, t_stats = tr.aggregate(
            torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(mask),
            float(r), t_state, tctx)
        out.append((np.asarray(j_new), {k: np.asarray(v) for k, v in j_stats.items()},
                    {k: np.asarray(v) for k, v in j_state.items()},
                    t_new.numpy(), {k: v.numpy() for k, v in t_stats.items()},
                    {k: v.numpy() for k, v in t_state.items()}))
    return out


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("rule", sorted(RULE_PARAMS))
def test_sparse_rule_matches_jax(rule, mask_name):
    for r, (j_new, j_stats, j_state, t_new, t_stats, t_state) in enumerate(
            _run_rule(rule, mask_name)):
        assert t_new.dtype == j_new.dtype
        np.testing.assert_allclose(t_new, j_new, rtol=1e-5, atol=1e-5, err_msg=f"round {r}")
        assert set(t_stats) == set(j_stats)
        for k in j_stats:
            if k in EXACT or (k == "acceptance_rate" and rule != "evidential_trust"):
                assert np.array_equal(t_stats[k], j_stats[k]), (r, k)
            elif k == "threshold" and rule == "evidential_trust":
                np.testing.assert_allclose(t_stats[k], j_stats[k], rtol=1e-6, err_msg=k)
            else:
                np.testing.assert_allclose(t_stats[k], j_stats[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"round {r}: {k}")
        if rule == "evidential_trust":
            deg = np.maximum(MASKS[mask_name].sum(axis=0), 1.0)
            assert np.array_equal(np.rint(t_stats["acceptance_rate"] * deg),
                                  np.rint(j_stats["acceptance_rate"] * deg))
        assert set(t_state) == set(j_state)
        for k in j_state:
            if k == "smoothed_trust":
                np.testing.assert_allclose(t_state[k], j_state[k], rtol=1e-5, atol=1e-7)
            else:
                assert np.array_equal(t_state[k], j_state[k]), (r, k)


def test_sparse_krum_decides_per_node():
    # The masks make the decision per node: a node with one live neighbour
    # (m = 2) fails c < (m - 2) / 2 and keeps its own state, an all-ones
    # node (m = 5) picks; under one_peer every node keeps its own.
    (_, _, _, _, faulted, _), = _run_rule("krum", "faulted", rounds=1)
    assert faulted["selected_own"][5] == 1.0 and faulted["selected_own"][9] == 1.0
    (_, _, _, _, ones, _), = _run_rule("krum", "all_ones", rounds=1)
    assert ones["selected_own"].min() == 0.0
    (_, _, _, _, peer, _), = _run_rule("krum", "one_peer", rounds=1)
    assert peer["selected_own"].min() == 1.0


@pytest.mark.parametrize("rule", sorted(RULE_PARAMS))
def test_all_ones_mask_is_the_static_circulant_path(rule):
    _, tctx, own, bcast = _setup(evidential=rule == "evidential_trust")
    args = (torch.from_numpy(own), torch.from_numpy(bcast))
    sparse = AGGREGATORS[rule](**_rule_kwargs(rule, own.shape[1]))
    static = AGGREGATORS[rule](**_rule_kwargs(rule, own.shape[1], sparse=False))
    dense_adj = torch.from_numpy(create_topology("exponential", N).mask())
    s_state = {k: torch.as_tensor(v) for k, v in sparse.init_state(N).items()}
    c_state = {k: torch.as_tensor(v) for k, v in static.init_state(N).items()}
    for r in range(2):
        s_new, s_state, s_stats = sparse.aggregate(
            *args, torch.ones((K, N)), float(r), s_state, tctx)
        c_new, c_state, c_stats = static.aggregate(*args, dense_adj, float(r), c_state, tctx)
        assert set(s_stats) == set(c_stats)
        if rule == "sketchguard":
            np.testing.assert_allclose(s_new.numpy(), c_new.numpy(), rtol=1e-6, atol=1e-6)
            assert torch.equal(s_stats["acceptance_rate"], c_stats["acceptance_rate"])
            continue
        if rule == "trimmed_mean":
            np.testing.assert_allclose(s_new.numpy(), c_new.numpy(), rtol=2.0 ** -23, atol=0)
        else:
            assert torch.equal(s_new, c_new), r
        for k in s_stats:
            assert torch.equal(s_stats[k].to(torch.float32), c_stats[k].to(torch.float32)), k
        for k in s_state:
            assert torch.equal(s_state[k], c_state[k]), k


def test_sparse_exchange_needs_offsets():
    for rule in sorted(RULE_PARAMS):
        kw = {"sparse_exchange": True}
        if rule == "sketchguard":
            kw["model_dim"] = 10
        with pytest.raises(ValueError, match="requires exchange_offsets"):
            AGGREGATORS[rule](**kw)


# ---------------------------------------------------------------------------
# the stale fold's sparse mode


def _drop_sender(mask, s, n=8, offsets=(1, 2, 4)):
    """Zero every edge whose sender is ``s``."""
    for j, o in enumerate(offsets):
        mask[j, (s - o) % n] = 0.0


def _sparse_fold_case(name):
    n, p, offsets = 8, 3, (1, 2, 4)
    base = np.ones((len(offsets), n), np.float32)
    adj = base.copy()
    bcast = np.arange(n * p, dtype=np.float32).reshape(n, p)
    cache = -np.ones((n, p), np.float32)
    age = np.zeros(n, np.float32)
    recv, scrub = np.ones(n, np.float32), np.ones(n, np.float32)
    spec = dict(max_staleness=2, discount=0.5)
    if name == "discount_serving":
        _drop_sender(adj, 2)
        _drop_sender(adj, 5)
        age[5] = 1.0
    elif name == "age_past_bound":
        spec["max_staleness"] = 1
        _drop_sender(adj, 2)
        age[2] = 1.0
    elif name == "scrub_gate":
        _drop_sender(adj, 2)
        scrub[2] = 0.0
    elif name == "round0_empty_cache":
        _drop_sender(adj, 4)
        cache[:] = 0.0
        age[:] = spec["max_staleness"] + 1
    elif name == "link_dropped_delivering_sender":
        adj[1, 0] = 0.0
    elif name == "dead_receiver":
        _drop_sender(adj, 2)
        adj[:, 1] = 0.0
        recv[1] = 0.0
    return spec, offsets, base, bcast, adj, cache, age, recv, scrub


@pytest.mark.parametrize("discount", [0.5, 1.0])
@pytest.mark.parametrize("name", ["discount_serving", "age_past_bound", "scrub_gate",
                                  "round0_empty_cache", "link_dropped_delivering_sender",
                                  "dead_receiver"])
def test_sparse_fold_matches_jax(name, discount):
    spec_kw, offsets, base, bcast, adj, cache, age, recv, scrub = _sparse_fold_case(name)
    spec_kw["discount"] = discount
    jf = JS.make_stale_fold(JS.StalenessSpec(base_mask=base, **spec_kw),
                            sparse_offsets=offsets, audit=True)
    tf = TS.make_stale_fold(TS.StalenessSpec(base_mask=base, **spec_kw),
                            sparse_offsets=offsets, audit=True)
    jb, ja, ju, js = jf(jnp.asarray(bcast), jnp.asarray(adj),
                        {JS.CACHE_KEY: jnp.asarray(cache), JS.AGE_KEY: jnp.asarray(age)},
                        jnp.asarray(recv), jnp.asarray(scrub))
    tb, ta, tu, ts = tf(torch.from_numpy(bcast), torch.from_numpy(adj),
                        {TS.CACHE_KEY: torch.from_numpy(cache), TS.AGE_KEY: torch.from_numpy(age)},
                        torch.from_numpy(recv), torch.from_numpy(scrub))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for k in TS.STALE_STATE_KEYS:
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)
    assert ta.shape == (len(offsets), 8)
    np.testing.assert_array_equal(ta.numpy() > 0, np.asarray(ja) > 0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)


def test_sparse_fold_refuses_a_dense_base():
    spec = TS.StalenessSpec(max_staleness=2, base_mask=np.ones((8, 8), np.float32))
    with pytest.raises(ValueError, match=r"\[k, N\]"):
        TS.make_stale_fold(spec, sparse_offsets=(1, 2, 4))


# ---------------------------------------------------------------------------
# the pipeline's [N, k] buffer and the sparse rounds

HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=3)
DATA = {"num_samples": 320, "input_dim": 16, "num_classes": 4}


@pytest.mark.parametrize("stale", [False, True])
def test_sparse_pipeline_state_equals_jax(stale):
    ref = JP.init_pipeline_state(6, 10, jnp.float32, sparse_offsets=(1, 2, 4), stale=stale)
    got = P.init_pipeline_state(6, 10, torch.float32, sparse_offsets=(1, 2, 4), stale=stale)
    assert set(got) == set(ref)
    assert tuple(got[P.ADJ_KEY].shape) == (6, 3)
    for k in ref:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k


def _raw(**over):
    raw = {
        "experiment": {"name": "sparse", "seed": 3, "rounds": 6},
        "topology": {"type": "exponential", "num_nodes": 8},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic", "params": dict(DATA)},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "hidden_dims": [16], "num_classes": 4}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.25,
                   "params": {"noise_std": 5.0}},
        "backend": "simulation",
    }
    raw.update(over)
    return raw


def _net(**over):
    return build_network_from_config(Config.model_validate(_raw(**over)), device="cpu")


FAULTS = {"enabled": True, "straggler_prob": 0.3, "link_drop_prob": 0.2, "seed": 11}
PIPE_CASES = {
    "exponential": {},
    "one_peer": {"topology": {"type": "one_peer", "num_nodes": 8}},
    "faulted_stale": {"faults": FAULTS, "exchange": {"max_staleness": 2}},
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_sparse_pipelined_equals_delayed_reference(case):
    over = PIPE_CASES[case]
    net = _net(**{**over, "exchange": {**over.get("exchange", {}), "pipeline": True}})
    assert net.program.sparse and net.program.pipelined
    history = net.train(5)
    ref_flat, ref_history = P.run_delayed_reference(_net(**over), 5)
    assert torch.equal(net.flat, ref_flat)
    assert history["mean_accuracy"] == ref_history["mean_accuracy"]
    assert history["agg_pipe_valid"] == [0.0] + [1.0] * 4


def _spread(jprog, n, seed):
    rng = np.random.default_rng(seed)
    scale = 0.05 * (1.0 + np.arange(n) / n)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((n,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)


def _jax_draws(key, data, comp, model_dim):
    """The JAX round's draws (its core/rounds.py key splits)."""
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))
    noise = np.array(jax.random.normal(attack_key, (int(comp.sum()), model_dim)))
    return {"u": [u], "noise": noise}


@pytest.mark.parametrize("kind", ["exponential", "one_peer"])
def test_chained_pipelined_sparse_rounds_match_jax(kind):
    n, offsets = 8, (1, 2, 4)
    kw = {"num_compromised": 0, "exchange_offsets": list(offsets), "sparse_exchange": True}
    data = jax_data("synthetic", DATA, num_nodes=n, seed=3)
    jattack = jax_gaussian(n, 0.25, noise_std=10.0, seed=3)
    jprog = jax_build_round(jax_mlp(16, [16], 4), jax_make_krum(**kw), data, attack=jattack,
                            pipeline=True, sparse_offsets=offsets, **HP)
    init = _spread(jprog, n, 3)
    prog = build_round_program(make_mlp(16, [16], 4), make_krum(**kw), data,
                               attack=make_gaussian_attack(n, 0.25, noise_std=10.0, seed=3),
                               init_params=init, pipeline=True, sparse_offsets=offsets,
                               device="cpu", **HP)
    topo = TT.SparseTopology(n, offsets, "one_peer" if kind == "one_peer" else "static")
    step = jax.jit(jprog.train_step)
    j_params, j_state = jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state
    t_flat, t_state = prog.init_flat, prog.init_agg_state
    comp = jattack.compromised.astype(np.float32)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    for r in range(3):
        mask = topo.edge_mask(r)
        key = jax.random.fold_in(jax.random.PRNGKey(3), r)
        j_params, j_state, j_m = step(j_params, j_state, key, jnp.asarray(mask),
                                      jnp.asarray(comp), jnp.asarray(float(r), jnp.float32), d)
        t_flat, t_state, t_m = prog.train_step(
            t_flat, t_state, torch.from_numpy(mask), torch.from_numpy(comp), float(r),
            draws=_jax_draws(key, data, comp, prog.model_dim))
        j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
        assert _scaled_delta(t_flat.numpy(), j_flat) <= 1e-4, r
        assert np.array_equal(t_state[P.ADJ_KEY].numpy(), np.asarray(j_state[P.ADJ_KEY]))
        assert float(t_m["agg_pipe_valid"]) == float(j_m["agg_pipe_valid"]) == min(r, 1)
        assert np.array_equal(t_m["agg_selected_index"].numpy(),
                              np.asarray(j_m["agg_selected_index"])), r


@pytest.mark.parametrize("rule", ["krum", "fedavg", "balance"])
def test_faulted_sparse_round_matches_jax(rule):
    # Node 1 dead (its edges gone both ways), node 4 emits NaN (quarantined),
    # and one IPM attacker whose broadcast overflows to inf (scrubbed).
    n, offsets = 8, (1, 2, 4)
    jagg = JAX_AGGREGATORS[rule](exchange_offsets=list(offsets), sparse_exchange=True,
                                 **({"num_compromised": 1} if rule == "krum" else {}))
    agg = AGGREGATORS[rule](exchange_offsets=list(offsets), sparse_exchange=True,
                            **({"num_compromised": 1} if rule == "krum" else {}))
    data = jax_data("synthetic", DATA, num_nodes=n, seed=5)
    jattack = jax_ipm(n, 0.125, epsilon=1e39, seed=5)
    attack = make_ipm_attack(n, 0.125, epsilon=1e39, seed=5)
    jprog = jax_build_round(jax_mlp(16, [16], 4), jagg, data, attack=jattack,
                            faults=JaxFaultSpec(nan_inject_nodes=(4,)),
                            sparse_offsets=offsets, **HP)
    init = _spread(jprog, n, 5)
    prog = build_round_program(make_mlp(16, [16], 4), agg, data, attack=attack,
                               init_params=init, faults=FaultSpec(nan_inject_nodes=(4,)),
                               sparse_offsets=offsets, device="cpu", **HP)
    alive = np.ones(n, np.float32)
    alive[1] = 0.0
    mask = np.ones((len(offsets), n), np.float32)
    mask[0, 6] = 0.0  # one dropped link
    comp = jattack.compromised.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    j_params, _, j_m = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key,
        jnp.asarray(mask), jnp.asarray(comp), jnp.asarray(alive), jnp.asarray(0.0), d)
    draws = _jax_draws(key, data, comp, prog.model_dim)
    draws.pop("noise")
    t_flat, _, t_m = prog.train_step(prog.init_flat, prog.init_agg_state,
                                     torch.from_numpy(mask), torch.from_numpy(comp), 0.0,
                                     draws=draws, alive=torch.from_numpy(alive))
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
    assert np.isfinite(t_flat.numpy()).all()
    assert _scaled_delta(t_flat.numpy(), j_flat) <= 1e-4
    for k in ("agg_alive", "agg_quarantined", "agg_attack_scrubbed"):
        assert float(t_m[k]) == float(j_m[k]), k
    assert float(t_m["agg_quarantined"]) == 1.0 and float(t_m["agg_attack_scrubbed"]) == 1.0
    if rule == "krum":
        assert np.array_equal(t_m["agg_selected_index"].numpy(),
                              np.asarray(j_m["agg_selected_index"]))


# ---------------------------------------------------------------------------
# the Network and the factories


@pytest.mark.parametrize("kind", ["exponential", "one_peer"])
@pytest.mark.parametrize("rule", sorted(RULE_PARAMS))
def test_every_rule_runs_on_a_sparse_topology(rule, kind):
    params = dict(RULE_PARAMS[rule])
    model = _raw()["model"]
    if rule == "evidential_trust":
        # Trust reads the Dirichlet outputs of an evidential model.
        model["params"]["evidential"] = True
    net = _net(topology={"type": kind, "num_nodes": 8}, model=model,
               aggregation={"algorithm": rule, "params": params})
    assert net.program.sparse_offsets == (1, 2, 4)
    history = net.train(2)
    assert history["round"] == [1, 2]
    assert all(np.isfinite(v).all() for k, v in history.items() if v)
    assert any(k.startswith("agg_") for k in history)
    assert torch.isfinite(net.flat).all()


def test_sparse_telemetry_in_degree_from_the_edge_masks(tmp_path):
    over = {"topology": {"type": "one_peer", "num_nodes": 8},
            "telemetry": {"enabled": True, "dir": str(tmp_path / "run"), "audit_taps": True}}
    net = _net(**over)
    net.train(3)
    net.telemetry.close()
    rounds = events_of_type(tmp_path / "run", "round")
    topo = create_topology("one_peer", 8)
    for e in rounds:
        want = topo.in_degree_from_edge_mask(topo.edge_mask(e["round"] - 1))
        assert np.array_equal(np.asarray(e["in_degree"], np.float32), want)
        assert np.array_equal(np.asarray(e["metrics"]["agg_tap_considered_by"], np.float32),
                              want)


def test_sparse_program_needs_its_sparse_topology():
    net = _net()
    with pytest.raises(ValueError, match="not a SparseTopology"):
        Network(net.program, create_topology("k-regular", 8, k=4))
    with pytest.raises(ValueError, match="offsets"):
        Network(net.program, TT.SparseTopology(8, (1, 3)))
    dense = _net(topology={"type": "k-regular", "num_nodes": 8, "k": 4})
    with pytest.raises(ValueError, match="dense"):
        Network(dense.program, create_topology("exponential", 8))


def test_one_peer_with_staleness_refused_by_name():
    raw = _raw(topology={"type": "one_peer", "num_nodes": 8}, faults=FAULTS,
               exchange={"max_staleness": 2})
    with pytest.raises(ValueError, match="one_peer"):
        Config.model_validate(raw)


def test_sparse_stale_run_serves_cached_rows():
    net = _net(faults=FAULTS, exchange={"max_staleness": 2})
    history = net.train(4)
    assert net.agg_state[TS.CACHE_KEY].shape == net.flat.shape
    assert any(v > 0 for v in history["agg_stale_used"])
