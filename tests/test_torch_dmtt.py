"""DMTT, mobility and the topology liar in the PyTorch port against the JAX
package, on the CPU.

- ``MobilityModel``: positions and G^t bit-equal to the JAX package's for
  30 rounds, asked for in order and out of order (its positions cache
  makes G^t independent of the order), with and without
  ``ensure_connected``;
- ``false_claims`` bit-equal; the liar wraps gaussian or directed
  deviation (an inner attack of another compromised set refused), and the
  factories take exactly those two inner types;
- ``topo_trust``, ``model_score``, ``collab_score`` within rtol 1e-6, and
  ``dmtt_round_update`` against the JAX package's on the same state and
  inputs over 5 chained rounds (each package carrying its own state): the
  exchange mask, the collaborator mask and the counts equal, ``dmtt_c_hat``,
  ``dmtt_alpha``, ``dmtt_beta`` and the mean topology trust within rtol
  1e-6.  TopB ranks the collaboration score q; both packages sort stably
  (equal scores rank by index).  The inputs are drawn so that no two q of
  a row lie within 1e-6 of each other at the B-th place unless they are
  exactly equal, which the test asserts: q sums three float32 terms below 1
  whose only cross-package difference is the ulp of one ``exp`` (XLA's
  float32 ``exp`` is not correctly rounded, torch's is), a few 1e-8;
- ``combined_probe_metric`` against the JAX package's (loss within rtol
  1e-5, accuracy and vacuity equal; the evidential fields within rtol
  1e-5), and UBAR and evidential trust giving the same output and stats
  with and without ``ctx.probe_cross``;
- three chained DMTT rounds (fedavg, the liar wrapping gaussian, G^t of
  the mobility model) against the JAX round from the same spread initial
  rows on the same draws: the cross-evaluation's accuracies, the DMTT
  masks and counts equal, the trust state within rtol 1e-6, the
  parameters within a scaled 1e-4;
- the Network under mobility (each round's staged graph is G^t, the
  telemetry in-degree too), fused bit-equal to per round, a DMTT run
  resumed mid-run bit-equal, and the refusals (sparse, compression,
  staleness, pipelining, ppermute); the gang under DMTT is
  tests/test_torch_gang_dmtt.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.probe import combined_probe_metric as jax_combined
from murmura_tpu.aggregation.probe import pairwise_probe_eval as jax_pairwise_probe
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.attacks.topology_liar import false_claims as jax_false_claims
from murmura_tpu.attacks.topology_liar import make_topology_liar_attack as jax_liar
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.dmtt import protocol as JP
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.topology.dynamic import MobilityModel as JaxMobility
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.aggregation.probe import combined_probe_metric, pairwise_probe_eval
from murmura_tpu_torch.attacks import ATTACKS
from murmura_tpu_torch.attacks.directed import make_directed_deviation_attack
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.attacks.topology_liar import false_claims, make_topology_liar_attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.network import Network, effective_adjacency
from murmura_tpu_torch.core.rounds import DMTT_STATE_KEYS, build_round_program
from murmura_tpu_torch.core.stale import StalenessSpec
from murmura_tpu_torch.dmtt import protocol as TP
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops.compress import CompressionSpec
from murmura_tpu_torch.ops.flatten import make_flatteners, tree_to_torch
from murmura_tpu_torch.telemetry.writer import events_of_type
from murmura_tpu_torch.topology.dynamic import MobilityModel
from murmura_tpu_torch.utils.factories import (
    ConfigError,
    build_network_from_config,
)

N = 16
HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=3)
DATA = {"num_samples": 640, "input_dim": 12, "num_classes": 4}
PARAMS = TP.DMTTParams(budget_B=5, rho=0.1, lambda_forget=0.9, w_a=0.7, tau_U=0.3, eta=5.0)
JPARAMS = JP.DMTTParams(budget_B=5, rho=0.1, lambda_forget=0.9, w_a=0.7, tau_U=0.3, eta=5.0)


def _scaled_delta(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# topology/dynamic.py and attacks/topology_liar.py


@pytest.mark.parametrize("connected", [True, False])
@pytest.mark.parametrize("order", ["forward", "shuffled"])
def test_mobility_bit_equal_to_jax(connected, order):
    kw = dict(num_nodes=N, area_size=100.0, comm_range=25.0, max_speed=5.0, seed=42,
              ensure_connected=connected)
    ref, got = JaxMobility(**kw), MobilityModel(**kw)
    rounds = list(range(30))
    asked = rounds if order == "forward" else list(np.random.default_rng(0).permutation(30))
    for r in asked:
        a = got.adjacency_at(int(r))
        assert a.dtype == bool and not a.diagonal().any()
        assert np.array_equal(a, ref.adjacency_at(int(r))), r
        assert np.array_equal(got.positions_at(int(r)), ref.positions_at(int(r)))
    # Asked again in order, the same graphs: the positions are cached.
    fresh = JaxMobility(**kw)
    for r in rounds:
        assert np.array_equal(got.adjacency_at(r), fresh.adjacency_at(r)), r
    assert got.neighbors_at(7) == ref.neighbors_at(7)
    assert got.torus_dist(1, 2, 5) == ref.torus_dist(1, 2, 5)


def test_false_claims_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    for trial in range(10):
        adj = (rng.random((N, N)) < 0.3).astype(np.float32)
        np.fill_diagonal(adj, 0.0)
        comp = (rng.random(N) < 0.25).astype(np.float32)
        ref = np.asarray(jax_false_claims(jnp.asarray(adj), jnp.asarray(comp)))
        got = false_claims(torch.from_numpy(adj), torch.from_numpy(comp))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref), trial


def test_liar_wraps_its_inner_attack():
    inner = make_gaussian_attack(N, 0.25, noise_std=10.0, seed=5)
    liar = make_topology_liar_attack(N, 0.25, seed=5, model_attack=inner)
    assert np.array_equal(liar.compromised, jax_liar(N, 0.25, seed=5).compromised)
    assert liar.claims_fn is false_claims
    flat = torch.zeros(N, 7)
    comp = torch.from_numpy(liar.compromised.astype(np.float32))
    noise = torch.ones(int(liar.compromised.sum()), 7)
    assert torch.equal(liar.apply(flat, comp, None, noise=noise),
                       inner.apply(flat, comp, None, noise=noise))
    pure = make_topology_liar_attack(N, 0.25, seed=5)
    assert pure.apply(flat, comp) is flat
    with pytest.raises(ValueError, match="different compromised set"):
        make_topology_liar_attack(N, 0.25, seed=6, model_attack=inner)
    assert ATTACKS["topology_liar"] is make_topology_liar_attack


def _raw(**over):
    raw = {
        "experiment": {"name": "dmtt", "seed": 3, "rounds": 4, "verbose": False},
        "topology": {"type": "fully", "num_nodes": N},
        "mobility": {"area_size": 100.0, "comm_range": 40.0, "max_speed": 5.0, "seed": 42},
        "dmtt": {"budget_B": 5},
        "aggregation": {"algorithm": "fedavg", "params": {}},
        "attack": {"enabled": True, "type": "topology_liar", "percentage": 0.25,
                   "params": {"model_attack_type": "gaussian", "noise_std": 10.0}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic", "params": dict(DATA)},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 12, "hidden_dims": [16], "num_classes": 4}},
        "backend": "simulation",
    }
    raw.update(over)
    return raw


def _net(**over):
    return build_network_from_config(Config.model_validate(_raw(**over)), device="cpu")


@pytest.mark.parametrize("params, inner", [
    ({"model_attack_type": "gaussian", "noise_std": 3.0}, "gaussian"),
    ({"model_attack_type": "directed_deviation", "lambda_param": -2.0}, "directed"),
    ({}, None),
])
def test_factory_builds_the_liar_and_its_inner_attack(params, inner):
    net = _net(attack={"enabled": True, "type": "topology_liar", "percentage": 0.25,
                       "params": params})
    attack = net.attack
    assert attack.name == "topology_liar" and attack.claims_fn is false_claims
    flat = torch.randn(N, net.program.model_dim)
    comp = torch.from_numpy(attack.compromised.astype(np.float32))
    c = int(attack.compromised.sum())
    noise = torch.randn(c, flat.shape[1])
    got = attack.apply(flat, comp, None, noise=noise)
    if inner is None:
        assert got is flat
    elif inner == "gaussian":
        want = make_gaussian_attack(N, 0.25, noise_std=3.0, seed=3).apply(flat, comp, None,
                                                                           noise=noise)
        assert torch.equal(got, want)
    else:
        want = make_directed_deviation_attack(N, 0.25, lambda_param=-2.0, seed=3).apply(
            flat, comp, None)
        assert torch.equal(got, want)


def test_factory_refuses_other_inner_attacks():
    with pytest.raises(ConfigError, match="model_attack_type 'alie' is not supported"):
        _net(attack={"enabled": True, "type": "topology_liar", "percentage": 0.25,
                     "params": {"model_attack_type": "alie"}})


# ---------------------------------------------------------------------------
# dmtt/protocol.py


def test_trust_scores_match_jax():
    rng = np.random.default_rng(2)
    alpha = rng.uniform(0.01, 20.0, (N, N)).astype(np.float32)
    beta = rng.uniform(0.01, 20.0, (N, N)).astype(np.float32)
    acc = rng.random((N, N)).astype(np.float32)
    vac = rng.random((N, N)).astype(np.float32)
    c_hat = rng.random((N, N)).astype(np.float32)
    t = TP.topo_trust(torch.from_numpy(alpha), torch.from_numpy(beta), PARAMS)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(JP.topo_trust(jnp.asarray(alpha), jnp.asarray(beta), JPARAMS)),
        rtol=1e-6)
    s = TP.model_score(torch.from_numpy(acc), torch.from_numpy(vac), PARAMS)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(JP.model_score(jnp.asarray(acc), jnp.asarray(vac), JPARAMS)),
        rtol=1e-6, atol=1e-7)
    q = TP.collab_score(s, t, torch.from_numpy(c_hat), PARAMS)
    jq = JP.collab_score(jnp.asarray(s.numpy()), jnp.asarray(t.numpy()), jnp.asarray(c_hat),
                         JPARAMS)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6)


def _margin_ok(q, valid, b):
    """No two valid q of a row within 1e-6 at the B-th place unless exactly
    equal (a stable sort then ranks both packages' ties by index)."""
    for row, ok in zip(q, valid):
        vals = np.sort(row[ok])[::-1]
        if len(vals) > b:
            gap = vals[b - 1] - vals[b]
            if gap != 0.0 and gap < 1e-6:
                return False
    return True


def test_top_b_mask_is_stable_on_ties():
    q = torch.tensor([[0.5, 0.5, 0.5, 0.2], [0.1, 0.9, 0.9, 0.9]])
    valid = torch.tensor([[True, True, True, True], [True, False, True, True]])
    got = TP._top_b_mask(q, valid, 2)
    ref = JP._top_b_mask(jnp.asarray(q.numpy()), jnp.asarray(valid.numpy()), 2)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert got.tolist() == [[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_update_matches_jax_over_chained_rounds(seed):
    rng = np.random.default_rng(seed)
    mob = MobilityModel(N, comm_range=40.0, seed=seed)
    comp = np.zeros(N, np.float32)
    comp[rng.choice(N, 4, replace=False)] = 1.0
    state = TP.init_dmtt_state(N)
    jstate = JP.init_dmtt_state(N)
    for r in range(5):
        adj = mob.adjacency_at(r).astype(np.float32)
        claims = false_claims(torch.from_numpy(adj), torch.from_numpy(comp))
        # Accuracies on a probe batch of 16 (multiples of 1/16), vacuities
        # of an evidential model in [0, 1].
        acc = rng.integers(0, 17, (N, N)).astype(np.float32) / 16.0
        vac = rng.random((N, N)).astype(np.float32)
        ex, state, stats = TP.dmtt_round_update(
            state, torch.from_numpy(adj), claims, torch.from_numpy(acc),
            torch.from_numpy(vac), PARAMS)
        jex, jstate, jstats = JP.dmtt_round_update(
            jstate, jnp.asarray(adj), jnp.asarray(claims.numpy()), jnp.asarray(acc),
            jnp.asarray(vac), JPARAMS)
        assert np.array_equal(ex.numpy(), np.asarray(jex)), r
        for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), rtol=1e-6,
                                       err_msg=f"{k} round {r}")
        t = TP.topo_trust(state["dmtt_alpha"], state["dmtt_beta"], PARAMS)
        np.testing.assert_allclose(
            t.numpy(), np.asarray(JP.topo_trust(jstate["dmtt_alpha"], jstate["dmtt_beta"],
                                                JPARAMS)), rtol=1e-6)
        s_model = torch.where(ex > 0, TP.model_score(torch.from_numpy(acc),
                                                     torch.from_numpy(vac), PARAMS), 0.5)
        q = TP.collab_score(s_model, t, state["dmtt_c_hat"], PARAMS).numpy()
        cand = (adj > 0) & ~np.eye(N, dtype=bool)
        assert _margin_ok(q, cand, PARAMS.budget_B), r
        assert np.array_equal(state["dmtt_collab"].numpy(), np.asarray(jstate["dmtt_collab"]))
        assert float(state["dmtt_selected"]) == float(jstate["dmtt_selected"]) == 1.0
        for k in ("dmtt_collab_count", "dmtt_received_count"):
            assert np.array_equal(stats[k].numpy(), np.asarray(jstats[k])), k
        np.testing.assert_allclose(stats["dmtt_mean_topo_trust"].numpy(),
                                   np.asarray(jstats["dmtt_mean_topo_trust"]), rtol=1e-6)
    assert set(state) == set(DMTT_STATE_KEYS)


# ---------------------------------------------------------------------------
# aggregation/probe.py and the probe rules' reuse


def _probe_setup(evidential, n=6, b=8, dim=5, k=3, seed=0):
    jmodel = jax_mlp(dim, [8], k, evidential=evidential)
    template = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    flat0, j_unravel = ravel_pytree(template)
    rng = np.random.default_rng(seed)
    flat = (np.asarray(flat0)[None] + 0.3 * rng.normal(size=(n, flat0.size))).astype(np.float32)
    px = rng.normal(size=(n, b, dim)).astype(np.float32)
    py = rng.integers(0, k, size=(n, b)).astype(np.int32)
    pm = (rng.random((n, b)) < 0.9).astype(np.float32)
    jctx = JaxCtx(apply_fn=jmodel.apply, unravel=j_unravel, probe_x=jnp.asarray(px),
                  probe_y=jnp.asarray(py), probe_mask=jnp.asarray(pm), evidential=evidential,
                  num_classes=k, total_rounds=5)
    _, t_unravel, _ = make_flatteners(tree_to_torch(template))
    tctx = AggContext(apply_fn=make_mlp(dim, [8], k, evidential=evidential).apply,
                      unravel=t_unravel, probe_x=torch.from_numpy(px),
                      probe_y=torch.from_numpy(py).long(), probe_mask=torch.from_numpy(pm),
                      evidential=evidential, num_classes=k, total_rounds=5)
    return jctx, tctx, flat


@pytest.mark.parametrize("evidential", [False, True])
def test_combined_probe_metric_matches_jax(evidential):
    jctx, tctx, flat = _probe_setup(evidential)
    ref = jax_pairwise_probe(jnp.asarray(flat), jctx, jax_combined(evidential))
    got = pairwise_probe_eval(torch.from_numpy(flat), tctx, combined_probe_metric(evidential))
    assert set(got) == set(ref)
    assert np.array_equal(got["accuracy"].numpy(), np.asarray(ref["accuracy"]))
    for k in set(ref) - {"accuracy"}:
        if evidential or k != "vacuity":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                       err_msg=k)
        else:
            assert not got[k].any() and not np.asarray(ref[k]).any()


@pytest.mark.parametrize("rule, evidential", [("ubar", False), ("ubar", True),
                                              ("evidential_trust", True)])
def test_probe_rules_same_with_and_without_probe_cross(rule, evidential):
    _, tctx, flat = _probe_setup(evidential, seed=4)
    n = flat.shape[0]
    own = torch.from_numpy(flat)
    bcast = own.clone()
    bcast[1] += 3.0 * torch.randn(own.shape[1], generator=torch.Generator().manual_seed(0))
    adj = torch.ones(n, n) - torch.eye(n)
    agg = AGGREGATORS[rule](**({"rho": 0.8} if rule == "ubar" else {}))
    state = {k: torch.as_tensor(np.asarray(v)) for k, v in agg.init_state(n).items()}
    cross = pairwise_probe_eval(bcast, tctx, combined_probe_metric(evidential))
    out_a, st_a, stats_a = agg.aggregate(own, bcast, adj, 1.0, state, tctx)
    with_cross = AggContext(**{**tctx.__dict__, "probe_cross": cross})
    out_b, st_b, stats_b = agg.aggregate(own, bcast, adj, 1.0, state, with_cross)
    assert torch.equal(out_a, out_b)
    assert stats_a.keys() == stats_b.keys()
    for k in stats_a:
        assert torch.equal(stats_a[k], stats_b[k]), k
    for k in st_a:
        assert torch.equal(st_a[k], st_b[k]), k


# ---------------------------------------------------------------------------
# the DMTT round against the JAX round


def _spread(jprog, seed):
    rng = np.random.default_rng(seed)
    scale = 0.05 * (1.0 + np.arange(N) / N)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((N,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)


def _jax_draws(key, mask_shape, comp, model_dim):
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, mask_shape))
    noise = np.array(jax.random.normal(attack_key, (int(comp.sum()), model_dim)))
    return {"u": [u], "noise": noise}


def test_chained_dmtt_rounds_match_jax():
    data = jax_data("synthetic", DATA, num_nodes=N, seed=3)
    jattack = jax_liar(N, 0.25, seed=3,
                       model_attack=jax_gaussian(N, 0.25, noise_std=10.0, seed=3))
    jprog = jax_build_round(jax_mlp(12, [16], 4), JAX_AGGREGATORS["fedavg"](), data,
                            attack=jattack, dmtt=JPARAMS, **HP)
    init = _spread(jprog, 3)
    attack = make_topology_liar_attack(
        N, 0.25, seed=3, model_attack=make_gaussian_attack(N, 0.25, noise_std=10.0, seed=3))
    prog = build_round_program(make_mlp(12, [16], 4), AGGREGATORS["fedavg"](), data,
                               attack=attack, init_params=init, dmtt=PARAMS, device="cpu",
                               **HP)
    assert set(DMTT_STATE_KEYS) <= set(prog.init_agg_state)
    mob = MobilityModel(N, comm_range=40.0, seed=42)
    comp = jattack.compromised.astype(np.float32)
    step = jax.jit(jprog.train_step)
    j_params, j_state = jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state
    t_flat, t_state = prog.init_flat, prog.init_agg_state
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    seen = []
    probe = pairwise_probe_eval

    def recording(bcast, ctx, metric):
        out = probe(bcast, ctx, metric)
        seen.append(out)
        return out

    import murmura_tpu_torch.core.rounds as rounds_mod

    rounds_mod.pairwise_probe_eval = recording
    try:
        for r in range(3):
            adj = mob.adjacency_at(r).astype(np.float32)
            key = jax.random.fold_in(jax.random.PRNGKey(3), r)
            j_params, j_state, j_m = step(j_params, j_state, key, jnp.asarray(adj),
                                          jnp.asarray(comp), jnp.asarray(float(r)), d)
            t_flat, t_state, t_m = prog.train_step(
                t_flat, t_state, torch.from_numpy(adj), torch.from_numpy(comp), float(r),
                draws=_jax_draws(key, tuple(prog.data["mask"].shape), comp, prog.model_dim))
            j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
            assert _scaled_delta(t_flat.numpy(), j_flat) <= 1e-4, r
            assert np.array_equal(t_state["dmtt_collab"].numpy(),
                                  np.asarray(j_state["dmtt_collab"])), r
            for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
                np.testing.assert_allclose(t_state[k].numpy(), np.asarray(j_state[k]),
                                           rtol=1e-6, err_msg=f"{k} round {r}")
            for k in ("agg_dmtt_collab_count", "agg_dmtt_received_count",
                      "agg_num_neighbors"):
                assert np.array_equal(t_m[k].numpy(), np.asarray(j_m[k])), (k, r)
            np.testing.assert_allclose(t_m["agg_dmtt_mean_topo_trust"].numpy(),
                                       np.asarray(j_m["agg_dmtt_mean_topo_trust"]), rtol=1e-6)
    finally:
        rounds_mod.pairwise_probe_eval = probe
    assert len(seen) == 3 and set(seen[0]) == {"accuracy", "vacuity", "loss"}


# ---------------------------------------------------------------------------
# the Network, the factories and the refusals


def test_network_stages_g_t_and_telemetry_reads_its_in_degree(tmp_path):
    net = _net(telemetry={"enabled": True, "dir": str(tmp_path / "run")})
    assert isinstance(net.mobility, MobilityModel) and net._static_adj is None
    staged = []
    step = net._stage

    def recording(rounds):
        adj, alive = step(rounds)
        staged.append(adj.clone())
        return adj, alive

    net._stage = recording
    history = net.train(3)
    net.telemetry.close()
    mob = MobilityModel(N, comm_range=40.0, seed=42)
    for r, adj in enumerate(staged):
        assert np.array_equal(adj[0].numpy(), mob.adjacency_at(r).astype(np.float32))
        assert np.array_equal(adj[0].numpy(), effective_adjacency(net.topology, mob, None, r))
    for e in events_of_type(tmp_path / "run", "round"):
        want = mob.adjacency_at(e["round"] - 1).sum(axis=0)
        assert np.array_equal(np.asarray(e["in_degree"]), want)
    for k in ("agg_dmtt_collab_count", "agg_dmtt_received_count", "agg_dmtt_mean_topo_trust"):
        assert len(history[k]) == 3 and all(np.isfinite(history[k])), k
    # Without DMTT (fedavg on G^t alone) the round's in-degree is G^t's.
    plain = _net(dmtt=None, attack={"enabled": False})
    h = plain.train(2)
    assert h["agg_num_neighbors"] == [float(mob.adjacency_at(r).sum(axis=1).mean())
                                      for r in range(2)]


def test_fused_dmtt_equals_per_round():
    a, b = _net(), _net()
    a.train(4)
    b.train(4, rounds_per_dispatch=2)
    assert a.history == b.history and torch.equal(a.flat, b.flat)
    for k in DMTT_STATE_KEYS:
        assert torch.equal(a.agg_state[k], b.agg_state[k]), k


def test_dmtt_resume_mid_run_is_bit_equal(tmp_path):
    ref = _net()
    ref.train(4)
    first = _net()
    first.train(2, checkpoint_dir=str(tmp_path / "ckpt"))
    resumed = _net()
    assert resumed.restore_checkpoint(str(tmp_path / "ckpt")) == 2
    assert float(resumed.agg_state["dmtt_selected"]) == 1.0
    resumed.train(2)
    assert resumed.history == ref.history and torch.equal(resumed.flat, ref.flat)
    for k in DMTT_STATE_KEYS:
        assert torch.equal(resumed.agg_state[k], ref.agg_state[k]), k


def test_dmtt_with_a_static_graph_and_ubar_runs():
    net = _net(mobility=None, dmtt={"budget_B": 3, "allow_static": True},
               topology={"type": "k-regular", "num_nodes": N, "k": 6},
               aggregation={"algorithm": "ubar", "params": {"rho": 0.8}})
    assert net.mobility is None and net._static_adj is not None
    history = net.train(2)
    assert max(history["agg_dmtt_collab_count"]) <= 3.0
    assert "agg_stage2_acceptance_rate" in history


def test_no_static_candidate_cap_under_mobility_or_dmtt():
    krum = {"algorithm": "krum", "params": {"num_compromised": 1}}
    for over in ({"dmtt": None}, {}):
        net = _net(aggregation=krum, **over)
        assert net.train(1)["round"] == [1]
    from murmura_tpu_torch.utils import factories as F

    seen = {}
    build = F.build_aggregator

    def spy(name, params, **kw):
        seen[name] = dict(params)
        return build(name, params, **kw)

    F.build_aggregator = spy
    try:
        _net(aggregation=krum)
        assert "max_candidates" not in seen["krum"]
        _net(aggregation=krum, mobility=None, dmtt=None, attack={"enabled": False})
        assert seen["krum"]["max_candidates"] == N
    finally:
        F.build_aggregator = build


def test_compositions_refused_by_name():
    data = jax_data("synthetic", DATA, num_nodes=N, seed=3)
    kw = dict(dmtt=PARAMS, device="cpu", **HP)
    model, agg = make_mlp(12, [16], 4), AGGREGATORS["fedavg"]()
    with pytest.raises(ValueError, match="sparse exchange mode does not compose with DMTT"):
        build_round_program(model, AGGREGATORS["fedavg"](exchange_offsets=[1, 2],
                                                         sparse_exchange=True),
                            data, sparse_offsets=(1, 2), **kw)
    with pytest.raises(ValueError, match="compressed exchange does not compose with DMTT"):
        build_round_program(model, agg, data, compression=CompressionSpec("int8"), **kw)
    with pytest.raises(ValueError, match="pipelined rounds do not compose with DMTT"):
        build_round_program(model, agg, data, pipeline=True, **kw)
    with pytest.raises(ValueError, match="bounded staleness does not compose with DMTT"):
        build_round_program(model, agg, data, faults=FaultSpec(), staleness=StalenessSpec(
            max_staleness=2, base_mask=np.ones((N, N), np.float32)), **kw)
    with pytest.raises(ValueError, match="ppermute requires a static circulant"):
        _net(backend="tpu", tpu={"exchange": "ppermute"},
             topology={"type": "ring", "num_nodes": N})
    with pytest.raises(ValueError, match="sparse topologies do not compose with mobility"):
        Config.model_validate(_raw(topology={"type": "exponential", "num_nodes": N},
                                   dmtt=None))
    with pytest.raises(ValueError, match="dmtt requires a mobility section"):
        Config.model_validate(_raw(mobility=None))
    prog = _net().program
    with pytest.raises(ValueError, match="sparse exchange mode does not compose with mobility"):
        Network(_net(mobility=None, dmtt=None, attack={"enabled": False},
                     topology={"type": "exponential", "num_nodes": N}).program,
                create_sparse(), mobility=MobilityModel(N))
    assert prog.dmtt == PARAMS


def create_sparse():
    from murmura_tpu_torch.topology.generators import create_topology

    return create_topology("exponential", N)
