"""The probe rules (UBAR, evidential trust) and the row-reading attacks
(ALIE, IPM, adaptive ALIE, adaptive IPM, the scale bisection) over a node
group (``backend: tpu`` over W ranks), on the CPU.

One spawned gloo group of 4 ranks (``launch(..., axis="nodes")``) runs every
case of tests/torch_node_axis_probe_cases.py, and the test process runs the
same cases in one process:

- the JAX package's tiny round (tests/test_param_sharding.py
  ``_tiny_program``; evidential trust on the evidential MLP) of UBAR,
  evidential trust, and Krum under ALIE, IPM and adaptive ALIE, through
  ``make_mesh(4)`` and ``shard_step`` on the conftest's CPU devices, JAX's
  initial parameters carried over and its shuffle draw injected, against
  the port's 4-rank round: rtol 5e-5, atol 5e-6 (the JAX test's own
  tolerance), the decisions (picks, stage and acceptance rates, the
  attack's carried state) equal;
- {UBAR, evidential trust} x {allgather, ppermute, the sparse exchange}
  under a gaussian attack, {ALIE, IPM} under Krum {allgather, ppermute},
  the three adaptive attacks under Krum on both exchanges and adaptive
  ALIE under UBAR, all with audit taps, 2 rounds over the group against
  one process: decisions and taps equal, the floats and the carried state
  within a scaled 1e-4.  Bit-equal on this CPU but where the group sums
  another order: ALIE's coalition statistics and Krum's distance centre
  (their [1, P] partials summed over the ranks), evidential trust's
  circulant taps (index_add_ then all_reduce) and probes vmapped over R_r
  rows; NOT_BIT_EQUAL names them;
- the probe forwards on one input: the dense cross-evaluation bit-equal to
  one process's (each sender's model alone on every probe batch, as
  there), the circulant one and the self probe within rtol 1e-6 (vmapped
  over the block's rows instead of all N: one float32 ulp);
- the exchange: under ppermute and the sparse exchange a rank receives
  exactly its window's rows each round, under allgather the whole [N, P];
  no other collective moves a row wider than an [N] metric row (the probe
  metric blocks, the stats), and the [1, P] all-reduces stay below one
  broadcast's bytes a round: nothing gathers the [N, P] broadcast;
- an adaptive ALIE run (Krum, chaos_churn.yaml's faults) and an evidential
  trust run (its [N, N] edge state held as the ranks' row blocks) through
  Network: against one process, and a snapshot after round 1 resumed
  bit-equal; the carried attack state replicated, the edge state
  gathered whole into the snapshot;
- DMTT over the group (the trust protocol on the node block,
  dmtt/protocol.py): the JAX package's tiny DMTT program under the topology
  liar, 2 rounds on a mobility model's G^t through ``make_mesh(4)`` and
  ``shard_step`` against the port's 4-rank rounds (rtol 5e-5, atol 5e-6;
  the exchange and collaborator masks and the ``agg_dmtt_*`` counts
  equal); {fedavg, Krum, UBAR sharing the cross-evaluation} under the liar
  wrapping a gaussian attack against one process (the cross-evaluation,
  the masks, the counts and the decisions equal, the parameters and the
  trust state bit-equal, the Krum score within KRUM_SCORE_RTOL); the
  collaborator-mask gather moving N² bytes a round and no gather a row
  wider than an [N] metric row; a DMTT Network under mobility against one
  process, in fused chunks too, and snapshotted after round 1 and resumed
  bit-equal, its [N, N] trust state gathered whole into the snapshot;
- no rank loads JAX or the JAX package.

Beside the group: evidential trust's neighbourhood median indexes over the
network's N columns on a node block whose degree exceeds twice its rows;
the bundled configs that the node axis refused for these sections plan no
refusal at ``tpu.num_devices: 2``, the two DMTT configs none at 4.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import torch_node_axis_probe_cases as cases
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.parallel.launch import launch
from murmura_tpu_torch.utils.factories import node_axis_sections, refuse_node_axis

ROOT = Path(__file__).resolve().parents[1]

# Stats that are decisions: equal, not within a tolerance.
DECISIONS = ("agg_selected_index", "agg_selected_own", "agg_acceptance_rate",
             "agg_stage1_acceptance_rate", "agg_stage2_acceptance_rate",
             "agg_tap_selected_by", "agg_tap_considered_by", "agg_tap_accepted",
             "agg_tap_considered", "agg_atk_accept", "agg_atk_z", "agg_atk_eps", "agg_atk_scale",
             "agg_atk_lo", "agg_atk_hi", "agg_alive", "agg_quarantined", "agg_attack_scrubbed",
             "agg_tap_quarantined", "agg_tap_alive", "agg_tap_attack_scrubbed")
# The dense Krum score: the Gram identity's float32 cancellation under
# ALIE's identical colluder rows puts the port's one process 7.1e-5
# relative from JAX already, and the group's colluder rows (their
# statistics summed in another order) 1.8e-4 scaled from one process's
# after chaos_churn's faults (both measured on this CPU): 1e-3, the
# tolerance of the gang's and the seed axis's Krum scores
# (tests/test_torch_seed_axis.py).
KRUM_SCORE_RTOL = 1e-3
# The attack's carried state that walks by decisions: equal.
STATE_DECISIONS = ("atk_z", "atk_eps", "atk_scale", "atk_lo", "atk_hi", "trust_seen")

ROUND_SPECS = (
    [{"rule": r, "exchange": e, "attack": "gaussian"}
     for r in ("ubar", "evidential_trust") for e in ("allgather", "ppermute", "exponential")]
    + [{"rule": "krum", "exchange": e, "attack": a}
       for a in ("alie", "ipm") for e in ("allgather", "ppermute")]
    + [{"rule": "krum", "exchange": e, "attack": a}
       for a in ("adaptive_alie", "adaptive_ipm", "bisection") for e in ("allgather", "ppermute")]
    + [{"rule": "ubar", "exchange": "allgather", "attack": "adaptive_alie"}])
# Where the group and one process differ in the last bits on this CPU:
# ALIE's statistics and the dense Krum centre sum the ranks' [1, P]
# partials, evidential trust's circulant taps add at the senders and sum
# over the group, its probes run vmapped over the block's rows.
NOT_BIT_EQUAL = ("evidential_trust-allgather-gaussian", "evidential_trust-ppermute-gaussian",
                 "evidential_trust-exponential-gaussian", "krum-allgather-alie",
                 "krum-ppermute-alie", "krum-allgather-adaptive_alie",
                 "krum-ppermute-adaptive_alie", "ubar-allgather-adaptive_alie")
# (rule, attack, evidential head) of the JAX package's tiny rounds.
JAX_CASES = (("ubar", None, False), ("evidential_trust", None, True), ("krum", "alie", False),
             ("krum", "ipm", False), ("krum", "adaptive_alie", False))
# The bundled configs the node axis refused for these sections.
UNREFUSED = ("examples/configs/ubar_attack.yaml",
             "examples/configs/uci_har_evidential_trust.yaml",
             "examples/configs/alie_geometric_median.yaml")
DMTT_CONFIGS = ("examples/configs/dmtt_mobility.yaml", "experiments/paper/dmtt/03_dmtt.yaml")
# DMTT's rules over the group: UBAR shares the round's cross-evaluation.
DMTT_RULES = ("fedavg", "krum", "ubar")
# The DMTT decisions: equal.
DMTT_DECISIONS = ("agg_dmtt_collab_count", "agg_dmtt_received_count")


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not ref.size:
        return 0.0 if not got.size else float("inf")
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _case_id(spec):
    return "-".join((spec["rule"], spec["exchange"], spec["attack"]))


def _jax_id(case):
    rule, attack, _ = case
    return rule if attack is None else f"{rule}-{attack}"


def _jax_attack(name):
    from murmura_tpu.attacks.adaptive import make_adaptive_alie_attack
    from murmura_tpu.attacks.alie import make_alie_attack
    from murmura_tpu.attacks.ipm import make_ipm_attack

    n, seed = cases.N, cases.SEED
    return {"alie": lambda: make_alie_attack(n, 0.25, z=cases.ALIE_Z, seed=seed),
            "ipm": lambda: make_ipm_attack(n, 0.25, seed=seed),
            "adaptive_alie": lambda: make_adaptive_alie_attack(n, 0.25, z=cases.ALIE_Z,
                                                               seed=seed)}[name]()


def _spread(a, n, rng):
    a = np.asarray(a)
    scale = 0.05 * (1.0 + np.arange(n) / n)
    noise = rng.normal(size=a.shape).astype(np.float32)
    return (a[:1] + scale.reshape((n,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)


def _jax_tiny_spec(case):
    """The JAX package's tiny round of ``case`` on a node mesh of 4, from
    spread initial parameters: (its spec for the port, its whole [N, P]
    output, its metrics, its carried state)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    import murmura_tpu.models as jax_models
    from murmura_tpu.analysis.ir import AGG_CASES
    from murmura_tpu.parallel.mesh import make_mesh, shard_step
    from test_param_sharding import _step_args, _tiny_program
    from test_torch_node_axis import _u_draw

    rule, attack_name, evidential = case
    attack = None if attack_name is None else _jax_attack(attack_name)
    real = jax_models.make_mlp
    if evidential:
        # _tiny_program's MLP with the evidential head.
        jax_models.make_mlp = functools.partial(real, evidential=True)
    try:
        prog = _tiny_program(rule, attack=attack)
    finally:
        jax_models.make_mlp = real
    n = prog.num_nodes
    rng = np.random.default_rng(cases.SEED)
    init = jax.tree_util.tree_map(lambda a: _spread(a, n, rng), prog.init_params)
    step = shard_step(prog.train_step, prog, make_mesh(cases.WORLD), donate=False)
    args = list(_step_args(prog))
    args[0] = jax.tree_util.tree_map(jnp.asarray, init)
    if attack is not None:
        args[4] = jnp.asarray(attack.compromised, jnp.float32)
    params, state, metrics = step(*args)
    flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(params))
    spec = {"init": init, "u": _u_draw(args[2], prog.data_arrays["mask"].shape),
            "agg_params": dict(AGG_CASES[rule]), "rule": rule, "attack": attack_name,
            "evidential": evidential}
    return (spec, flat, {k: np.asarray(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in state.items()})


def _jax_dmtt_spec(rule):
    """The JAX package's tiny DMTT program of ``rule`` under the topology
    liar (claims only), 2 rounds on a node mesh of 4 from spread initial
    parameters: (its spec for the port, its whole [N, P] output, each
    round's metrics, its carried state)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.analysis.ir import AGG_CASES
    from murmura_tpu.attacks.topology_liar import make_topology_liar_attack
    from murmura_tpu.dmtt.protocol import DMTTParams
    from murmura_tpu.parallel.mesh import make_mesh, shard_step
    from test_param_sharding import _step_args, _tiny_program
    from test_torch_node_axis import _u_draw

    attack = make_topology_liar_attack(cases.N, 0.25, seed=cases.SEED)
    prog = _tiny_program(rule, attack=attack, dmtt=DMTTParams(budget_B=cases.DMTT_B))
    rng = np.random.default_rng(cases.SEED)
    init = jax.tree_util.tree_map(lambda a: _spread(a, prog.num_nodes, rng), prog.init_params)
    step = shard_step(prog.train_step, prog, make_mesh(cases.WORLD), donate=False)
    args = _step_args(prog)
    params, state = jax.tree_util.tree_map(jnp.asarray, init), args[1]
    comp = jnp.asarray(attack.compromised, jnp.float32)
    graphs = cases.dmtt_graphs(2)
    us, rounds = [], []
    for r, adj in enumerate(graphs):
        key = jax.random.PRNGKey(r)
        params, state, metrics = step(params, state, key, jnp.asarray(adj), comp,
                                      jnp.asarray(float(r), jnp.float32), args[6])
        us.append(_u_draw(key, prog.data_arrays["mask"].shape))
        rounds.append({k: np.asarray(v) for k, v in metrics.items()})
    flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(params))
    spec = {"init": init, "u": us, "adj": graphs, "agg_params": dict(AGG_CASES[rule]),
            "rule": rule, "budget_B": cases.DMTT_B}
    return spec, flat, rounds, {k: np.asarray(v) for k, v in state.items()}


def _dmtt_config(**over):
    """The tiny config under dmtt_mobility.yaml's sections: G^t of the
    mobility model, TopB of 5, the topology liar wrapping a gaussian
    attack, Krum (c = 1), no faults."""
    return cases.tiny_config(
        topology={"type": "fully", "num_nodes": cases.N, "k": None},
        mobility=dict(cases.DMTT_MOBILITY), dmtt={"budget_B": cases.DMTT_B},
        attack={"type": "topology_liar", "params": {"model_attack_type": "gaussian",
                                                    "noise_std": 1.0}},
        faults={"enabled": False}, **over)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, in the group of 4 and in one process."""
    tmp = tmp_path_factory.mktemp("node_axis_probe")
    jax_tiny = {_jax_id(c): _jax_tiny_spec(c) for c in JAX_CASES}
    jax_dmtt = _jax_dmtt_spec("krum")
    adaptive = cases.tiny_config(attack={"type": "alie", "params": {"z": cases.ALIE_Z},
                                         "adaptive": {"enabled": True}})
    evidential = cases.tiny_config(
        aggregation={"algorithm": "evidential_trust", "params": {}},
        model={"factory": "mlp", "params": {"input_dim": 6, "hidden_dims": [13],
                                            "num_classes": 3, "evidential": True}})
    network_specs = {
        "adaptive_resume": {"raw": adaptive, "rounds": 2, "resume": True,
                            "snapshot_dir": str(tmp / "adaptive")},
        "evidential_resume": {"raw": evidential, "rounds": 2, "resume": True,
                              "snapshot_dir": str(tmp / "evidential")},
        "ubar_ppermute": {"raw": cases.tiny_config(
            aggregation={"algorithm": "ubar", "params": {}}, tpu={"exchange": "ppermute"}),
            "rounds": 2},
        "dmtt_resume": {"raw": _dmtt_config(), "rounds": 2, "resume": True,
                        "snapshot_dir": str(tmp / "dmtt")},
        "dmtt_fused": {"raw": _dmtt_config(), "rounds": 2, "rounds_per_dispatch": 2},
    }
    plan = ([("jax_tiny", v[0]) for v in jax_tiny.values()]
            + [("round", {**s, "audit": True}) for s in ROUND_SPECS] + [("probe", {})]
            + [("network", s) for s in network_specs.values()]
            + [("jax_dmtt", jax_dmtt[0])] + [("dmtt", {"rule": r}) for r in DMTT_RULES])
    group = launch(cases.run_cases, (plan,), world=cases.WORLD, axis="nodes", timeout_s=300)
    local_plan = [(k, {**s, "snapshot_dir": None}) if k == "network" else (k, s)
                  for k, s in plan]
    local = cases.run_cases(local_plan)
    names = ([f"jax:{k}" for k in jax_tiny] + [_case_id(s) for s in ROUND_SPECS] + ["probe"]
             + list(network_specs) + ["jax:dmtt"] + [f"dmtt-{r}" for r in DMTT_RULES])
    return {"group": [dict(zip(names, g["results"])) for g in group],
            "local": dict(zip(names, local["results"])),
            "forbidden": [g["forbidden_modules"] for g in group],
            "plain": [g["plain_calls"] for g in group],
            "jax": {k: v[1:] for k, v in jax_tiny.items()}, "jax_dmtt": jax_dmtt[1:]}


@pytest.mark.parametrize("case", JAX_CASES, ids=_jax_id)
def test_jax_tiny_round_matches_jax_shard_step(runs, case):
    name = _jax_id(case)
    jax_flat, jax_metrics, jax_state = runs["jax"][name]
    got = runs["group"][0][f"jax:{name}"]
    np.testing.assert_allclose(got["flat"], jax_flat, rtol=5e-5, atol=5e-6)
    assert set(got["metrics"]) == set(jax_metrics)
    for k, v in jax_metrics.items():
        if k in DECISIONS:
            np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)
        else:
            rtol = KRUM_SCORE_RTOL if k == "agg_krum_score" else 5e-5
            np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, atol=5e-6, err_msg=k)
    assert set(got["state"]) == set(jax_state)
    for k, v in jax_state.items():
        if k in STATE_DECISIONS:
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["state"][k], v, rtol=5e-5, atol=5e-6, err_msg=k)
    m = got["metrics"]
    if case[0] == "ubar":
        # Stage 1 shortlisted and stage 2 accepted somewhere.
        assert m["agg_stage1_acceptance_rate"].any() and m["agg_stage2_acceptance_rate"].any()
    if case[0] == "krum":
        # Krum selected somewhere, and the colluders' rows were picked or not
        # by the same rule in both packages.
        assert not m["agg_selected_own"].all()
    if case[1] == "adaptive_alie":
        # The walk moved z on the colluders' rows.
        assert (got["state"]["atk_z"] != cases.ALIE_Z).any()


@pytest.mark.parametrize("spec", ROUND_SPECS, ids=_case_id)
def test_round_over_the_node_axis_matches_one_process(runs, spec):
    name = _case_id(spec)
    got, ref = runs["group"][0][name], runs["local"][name]
    assert got["rows"][0] == cases.N // cases.WORLD and ref["rows"][0] == cases.N
    for g, r in zip(got["rounds"], ref["rounds"]):
        assert set(g) == set(r)
        assert "agg_tap_selected_by" in r or "agg_tap_accepted" in r
        for k in r:
            if k in DECISIONS:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                assert _scaled(g[k], r[k]) <= 1e-4, k
    assert set(got["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        if k in STATE_DECISIONS:
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        else:
            assert _scaled(got["state"][k], v) <= 1e-4, k
    assert _scaled(got["flat"], ref["flat"]) <= 1e-4
    assert (got["flat"].tobytes() == ref["flat"].tobytes()) == (name not in NOT_BIT_EQUAL)
    # The edge state lives as each rank's [R, N] rows.
    assert got["row_state_keys"] == (
        ("smoothed_trust", "trust_seen") if spec["rule"] == "evidential_trust" else ())
    if spec["rule"] == "krum":
        assert any(not r["agg_selected_own"].all() for r in ref["rounds"])


@pytest.mark.parametrize("spec", ROUND_SPECS, ids=_case_id)
def test_a_rank_receives_only_its_window_and_no_whole_broadcast(runs, spec):
    """Each round one exchange: under allgather every rank's rows (N), under
    ppermute and the sparse exchange the block plus the window's high - low
    rows.  Beside it no gather moves a row wider than an [N] metric row, and
    the [1, P] all-reduces move less than one [N, P] broadcast a round."""
    r = cases.N // cases.WORLD
    # offsets 1, 2, 6, 7: the window -2 .. +2; offsets 1, 2, 4: 0 .. +4.
    per_round = cases.N if spec["exchange"] == "allgather" else r + 4
    for rank, res in enumerate(runs["group"]):
        got = res[_case_id(spec)]
        counts, coll = got["exchange"], got["collectives"]
        assert counts["calls"] == 2 and counts["rows"] == 2 * per_round, rank
        assert counts["rows_from_others"] == 2 * (per_round - r), rank
        assert 0 < coll["gather_row_bytes_max"] <= cases.N * 4, (rank, coll)
        assert coll["all_reduce_bytes"] < 2 * cases.N * got["dim"] * 4, (rank, coll)


def test_probe_matrices_of_the_node_group_match_one_process(runs):
    got, ref = runs["group"][0]["probe"], runs["local"]["probe"]
    assert ref["dense"]["vacuity"].shape == (cases.N, cases.N)
    assert ref["circulant"]["vacuity"].shape == (4, cases.N)
    for k, v in ref["dense"].items():
        # Each sender's model alone on every probe batch, as in one process.
        assert got["dense"][k].tobytes() == v.tobytes(), k
    for part in ("circulant", "self"):
        for k, v in ref[part].items():
            # Vmapped over the block's rows: float32 rounding of the batched
            # matmul, not a different evaluation.
            np.testing.assert_allclose(got[part][k], v, rtol=1e-6, atol=0, err_msg=k)
    # The circulant probe read the window only: R + 4 rows.
    assert all(g["probe"]["window_rows"] == cases.N // cases.WORLD + 4 for g in runs["group"])


@pytest.mark.parametrize("name", ["adaptive_resume", "evidential_resume", "ubar_ppermute",
                                  "dmtt_resume", "dmtt_fused"])
def test_network_over_the_node_axis_matches_one_process(runs, name):
    got, ref = runs["group"][0][name]["run"], runs["local"][name]["run"]
    assert runs["group"][0][name]["rows"][0] == cases.N // cases.WORLD
    assert _scaled(got["flat"], ref["flat"]) <= 1e-4
    assert set(got["history"]) == set(ref["history"])
    for k, v in ref["history"].items():
        if k in DECISIONS or k == "round":
            assert got["history"][k] == v, k
        else:
            tol = KRUM_SCORE_RTOL if k == "agg_krum_score" else 1e-4
            assert _scaled(got["history"][k], v) <= tol, k
    # The snapshot layout: every carried key whole, as one process holds it.
    assert set(got["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        assert got["state"][k].shape == v.shape, k
        if k in STATE_DECISIONS:
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        else:
            assert _scaled(got["state"][k], v) <= 1e-4, k
    assert all(g[name]["run"] is None for g in runs["group"][1:])


@pytest.mark.parametrize("name", ["adaptive_resume", "evidential_resume", "dmtt_resume"])
def test_snapshot_after_round_one_resumes_bit_equal(runs, name):
    got = runs["group"][0][name]
    assert got["restored_round"] == 1
    assert got["resumed"]["flat"].tobytes() == got["run"]["flat"].tobytes()
    assert got["resumed"]["history"] == got["run"]["history"]
    for k, v in got["run"]["state"].items():
        assert got["resumed"]["state"][k].tobytes() == v.tobytes(), k
    state = got["run"]["state"]
    if name == "adaptive_resume":
        # The walk moved: the snapshot carries a mid-run attacker.
        assert (state["atk_z"] != cases.ALIE_Z).any()
    elif name == "dmtt_resume":
        # The trust state whole, a selection made.
        assert state["dmtt_alpha"].shape == (cases.N, cases.N)
        assert state["dmtt_selected"] == 1.0 and state["dmtt_collab"].any()
    else:
        assert state["smoothed_trust"].shape == (cases.N, cases.N) and state["trust_seen"].any()


def test_no_rank_loads_jax_and_no_plain_call_is_counted_as_a_launch(runs):
    assert runs["forbidden"] == [[]] * cases.WORLD
    # On the CPU every kernel call is its plain version: UBAR's and Krum's
    # dense distances and the window's circulant ones all ran on each rank.
    for plain in runs["plain"]:
        assert plain["pairwise_sq_distances"] > 0 and plain["circulant_sq_distances"] > 0


def _dmtt_decisions_equal(got, ref, where):
    for k in DMTT_DECISIONS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{k} {where}")


def test_jax_dmtt_rounds_match_jax_shard_step(runs):
    jax_flat, jax_rounds, jax_state = runs["jax_dmtt"]
    got = runs["group"][0]["jax:dmtt"]
    np.testing.assert_allclose(got["flat"], jax_flat, rtol=5e-5, atol=5e-6)
    for r, (g, j) in enumerate(zip(got["rounds"], jax_rounds)):
        _dmtt_decisions_equal(g, j, r)
        for k in ("agg_selected_index", "agg_selected_own"):
            np.testing.assert_array_equal(g[k], j[k], err_msg=f"{k} {r}")
        for k in ("agg_dmtt_mean_topo_trust", "agg_krum_score"):
            rtol = KRUM_SCORE_RTOL if k == "agg_krum_score" else 5e-5
            np.testing.assert_allclose(g[k], j[k], rtol=rtol, atol=5e-6, err_msg=f"{k} {r}")
    np.testing.assert_array_equal(got["state"]["dmtt_collab"], jax_state["dmtt_collab"])
    np.testing.assert_array_equal(got["state"]["dmtt_selected"], jax_state["dmtt_selected"])
    for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
        np.testing.assert_allclose(got["state"][k], jax_state[k], rtol=5e-5, atol=5e-6,
                                   err_msg=k)
    # The second round ran on the first round's selection, and the liars'
    # claims were contradicted: some beta moved.
    assert jax_state["dmtt_selected"] == 1.0
    assert (got["state"]["dmtt_beta"] != 1.0).any()
    # The exchange masks of the two rounds equal the one process's port.
    for g, r in zip(got["masks"], runs["local"]["jax:dmtt"]["masks"]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("rule", DMTT_RULES)
def test_dmtt_over_the_node_axis_matches_one_process(runs, rule):
    got, ref = runs["group"][0][f"dmtt-{rule}"], runs["local"][f"dmtt-{rule}"]
    assert got["rows"][0] == cases.N // cases.WORLD and ref["rows"][0] == cases.N
    assert got["row_state_keys"] == ("dmtt_alpha", "dmtt_beta", "dmtt_c_hat", "dmtt_collab")
    for r, (g, l) in enumerate(zip(got["rounds"], ref["rounds"])):
        assert set(g) == set(l)
        for k in l:
            if k == "agg_krum_score":
                # The dense Krum centre sums the block's partials over the
                # group (NOT_BIT_EQUAL above).
                np.testing.assert_allclose(g[k], l[k], rtol=KRUM_SCORE_RTOL, err_msg=k)
            else:
                assert g[k].tobytes() == l[k].tobytes(), (k, r)
    # The cross-evaluation, sender-major over the exchanged broadcast, and
    # the exchange masks are the one process's.
    for g, l in zip(got["cross"], ref["cross"]):
        assert set(g) == set(l) == {"accuracy", "vacuity", "loss"}
        for k in l:
            assert g[k].tobytes() == l[k].tobytes(), k
    for g, l in zip(got["masks"], ref["masks"]):
        assert g.shape == (cases.N, cases.N) and np.array_equal(g, l)
    assert got["flat"].tobytes() == ref["flat"].tobytes()
    for k, v in ref["state"].items():
        assert got["state"][k].tobytes() == v.tobytes(), k
    assert ref["state"]["dmtt_collab"].sum(axis=1).max() <= cases.DMTT_B
    if rule == "krum":
        assert any(not r["agg_selected_own"].all() for r in ref["rounds"])
    if rule == "ubar":
        assert any(r["agg_stage2_acceptance_rate"].any() for r in ref["rounds"])


@pytest.mark.parametrize("rule", DMTT_RULES)
def test_dmtt_mask_gather_moves_n_squared_bytes_and_no_parameter_row(runs, rule):
    """A round: one all_gather of the [N, P] broadcast (the exchange), one
    gather of the [R, N] 0/1 collaborator rows (N² bytes), and beside them
    no gather of a row wider than an [N] float32 metric row."""
    n = cases.N
    for rank, res in enumerate(runs["group"]):
        got = res[f"dmtt-{rule}"]
        counts, coll = got["exchange"], got["collectives"]
        assert counts["calls"] == 2 and counts["rows"] == 2 * n, rank
        assert coll["mask_gathers"] == 2 and coll["mask_bytes"] == 2 * n * n, (rank, coll)
        assert 0 < coll["gather_row_bytes_max"] <= n * 4, (rank, coll)
        assert coll["all_reduce_bytes"] < 2 * n * got["dim"] * 4, (rank, coll)


@pytest.mark.parametrize("path", DMTT_CONFIGS)
def test_dmtt_config_plans_no_refusal_over_a_node_axis_of_four(path):
    raw = yaml.safe_load((ROOT / path).read_text())
    raw["backend"] = "tpu"
    raw["tpu"] = {**(raw.get("tpu") or {}), "num_devices": 4, "param_shards": 1}
    cfg = Config.model_validate(raw)
    assert node_axis_sections(cfg) == []
    refuse_node_axis(cfg, "cpu")


# ---------------------------------------------------------------------------
# beside the group


def test_evidential_median_index_runs_over_the_network_on_a_block():
    """A block of R = 2 receivers of N = 8 whose degree is 5 > 2R: the
    neighbourhood median's index is (5 - 1) // 2 = 2, which a clamp at the
    block's R - 1 would cut to 1.  The block's rows equal one process's."""
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.aggregation.base import AggContext
    from murmura_tpu_torch.parallel.mesh import NodeGroup, node_block_scope

    n, p = 8, 5
    rng = np.random.default_rng(3)
    agg = build_aggregator("evidential_trust", {"strength_guard_factor": 1.5})
    own = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    bcast = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    adj = torch.zeros((n, n))
    for i in range(n):
        adj[i, [(i + o) % n for o in (1, 2, 3, 4, 5)]] = 1.0
    # Strengths 1, 2, 3, 4, 5 on each receiver's neighbours: the median is 3,
    # so the guard (1.5 x the median) zeroes 5; at the median 2 it would
    # zero 4 as well.
    strength = torch.zeros((n, n))
    for i in range(n):
        strength[i, [(i + o) % n for o in (1, 2, 3, 4, 5)]] = torch.arange(1.0, 6.0)
    metrics = {"accuracy": torch.full((n, n), 0.9), "vacuity": torch.full((n, n), 0.1),
               "entropy": torch.full((n, n), 0.5), "strength": strength}
    state = {k: torch.as_tensor(v) for k, v in agg.init_state(n).items()}

    def ctx(rows):
        return AggContext(total_rounds=4, probe_cross={k: v[rows] for k, v in metrics.items()})

    whole, whole_state, whole_stats = agg.aggregate(own, bcast, adj, 0.0, state,
                                                    ctx(slice(0, n)))
    group = NodeGroup(1, 4, "gloo", torch.device("cpu")).bind(n)
    lo, hi = group.rows
    with node_block_scope(group):
        block, block_state, block_stats = agg.aggregate(
            own[lo:hi], bcast, adj[lo:hi], 0.0, {k: v[lo:hi] for k, v in state.items()},
            ctx(slice(lo, hi)))
    assert torch.equal(block, whole[lo:hi])
    for k, v in whole_state.items():
        assert torch.equal(block_state[k], v[lo:hi]), k
    np.testing.assert_array_equal(block_stats["acceptance_rate"],
                                  whole_stats["acceptance_rate"][lo:hi])
    # Each receiver accepted 4 of its 5 neighbours: the median is the third.
    np.testing.assert_array_equal(whole_stats["acceptance_rate"], torch.full((n,), 4.0) / 5.0)


@pytest.mark.parametrize("path", UNREFUSED)
def test_bundled_config_plans_no_refusal_over_a_node_axis(path):
    raw = yaml.safe_load((ROOT / path).read_text())
    raw["backend"] = "tpu"
    raw["tpu"] = {**(raw.get("tpu") or {}), "num_devices": 2, "param_shards": 1}
    cfg = Config.model_validate(raw)
    assert node_axis_sections(cfg) == []
    refuse_node_axis(cfg, "cpu")
