"""Param-axis sharding (tpu.param_shards) in the port, on the CPU.

- ``plan_param_layout``, ``padded_dim`` and ``make_sharded_flatteners``
  equal the JAX package's on a grid, refusals included; the pad columns are
  exact zeros.
- One spawned gloo group of 4 ranks (murmura_tpu_torch/parallel/launch.py)
  runs every case of tests/torch_sharding_cases.py, and the test process
  runs the same cases in one process on the padded flat vector:
  - the JAX package's tiny sharded round (tests/test_param_sharding.py
    ``_tiny_program``, Krum, UBAR and evidential trust, ``shard_step`` on
    a (1, 1, 4) mesh of the conftest's CPU devices), JAX's initial
    parameters carried over and its shuffle draw injected, against the
    port's 4-rank round: rtol 5e-5, atol 5e-6 (the JAX test's own
    tolerance), picks, stage rates and acceptances equal;
  - the probe forwards on one input, each rank handing in its column
    block: the dense cross-evaluation bit-equal to one process's (each
    model runs alone on every probe batch, as there), the circulant one
    and the self probe within float32 rounding (their forwards are
    vmapped over the rank's R_r models instead of all N, and torch's
    batched matmul rounds by batch size: one float32 ulp, 4.8e-7 on a
    Dirichlet strength of 5.2, measured);
  - each rule of {fedavg, Krum, median, trimmed mean, geometric median,
    BALANCE, Sketchguard, UBAR, evidential trust} x {allgather,
    ppermute}, and Krum pipelined,
    Krum under the adaptive bisection and Krum and the median on the
    sparse exchange, 2 rounds, sharded against unsharded: the decisions
    (picks, candidate counts, acceptance) equal, the float stats and
    parameters within a scaled 1e-4 (the sums over the shards run in
    another order);
  - sharded_model.yaml's levers on the tiny MLP through Network: against
    the unsharded run, fused dispatch against per round, and a snapshot
    after round 1 resumed bit-equal to the uninterrupted run; the
    carried [N, P] state as column blocks; a snapshot of another shard
    count refused both ways, in the JAX package's words;
  - the gang over the group (``build_gang_from_config``, core/gang.py):
    sharded_model.yaml's levers, the median under ppermute and Sketchguard
    against the port's unsharded gang (decisions equal, parameters within
    a scaled 1e-4); a member bit-equal to its single sharded run; JAX's
    gang over its ("seed", "nodes", "param") mesh
    (test_param_sharding.py's ``_cfg()`` with seeds [7, 8]), its members'
    initial parameters carried over and their draws injected, within rtol
    5e-5 / atol 5e-6; a snapshot after round 1 resumed bit-equal, and
    snapshots refused across shard counts and between a gang and a single
    run, both ways;
  - the collectives on uneven row blocks; no rank loads JAX;
  - last, rank 1 raises while the others wait in a collective: the launch
    ends with rank 1's traceback and nothing hangs.
- The refusals, in the JAX package's words: DMTT, top-k, an int8 block
  straddling a shard, population, ``backend: simulation``; and the port's
  own, by name: the frontier, the grid and the serve daemon over a param
  group.  ``unported_sections`` names nothing for a sweep, ``run --seeds``,
  UBAR and evidential trust.
"""

import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import torch_sharding_cases as cases
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.ops.flatten import make_sharded_flatteners, padded_dim
from murmura_tpu_torch.parallel.launch import GroupError, launch
from murmura_tpu_torch.parallel.mesh import plan_param_layout
from murmura_tpu_torch.utils.factories import (
    ConfigError,
    build_gang_from_config,
    build_network_from_config,
    unported_sections,
)



# Stats that are decisions: equal, not within a tolerance.
DECISIONS = ("agg_selected_index", "agg_selected_own", "agg_num_candidates",
             "agg_trimmed_per_side", "agg_num_neighbors", "agg_acceptance_rate",
             "agg_atk_accept", "agg_pipe_valid", "agg_alive", "agg_quarantined",
             "agg_attack_scrubbed", "agg_stale_used", "agg_stale_expired",
             "agg_stage1_acceptance_rate", "agg_stage2_acceptance_rate")
RULE_CASES = [{"rule": r, "exchange": e} for r in cases.RULES for e in ("allgather", "ppermute")]
EXTRA_CASES = [{"rule": "krum", "exchange": "ppermute", "pipeline": True},
               {"rule": "krum", "exchange": "allgather", "adaptive": True},
               # The exponential graph of 8 has 3 offsets: c = 0 < (4 - 2) / 2.
               {"rule": "krum", "exchange": "exponential", "params": {"num_compromised": 0}},
               {"rule": "median", "exchange": "exponential"}]


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not ref.size:
        return 0.0 if not got.size else float("inf")
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# layout and flatteners against the JAX package


@pytest.mark.parametrize("n,shards,n_dev", [(8, 4, 8), (6, 4, 6), (8, 1, 8), (16, 4, 4),
                                            (16, 4, 1), (16, 8, 8), (16, 4, 2), (3, 5, 7),
                                            (16, 3, 4)])
def test_plan_param_layout_matches_jax(n, shards, n_dev):
    from murmura_tpu.parallel.mesh import plan_param_layout as jax_plan

    try:
        ref = jax_plan(n, shards, n_dev)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            plan_param_layout(n, shards, n_dev)
        assert str(err.value) == str(e)
        return
    assert plan_param_layout(n, shards, n_dev) == ref


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7, 8])
def test_sharded_flatteners_match_jax(shards):
    import jax.numpy as jnp

    from murmura_tpu.ops.flatten import make_sharded_flatteners as jax_flatteners
    from murmura_tpu.ops.flatten import padded_dim as jax_padded

    rng = np.random.default_rng(shards)
    tree = {"w": rng.normal(size=(2, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    j_ravel, _, j_dim, j_flat = jax_flatteners(tree, shards)
    ravel, unravel, dim, flat = make_sharded_flatteners(
        {k: torch.from_numpy(v) for k, v in tree.items()}, shards)
    assert (dim, flat) == (j_dim, j_flat) == (11, jax_padded(11, shards))
    stacked = {k: torch.from_numpy(np.stack([v, 2 * v])) for k, v in tree.items()}
    rows = ravel(stacked, batch_dims=1)
    assert rows.shape == (2, flat)
    np.testing.assert_array_equal(rows[0].numpy(), np.asarray(j_ravel(
        {k: jnp.asarray(v) for k, v in tree.items()})))
    assert bool((rows[:, dim:] == 0).all())
    back = unravel(rows)
    for k, v in stacked.items():
        assert torch.equal(back[k], v)
    for d, m in ((11, 4), (12, 4), (1, 1), (414976, 4), (93, 8)):
        assert padded_dim(d, m) == jax_padded(d, m)
    with pytest.raises(ValueError, match="pad multiple"):
        padded_dim(3, 0)


# ---------------------------------------------------------------------------
# the group: every case in one spawned group of 4 gloo ranks


def _jax_tiny_spec(rule="krum"):
    """The JAX package's tiny sharded round of ``rule`` on a (1, 1, 4) mesh,
    from spread initial parameters: (its spec for the port, its whole [N,
    P] output, its metrics)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.analysis.ir import AGG_CASES
    from murmura_tpu.parallel.mesh import make_param_mesh, shard_step
    from test_param_sharding import _step_args, _tiny_program

    prog = _tiny_program(rule, param_shards=cases.SHARDS)
    n = prog.num_nodes
    rng = np.random.default_rng(cases.SEED)
    scale = 0.05 * (1.0 + np.arange(n) / n)

    def spread(a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape).astype(np.float32)
        return (a[:1] + scale.reshape((n,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)

    init = jax.tree_util.tree_map(spread, prog.init_params)
    mesh = make_param_mesh(n, cases.SHARDS, num_devices=cases.SHARDS)
    assert dict(mesh.shape) == {"seed": 1, "nodes": 1, "param": cases.SHARDS}
    step = shard_step(prog.train_step, prog, mesh, donate=False)
    args = list(_step_args(prog))
    args[0] = jax.tree_util.tree_map(jnp.asarray, init)
    params, _, metrics = step(*args)
    flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(params))
    # The round key's shuffle draw (core/rounds.py: split(key) -> train and
    # attack keys; split(train_key, local_epochs); split(epoch_key)).
    train_key, _ = jax.random.split(args[2])
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, prog.data_arrays["mask"].shape))
    spec = {"init": init, "u": u, "agg_params": dict(AGG_CASES[rule]), "rule": rule}
    return spec, flat, {k: np.asarray(v) for k, v in metrics.items()}


JAX_RULES = ("krum", "ubar", "evidential_trust")
GANG_SEEDS = [7, 9]


def _member_raw(raw, seed):
    """A gang member's single run: its seed, the attack placement pinned to
    the gang's (attack.params.seed: the base experiment seed)."""
    base = raw["experiment"]["seed"]
    return {**raw, "experiment": {**raw["experiment"], "seed": seed},
            "attack": {**raw["attack"], "params": {**raw["attack"]["params"], "seed": base}}}


def _jax_gang_spec():
    """The JAX package's gang over its ("seed", "nodes", "param") mesh
    (test_param_sharding.py ``_cfg()``, seeds [7, 8]), 2 rounds: (the port's
    spec with the members' initial parameters and draws, each member's
    whole [N, P] parameters after each round, the histories)."""
    import jax
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.config import Config as JaxConfig
    from murmura_tpu.utils.factories import build_gang_from_config as jax_gang
    from test_param_sharding import _raw

    raw = _raw()
    jgang = jax_gang(JaxConfig.model_validate(raw), seeds=[7, 8])
    assert jgang.mesh.axis_names == ("seed", "nodes", "param")
    assert dict(jgang.mesh.shape)["param"] == cases.SHARDS
    s_count = jgang.gang_size
    init = [jax.tree_util.tree_map(lambda a: np.asarray(a)[s], jgang.params)
            for s in range(s_count)]
    masks = np.asarray(jgang._data["mask"])
    draws, flats = [], []
    for r in range(2):
        round_draws = []
        for s, m in enumerate(jgang.members):
            key = jax.random.fold_in(jax.random.PRNGKey(m.seed), r)
            train_key, _ = jax.random.split(key)
            perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
            round_draws.append(
                {"u": [np.array(jax.random.uniform(perm_key, masks[s].shape))]})
        draws.append(round_draws)
        jgang.train(rounds=1)
        flats.append(np.asarray(jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))(
            jgang.params))[:s_count])
    spec = {"raw": raw, "seeds": [7, 8], "init": init, "draws": draws, "rounds": 2}
    return spec, flats, [dict(h) for h in jgang.histories]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, in the group and in one process.  The network cases'
    snapshots: the group's resume case writes one of 4 shards, which the
    test process reads back; the group refuses the test process's of 2."""
    tmp = tmp_path_factory.mktemp("sharding")
    jax_tiny = {rule: _jax_tiny_spec(rule) for rule in JAX_RULES}
    jax_gang_spec, jax_gang_flats, jax_gang_histories = _jax_gang_spec()
    two = build_network_from_config(Config.model_validate(
        cases.tiny_config(tpu={"param_shards": 2})), device="cpu")
    two.train(1)
    two.save_checkpoint(str(tmp / "snap2"))
    two_gang = build_gang_from_config(Config.model_validate(
        cases.tiny_config(tpu={"param_shards": 2})), seeds=GANG_SEEDS, device="cpu")
    two_gang.train(1)
    two_gang.save_checkpoint(str(tmp / "gang2"))
    levers = cases.tiny_config()
    mobility = cases.tiny_config(
        mobility={"area_size": 100.0, "comm_range": 45.0, "max_speed": 5.0, "seed": 3})
    for section in ("faults", "exchange"):
        mobility.pop(section)
    network_specs = {
        "resume": {"raw": levers, "rounds": 2, "resume": True,
                   "snapshot_dir": str(tmp / "snap4"), "refuse_dir": str(tmp / "snap2")},
        "fused": {"raw": levers, "rounds": 4, "rounds_per_dispatch": 2},
        "per_round": {"raw": levers, "rounds": 4},
        "mobility": {"raw": mobility, "rounds": 2},
        # A gang member's single sharded run.
        "member": {"raw": _member_raw(levers, GANG_SEEDS[1]), "rounds": 2},
    }
    gang_specs = {
        "levers": {"raw": levers, "seeds": GANG_SEEDS, "rounds": 2, "resume": True,
                   "snapshot_dir": str(tmp / "gang4"),
                   "refuse_dirs": {"shards": str(tmp / "gang2"), "single": str(tmp / "snap4")}},
        "median_ppermute": {"raw": cases.tiny_config(
            aggregation={"algorithm": "median", "params": {}}, tpu={"exchange": "ppermute"}),
            "seeds": GANG_SEEDS, "rounds": 2},
        "sketchguard": {"raw": cases.tiny_config(
            aggregation={"algorithm": "sketchguard", "params": {"sketch_size": 16}}),
            "seeds": GANG_SEEDS, "rounds": 2},
        "jax": jax_gang_spec,
    }
    plan = ([("jax_tiny", jax_tiny[r][0]) for r in JAX_RULES] + [("probe", {})]
            + [("rule", s) for s in RULE_CASES + EXTRA_CASES]
            + [("network", s) for s in network_specs.values()]
            + [("gang", s) for s in gang_specs.values()] + [("gather", {})])
    # The group's last act: rank 1 raises while the others wait in a
    # collective; the launch must end with rank 1's error, not hang.
    out = tmp / "ranks"
    out.mkdir()
    try:
        launch(cases.run_cases_then_fail, (plan, str(out), 1), world=cases.SHARDS,
               timeout_s=300)
        failure = None
    except GroupError as e:
        failure = str(e)
    if not all((out / f"rank{r}.pkl").exists() for r in range(cases.SHARDS)):
        raise AssertionError(f"the group failed before its cases ended:\n{failure}")
    group = [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(cases.SHARDS)]
    # The unsharded references (the resume case without its snapshot dir:
    # the group's snapshot stays for the refusals below).
    local_plan = [(k, {**s, "snapshot_dir": None, "refuse_dir": None, "refuse_dirs": None})
                  if k in ("network", "gang") else (k, s) for k, s in plan]
    local = cases.run_cases(local_plan)
    names = ([f"jax_tiny:{r}" for r in JAX_RULES] + ["probe"]
             + [_case_id(s) for s in RULE_CASES + EXTRA_CASES]
             + list(network_specs) + [f"gang:{k}" for k in gang_specs] + ["gather"])
    return {"group": dict(zip(names, group[0]["results"])),
            "local": dict(zip(names, local["results"])),
            "forbidden": [r["forbidden_modules"] for r in group],
            "gather": [r["results"][-1] for r in group],
            "jax": {r: v[1:] for r, v in jax_tiny.items()},
            "jax_gang": (jax_gang_flats, jax_gang_histories), "two_gang": two_gang,
            "tmp": tmp, "failure": failure}


def _case_id(spec):
    extra = "-".join(k for k in ("pipeline", "adaptive") if spec.get(k))
    return "-".join(filter(None, (spec["rule"], spec["exchange"], extra)))


def _assert_rounds_match(got_rounds, ref_rounds):
    for got, ref in zip(got_rounds, ref_rounds):
        assert set(got) == set(ref)
        for k in ref:
            if k in DECISIONS:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                assert _scaled(got[k], ref[k]) <= 1e-4, k


def test_jax_tiny_sharded_round_matches_jax_shard_step(runs):
    jax_flat, jax_metrics = runs["jax"]["krum"]
    got = runs["group"]["jax_tiny:krum"]
    dim = jax_flat.shape[1]
    assert got["flat_dim"] == padded_dim(dim, cases.SHARDS) > dim
    np.testing.assert_allclose(got["flat"][:, :dim], jax_flat, rtol=5e-5, atol=5e-6)
    assert not got["flat"][:, dim:].any()  # the pad stays exact zeros
    np.testing.assert_array_equal(got["metrics"]["agg_selected_index"],
                                  jax_metrics["agg_selected_index"])
    # Krum selected somewhere (c = 1 on the whole graph of 8).
    assert not got["metrics"]["agg_selected_own"].all()


@pytest.mark.parametrize("rule", ["ubar", "evidential_trust"])
def test_jax_tiny_probe_rule_round_matches_jax_shard_step(runs, rule):
    jax_flat, jax_metrics = runs["jax"][rule]
    got = runs["group"][f"jax_tiny:{rule}"]
    dim = jax_flat.shape[1]
    np.testing.assert_allclose(got["flat"][:, :dim], jax_flat, rtol=5e-5, atol=5e-6)
    assert not got["flat"][:, dim:].any()
    m = got["metrics"]
    decisions = (("agg_stage1_acceptance_rate", "agg_stage2_acceptance_rate")
                 if rule == "ubar" else ("agg_acceptance_rate",))
    for k in decisions:
        np.testing.assert_array_equal(m[k], jax_metrics[k], err_msg=k)
    for k, v in jax_metrics.items():
        if k not in decisions:
            np.testing.assert_allclose(m[k], v, rtol=5e-5, atol=5e-6, err_msg=k)
    if rule == "ubar":
        # Stage 1 shortlisted and stage 2 accepted somewhere.
        assert m["agg_stage1_acceptance_rate"].any() and m["agg_stage2_acceptance_rate"].any()


def test_probe_matrices_of_the_group_match_one_process(runs):
    got, ref = runs["group"]["probe"], runs["local"]["probe"]
    for k, v in ref["dense"].items():
        # Each model alone on every probe batch, as in one process: the bits.
        assert got["dense"][k].tobytes() == v.tobytes(), k
    assert ref["dense"]["vacuity"].shape == (cases.N, cases.N)
    assert ref["circulant"]["vacuity"].shape == (3, cases.N)
    for part in ("circulant", "self"):
        for k, v in ref[part].items():
            # Vmapped over the rank's models: float32 rounding of the
            # batched matmul, not a different evaluation.
            np.testing.assert_allclose(got[part][k], v, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("spec", RULE_CASES + EXTRA_CASES, ids=_case_id)
def test_rule_sharded_matches_unsharded(runs, spec):
    name = _case_id(spec)
    got, ref = runs["group"][name], runs["local"][name]
    assert got["flat"].shape == ref["flat"].shape == (cases.N, ref["flat_dim"])
    assert ref["flat_dim"] % cases.SHARDS == 0 and ref["flat_dim"] > ref["model_dim"]
    assert _scaled(got["flat"], ref["flat"]) <= 1e-4
    assert not got["flat"][:, ref["model_dim"]:].any()
    _assert_rounds_match(got["rounds"], ref["rounds"])
    if spec["rule"] == "krum":
        # Krum really selected: c = 1 < (5 - 2) / 2.
        assert any(not r["agg_selected_own"].all() for r in ref["rounds"])
    if spec.get("pipeline"):
        assert [float(r["agg_pipe_valid"]) for r in got["rounds"]] == [0.0, 1.0]


@pytest.mark.parametrize("name", ["levers", "median_ppermute", "sketchguard"])
def test_gang_over_the_group_matches_the_unsharded_gang(runs, name):
    got, ref = runs["group"][f"gang:{name}"], runs["local"][f"gang:{name}"]["run"]
    flat_dim = ref["flat"].shape[2]
    # Rank 0 carries its own 2 node rows of each of the 2 members.
    assert got["rows"] == (2, cases.N // cases.SHARDS, flat_dim)
    got = got["run"]
    assert got["flat"].shape == ref["flat"].shape == (2, cases.N, flat_dim)
    assert _scaled(got["flat"], ref["flat"]) <= 1e-4
    for g, r in zip(got["histories"], ref["histories"]):
        assert set(g) == set(r)
        for k, v in r.items():
            if k in DECISIONS or k in ("round", "agg_selected_index"):
                assert g[k] == v, k
            else:
                assert _scaled(g[k], v) <= 1e-4, k
    for k, v in ref["state"].items():
        assert got["state"][k].shape == v.shape, k
        assert _scaled(got["state"][k], v) <= 1e-4, k
    # The members are different experiments.
    assert not np.array_equal(ref["flat"][0], ref["flat"][1])


def test_gang_member_is_bit_equal_to_its_single_sharded_run(runs):
    gang, single = runs["group"]["gang:levers"]["run"], runs["group"]["member"]["run"]
    np.testing.assert_array_equal(gang["flat"][1], single["flat"])
    assert gang["histories"][1] == single["history"]
    for k, v in single["state"].items():
        np.testing.assert_array_equal(gang["state"][k][1], v, err_msg=k)


def test_sharded_gang_matches_the_jax_param_mesh_gang(runs):
    jax_flats, jax_histories = runs["jax_gang"]
    got = runs["group"]["gang:jax"]["run"]
    dim = jax_flats[-1].shape[2]
    np.testing.assert_allclose(got["flat"][:, :, :dim], jax_flats[-1], rtol=5e-5, atol=5e-6)
    assert not got["flat"][:, :, dim:].any()
    for g, ref in zip(got["histories"], jax_histories):
        assert set(g) == set(ref)
        for k, v in ref.items():
            if k in DECISIONS or k == "round":
                assert g[k] == v, k
            elif v:
                np.testing.assert_allclose(g[k], v, rtol=5e-5, atol=5e-6, err_msg=k)


def test_sharded_gang_resume_is_bit_equal(runs):
    got = runs["group"]["gang:levers"]
    assert got["restored_round"] == 1
    full, resumed = got["run"], got["resumed"]
    assert resumed["histories"] == full["histories"]
    np.testing.assert_array_equal(resumed["flat"], full["flat"])
    for k, v in full["state"].items():
        np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)


def test_gang_snapshots_refused_across_shard_counts_and_single_runs(runs):
    refused = runs["group"]["gang:levers"]["refused"]
    assert "tpu.param_shards=2" in refused["shards"] and "param_shards=4" in refused["shards"]
    assert "no gang section" in refused["single"]
    # The other ways: a gang of 2 shards and a single sharded run refuse
    # the group's gang snapshot.
    gang4 = str(runs["tmp"] / "gang4")
    with pytest.raises(ValueError, match="tpu.param_shards=4"):
        runs["two_gang"].restore_checkpoint(gang4)
    single = build_network_from_config(Config.model_validate(cases.tiny_config()), device="cpu")
    with pytest.raises(ValueError, match="gang"):
        single.restore_checkpoint(gang4)


@pytest.mark.parametrize("name", ["resume", "per_round", "mobility"])
def test_network_sharded_matches_unsharded(runs, name):
    got, ref = runs["group"][name]["run"], runs["local"][name]["run"]
    assert _scaled(got["flat"], ref["flat"]) <= 1e-4
    assert set(got["history"]) == set(ref["history"])
    for k, v in ref["history"].items():
        if k in DECISIONS or k == "round":
            assert got["history"][k] == v, k
        else:
            assert _scaled(got["history"][k], v) <= 1e-4, k
    for k, v in ref["state"].items():
        assert got["state"][k].shape == v.shape, k
        assert _scaled(got["state"][k], v) <= 1e-4, k


def test_carried_state_lives_as_column_blocks(runs):
    got = runs["group"]["resume"]
    assert set(got["sharded_keys"]) == {"compress_residual", "stale_cache"}
    width = runs["local"]["resume"]["run"]["flat"].shape[1] // cases.SHARDS
    assert all(shape == (cases.N, width) for shape in got["state_cols"].values())
    assert "agg_compress_error" in got["run"]["history"]
    assert max(got["run"]["history"]["agg_stale_used"]) > 0


def test_fused_dispatch_matches_per_round_sharded(runs):
    fused, per_round = runs["group"]["fused"]["run"], runs["group"]["per_round"]["run"]
    assert fused["history"] == per_round["history"]
    np.testing.assert_array_equal(fused["flat"], per_round["flat"])


def test_sharded_resume_is_bit_equal(runs):
    got = runs["group"]["resume"]
    assert got["restored_round"] == 1
    full, resumed = got["run"], got["resumed"]
    assert resumed["history"] == full["history"]
    np.testing.assert_array_equal(resumed["flat"], full["flat"])
    for k, v in full["state"].items():
        np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)


def test_snapshot_of_another_shard_count_is_refused(runs):
    # The group refused the 2-shard snapshot of the test process ...
    refused = runs["group"]["resume"]["refused"]
    assert refused is not None and "tpu.param_shards=2" in refused
    assert "param_shards=4" in refused
    # ... and an unsharded run and a 2-shard run refuse the group's.
    snap4 = str(runs["tmp"] / "snap4")
    for shards in (1, 2):
        reader = build_network_from_config(Config.model_validate(
            cases.tiny_config(tpu={"param_shards": shards},
                              compression={"algorithm": "none", "error_feedback": False}
                              if shards == 1 else {})),
            device="cpu")
        with pytest.raises(ValueError, match="param_shards") as err:
            reader.restore_checkpoint(snap4)
        assert "tpu.param_shards=4" in str(err.value)


def test_collectives_on_uneven_rows_and_no_rank_loads_jax(runs):
    # 7 nodes over 4 ranks: blocks of 1, 2, 2 and 2 rows.
    for rank in runs["gather"]:
        assert rank == {"cols": True, "rows": True, "gather_rows": True,
                        "gather_columns": True}
    assert runs["forbidden"] == [[]] * cases.SHARDS


def test_a_failing_rank_ends_the_group(runs):
    # The fixture's group ended with rank 1's deliberate error, its
    # traceback carried to the parent, while ranks 0, 2 and 3 waited in a
    # barrier that never completes.
    failure = runs["failure"]
    assert failure is not None
    assert "rank 1 of the param group failed" in failure
    assert "deliberate failure on rank 1" in failure


# ---------------------------------------------------------------------------
# refusals


def _jax_refusal(raw):
    from murmura_tpu.config import Config as JaxConfig

    with pytest.raises(Exception) as err:
        JaxConfig.model_validate(raw)
    return err


@pytest.mark.parametrize("what", ["dmtt", "topk", "population", "simulation"])
def test_schema_refusals_are_the_jax_packages(what):
    raw = cases.tiny_config()
    if what == "dmtt":
        raw.update(dmtt={"allow_static": True}, compression={"algorithm": "none"},
                   exchange={"max_staleness": 0})
    elif what == "topk":
        raw["compression"] = {"algorithm": "topk", "topk_ratio": 0.1}
    elif what == "population":
        raw.update(population={"enabled": True, "virtual_size": 64},
                   compression={"algorithm": "none"}, exchange={"max_staleness": 0})
    else:
        raw["backend"] = "simulation"
    ref = _jax_refusal(raw)
    with pytest.raises(type(ref.value)) as err:
        Config.model_validate(raw)
    expect = {"dmtt": "dmtt", "topk": "topk", "population": "population",
              "simulation": "backend"}[what]
    assert expect in str(err.value)
    # The same message, less pydantic's per-package header.
    assert str(err.value).splitlines()[1:] == str(ref.value).splitlines()[1:]


def test_round_program_refusals_are_the_jax_packages():
    from murmura_tpu.aggregation import build_aggregator as jax_agg
    from murmura_tpu.core.rounds import build_round_program as jax_build
    from murmura_tpu.dmtt.protocol import DMTTParams as JaxDMTT
    from murmura_tpu.models import make_mlp as jax_mlp
    from murmura_tpu.ops.compress import CompressionSpec as JaxSpec
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.dmtt.protocol import DMTTParams
    from murmura_tpu_torch.ops.compress import CompressionSpec

    from murmura_tpu.data.base import FederatedArrays as JaxArrays

    data = cases.tiny_data()
    jdata = JaxArrays(x=data.x, y=data.y, mask=data.mask, num_samples=data.num_samples,
                      num_classes=3)
    for kw, jkw, match in (
        ({"dmtt": DMTTParams()}, {"dmtt": JaxDMTT()}, "DMTT"),
        ({"compression": CompressionSpec("topk")}, {"compression": JaxSpec("topk")}, "topk"),
        ({"compression": CompressionSpec("int8", block=96)},
         {"compression": JaxSpec("int8", block=96)}, "shard-local"),
    ):
        with pytest.raises(ValueError, match=match) as ref:
            jax_build(jax_mlp(input_dim=6, hidden_dims=(9,), num_classes=3),
                      jax_agg("fedavg", {}), jdata, param_shards=4, **jkw)
        with pytest.raises(ValueError, match=match) as err:
            build_round_program(cases.tiny_model(), build_aggregator("fedavg", {}), data,
                                device="cpu", param_shards=4, **kw)
        assert str(err.value) == str(ref.value)


def test_factories_refuse_a_straddling_int8_block_as_jax_does():
    from murmura_tpu.config import Config as JaxConfig
    from murmura_tpu.utils.factories import ConfigError as JaxConfigError
    from murmura_tpu.utils.factories import build_network_from_config as jax_build

    raw = cases.tiny_config(compression={"block": 96})
    with pytest.raises(JaxConfigError) as ref:
        jax_build(JaxConfig.model_validate(raw))
    with pytest.raises(ConfigError) as err:
        build_network_from_config(Config.model_validate(raw), device="cpu")
    # The port refuses it once, in its round program, in the JAX round
    # program's words (test_round_program_refusals_are_the_jax_packages):
    # both name the block and the shard-local width, 160 / 4 columns.
    head = "compression.block=96 does not divide the shard-local flat width 40 ("
    assert str(ref.value).startswith(head)
    assert str(err.value).startswith(head) and "(flat_dim 160 over 4 param shards)" in str(
        err.value)


def test_a_group_wider_than_the_nodes_is_refused():
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.parallel.mesh import ParamGroup, set_process_group

    # Each rank trains its own node rows: 4 ranks over 3 nodes would leave
    # one with none (the JAX package trains every node on every device).
    group = ParamGroup(0, 4, "gloo", torch.device("cpu"))
    want = "a param group of 4 ranks needs at least 4 nodes .*, but there are 3"
    with pytest.raises(ValueError, match=want):
        build_round_program(cases.tiny_model(), build_aggregator("fedavg", {}),
                            cases.tiny_data(n=3), device="cpu", param_shards=4, group=group)
    raw = cases.tiny_config(topology={"num_nodes": 3, "k": 2})
    set_process_group(group)
    try:
        with pytest.raises(ConfigError, match=want):
            build_network_from_config(Config.model_validate(raw), device="cpu")
    finally:
        set_process_group(None)


def test_unported_sections_names_nothing_for_gangs_and_probe_rules():
    raw = cases.tiny_config()
    for variant in ({**raw, "sweep": {"num_seeds": 2}},
                    {**raw, "aggregation": {"algorithm": "ubar", "params": {}}},
                    {**raw, "aggregation": {"algorithm": "evidential_trust", "params": {}}}):
        assert unported_sections(Config.model_validate(variant)) == []
    sharded = yaml.safe_load(
        (Path(__file__).resolve().parents[1] / "examples" / "configs"
         / "sharded_model.yaml").read_text())
    assert unported_sections(Config.model_validate(sharded)) == []
    # ``run --seeds`` reaches the gang with no sweep block: it builds (here
    # in one process, on the padded flat vector).
    gang = build_gang_from_config(Config.model_validate(raw), seeds=[1, 2], device="cpu")
    assert gang.flats.shape == (2, cases.N, 160) and gang.group is None


@pytest.mark.parametrize("command", ["frontier", "grid", "serve"])
def test_commands_over_a_param_group_are_refused_by_name(command, tmp_path):
    """The frontier, the grid and the serve daemon run over a param group
    (tests/test_torch_seed_axis.py, tests/test_torch_serve_group.py), so
    none is refused at ``tpu.param_shards`` > 1.  A daemon built outside
    the param group its config plans is refused, and a daemon's tenant of
    another layout at submission, in words naming both layouts."""
    from murmura_tpu_torch.serve.daemon import ServeDaemon, SubmissionError, normalize_submission
    from murmura_tpu_torch.serve.scheduler import plan_grid
    from murmura_tpu_torch.utils.factories import check_serve_plan, serve_plan

    raw = cases.tiny_config()
    if command == "serve":
        daemon = Config.model_validate({**raw, "serve": {"state_dir": str(tmp_path)}})
        with pytest.raises(ConfigError, match=re.escape(
                "the daemon's config plans a param group of 4 (layout (seed, nodes, param) "
                "(1, 1, 4)) at 4 lanes, and the daemon runs one process")):
            ServeDaemon(daemon, device="cpu")
        running = serve_plan(daemon, 4, "cpu")
        normalize_submission(raw, check=lambda c: check_serve_plan(c, 4, "cpu", running))
        with pytest.raises(SubmissionError, match=re.escape(
                "the tenant plans a param group of 2 (layout (seed, nodes, param) (1, 1, 2)) "
                "at 4 lanes, and the daemon runs a param group of 4")):
            normalize_submission(cases.tiny_config(tpu={"param_shards": 2}),
                                 check=lambda c: check_serve_plan(c, 4, "cpu", running))
        return
    # Its gangs are laid over a param group of 4, as the daemon's are.
    assert serve_plan(Config.model_validate(raw), 4, "cpu")[1:] == ("param", 4)
    # The same config is planned at four shards and at one.
    if command == "grid":
        assert plan_grid(Config.model_validate(raw))
        assert plan_grid(Config.model_validate(cases.tiny_config(tpu={"param_shards": 1})))
