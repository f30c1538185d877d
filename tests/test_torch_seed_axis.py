"""The seed axis in the port (a gang over W ranks of a seed group), on the
CPU.

- ``plan_gang_layout`` is the JAX package's ``make_gang_mesh`` policy: the
  same (seed, nodes) shape on a table of (batch, N, devices), JAX's own
  cases (tests/test_gang.py ``test_make_gang_mesh_layouts``) among them,
  and the same words for an impossible plan; the CLI's layout line names
  the axis that runs and the factor it leaves unused.
- One spawned gloo group of 4 ranks (``launch(..., axis="seed")``) runs
  every case of tests/torch_seed_axis_cases.py, and the test process runs
  the same cases as the one-process gang:
  - the JAX package's ``GangNetwork`` on a ("seed", "nodes") mesh of 4
    forced host devices (``backend: tpu``, ``tpu.num_devices: 4``) for
    Krum dense, Krum circulant and the median circulant, 4 members and 2
    rounds, JAX's initial parameters carried over and its members' draws
    injected: picks equal, parameters within a scaled 1e-4 (the gang row
    of PERF.md §2), the history's decisions equal;
  - the gang of the tiny flagship-shaped config under chaos_churn.yaml's
    faults: 4 members over 4 ranks (per round, with telemetry: one writer
    a member on the rank that trains it), 6 members over 4 (uneven
    blocks, fused 2-round chunks), 3 members at batch 4 over 4 (rank 0
    holds none): every member's history and parameters bit-equal to the
    one-process gang's (measured on this CPU, so no tolerance is taken);
  - durability: the group's snapshot after round 1 byte-equal to the
    one-process gang's (the state payload; the history in its meta equal),
    and a gang resumed across layouts (written by the group of 4, resumed
    in one process, and the reverse) bit-equal to the uninterrupted run;
  - the frontier (one Krum cell, 2 strengths and the benign member x 2
    seeds, 2 stages) and the grid (Krum and the median, under gaussian
    and no attack: buckets of 4 and of 2 members, so ranks with no
    member) over the group: the artifact and the manifest equal the
    one-process run's key for key apart from the walls, and each rank's
    ``compiles`` equals the one-process count;
  - the frontier and the grid over a param group: the same ranks re-bound
    as a param group of 4 (``tpu.param_shards: 4``, tests/
    torch_sharding_cases.py's tiny MLP) run a frontier cell (Krum x
    adaptive gaussian x dense, 2 strengths and the benign member, 2 stages
    of 2 rounds: the stage reset runs over the group) and a grid of one
    Krum bucket (2 strengths x 2 seeds): each gang's members bit-equal to
    each member's single sharded run (a one-member gang of the same
    config) over the same group, as a sharded gang's member is; against
    the same commands at ``tpu.param_shards: 1`` in one process the
    artifact's and the manifest's keys and decisions equal, the members'
    parameters and histories within a scaled 1e-4 (PERF.md §2, row 58; the
    dense Krum score 1e-3); and the cell's and the bucket's gangs against
    the JAX package's gangs of the same configs on its ("seed", "nodes",
    "param") mesh of 4 forced host devices, JAX's initial parameters
    carried over and its draws injected: picks equal, parameters and
    histories within rtol 5e-5 / atol 5e-6 (JAX's own sharding tests');
  - no rank loads JAX or the JAX package.
- The serve daemon at a seed axis above 1 and at ``tpu.param_shards`` > 1
  runs only in its planned group (tests/test_torch_serve_group.py): built
  outside it, it is refused in words naming both layouts, as a tenant of
  another layout is; a gang whose plan has seed 1 and a node factor above 1
  runs in one process.
"""

import numpy as np
import pytest
import torch

import torch_seed_axis_cases as cases
import torch_sharding_cases as sharding
from murmura_tpu_torch import cli
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.ops.flatten import padded_dim
from murmura_tpu_torch.parallel.launch import launch
from murmura_tpu_torch.parallel.mesh import plan_gang_layout
from murmura_tpu_torch.utils.factories import ConfigError, build_gang_from_config

DECISIONS = ("round", "agg_selected_index", "agg_selected_own", "agg_num_candidates",
             "agg_alive", "agg_quarantined", "agg_attack_scrubbed", "agg_atk_accept")
SEEDS4 = [7, 8, 9, 10]
SEEDS6 = [7, 8, 9, 10, 11, 12]
SEEDS3 = [7, 8, 9]
JAX_CASES = (("krum", "allgather"), ("krum", "ppermute"), ("median", "ppermute"))


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# layout


LAYOUTS = [(2, 4, 8), (8, 20, 8), (2, 16, 8), (3, 8, 8), (3, 7, 8), (4, 8, 4), (8, 8, 4),
           (4, 16, 2), (1, 16, 1), (4, 16, 1), (16, 16, 4), (2, 8, 8), (4, 6, 8)]


@pytest.mark.parametrize("batch,n,n_dev", LAYOUTS)
def test_plan_gang_layout_is_jax_make_gang_mesh(batch, n, n_dev):
    from murmura_tpu.parallel.mesh import make_gang_mesh

    try:
        ref = dict(make_gang_mesh(batch, n, n_dev).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            plan_gang_layout(batch, n, n_dev)
        assert str(err.value) == str(e)
        return
    assert plan_gang_layout(batch, n, n_dev) == (ref["seed"], ref["nodes"])


@pytest.mark.parametrize("tpu,lanes,group,want", [
    ({"num_devices": 4}, 4, (4, "seed"),
     "seed layout (seed, nodes, param) (4, 1, 1) over 4 cpu device(s): 4 ranks of a seed "
     "group over gloo, each holding a block of whole members"),
    ({"num_devices": 4}, 2, (2, "seed"),
     "seed layout (seed, nodes, param) (2, 2, 1) over 4 cpu device(s): 2 ranks of a seed "
     "group over gloo, each holding a block of whole members; the node axis of 2 goes unused "
     "(the port runs one axis at a time)"),
    ({"num_devices": 8}, 3, (1, "seed"),
     "seed layout (seed, nodes, param) (1, 8, 1) over 8 cpu device(s): one process; the node "
     "axis of 8 goes unused (the port runs one axis at a time)"),
    ({"num_devices": 8, "param_shards": 2}, 4, (2, "param"),
     "param layout (seed, nodes, param) (4, 1, 2) over 8 cpu device(s): 2 ranks over gloo; "
     "the seed axis of 4 goes unused (the port runs one axis at a time)"),
])
def test_the_layout_line_names_the_axis_and_what_goes_unused(tpu, lanes, group, want,
                                                              capsys):
    raw = cases.gang_config(tpu=tpu, sweep={"seeds": list(range(1, lanes + 1)),
                                            "bucket": lanes != 3})
    assert cli._gang_layout(Config.model_validate(raw), torch.device("cpu"), lanes) == group
    assert capsys.readouterr().out.strip() == want


def test_an_impossible_gang_plan_is_refused_in_jax_words():
    from murmura_tpu.parallel.mesh import make_gang_mesh

    with pytest.raises(ValueError) as jax_err:
        make_gang_mesh(3, 7, 8)
    raw = cases.gang_config(topology={"num_nodes": 7}, tpu={"num_devices": 8},
                            sweep={"seeds": [1, 2, 3], "bucket": False})
    with pytest.raises(ConfigError) as err:
        cli._gang_layout(Config.model_validate(raw), torch.device("cpu"), 3)
    assert str(err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# the group: every case in one spawned seed group of 4 gloo ranks


def _jax_gang_spec(rule, exchange):
    """The JAX package's gang of 4 members over its ("seed", "nodes") mesh of
    4 forced host devices, 2 rounds: (the port's spec with the members'
    initial parameters and draws, each member's whole [N, P] parameters
    after the last round, the histories)."""
    import jax
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.config import Config as JaxConfig
    from murmura_tpu.utils.factories import build_gang_from_config as jax_gang

    raw = cases.gang_config(tpu={"exchange": exchange})
    raw.pop("faults")
    if rule != "krum":
        raw["aggregation"] = {"algorithm": rule, "params": {}}
    jgang = jax_gang(JaxConfig.model_validate(raw), seeds=SEEDS4)
    assert dict(jgang.mesh.shape) == {"seed": 4, "nodes": 1}
    s_count = jgang.gang_size
    init = [jax.tree_util.tree_map(lambda a: np.asarray(a)[s], jgang.params)
            for s in range(s_count)]
    masks = np.asarray(jgang._data["mask"])
    comp = int(np.asarray(jgang.compromised).sum())
    p = int(np.asarray(jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))(
        jgang.params)).shape[-1])
    draws = []
    for r in range(2):
        round_draws = []
        for s, m in enumerate(jgang.members):
            key = jax.random.fold_in(jax.random.PRNGKey(m.seed), r)
            train_key, attack_key = jax.random.split(key)
            perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
            round_draws.append({"u": [np.array(jax.random.uniform(perm_key, masks[s].shape))],
                                "noise": np.array(jax.random.normal(attack_key, (comp, p)))})
        draws.append(round_draws)
        jgang.train(rounds=1)
    flat = np.asarray(jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))(jgang.params))[:s_count]
    spec = {"raw": raw, "seeds": SEEDS4, "init": init, "draws": draws, "rounds": 2}
    return spec, flat, [dict(h) for h in jgang.histories]


def _frontier_raw():
    raw = cases.gang_config()
    raw["frontier"] = {"rules": ["krum"], "attacks": ["gaussian"], "topologies": ["dense"],
                       "points": 2, "seeds": [7, 8], "stages": 2, "rounds": 2}
    return raw


def _grid_raw():
    raw = cases.gang_config()
    raw["grid"] = {"rules": ["krum", "median"], "attacks": ["gaussian", "none"],
                   "topologies": ["dense"], "strengths": [0.5, 1.0], "seeds": [7, 8],
                   "rounds": 2}
    return raw


def _param_base(shards=cases.WORLD):
    raw = sharding.tiny_config(tpu={"param_shards": shards},
                               attack={"params": {"noise_std": 1.0}})
    for section in ("faults", "exchange", "compression"):
        raw.pop(section)
    return raw


PARAM_FRONTIER = {"rules": ["krum"], "attacks": ["gaussian"], "topologies": ["dense"],
                  "points": 2, "seeds": [7], "stages": 2, "rounds": 2}
PARAM_GRID = {"rules": ["krum"], "attacks": ["gaussian"], "topologies": ["dense"],
              "strengths": [0.5, 1.0], "seeds": [7, 8], "rounds": 2}


def _param_raw(command, shards=cases.WORLD):
    return {**_param_base(shards),
            command: PARAM_FRONTIER if command == "frontier" else PARAM_GRID}


def _jax_param_spec(kind):
    """The JAX package's gang of the frontier cell's (stage 0) or the grid
    bucket's config on its param mesh of 4 forced host devices, 2 rounds:
    (the port's gang spec, each member's whole [N, P] after the last round,
    the histories)."""
    import jax
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.config import Config as JaxConfig
    from murmura_tpu.utils.factories import build_gang_from_config as jax_gang

    base = _param_base()
    raw = {**base, "tpu": {**base["tpu"], "num_devices": cases.WORLD}}
    if kind == "frontier":
        from murmura_tpu.frontier import _cell_config, _geom_grid, _members_for

        jcfg = JaxConfig.model_validate({**raw, "frontier": PARAM_FRONTIER})
        f = jcfg.frontier
        strengths = [0.0] + _geom_grid(f.strength_lo, f.strength_hi, f.points)
        cfg = _cell_config(jcfg, f, "krum", "gaussian", "dense",
                           members=_members_for(strengths, f.seeds))
    else:
        from murmura_tpu.serve.scheduler import plan_grid

        (bucket,) = plan_grid(JaxConfig.model_validate({**raw, "grid": PARAM_GRID}))
        cfg = bucket.config
    jgang = jax_gang(cfg)
    assert dict(jgang.mesh.shape)["param"] == cases.WORLD
    s_count = jgang.gang_size
    init = [jax.tree_util.tree_map(lambda a: np.asarray(a)[s], jgang.params)
            for s in range(s_count)]
    masks = np.asarray(jgang._data["mask"])
    comp = int(np.asarray(jgang.compromised).sum())
    # The noise covers the padded flat width, as the param mesh's round draws it.
    dim = padded_dim(int(np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(
        jax.tree_util.tree_map(lambda a: a[0], jgang.params))).shape[-1]), cases.WORLD)
    draws = []
    for r in range(2):
        round_draws = []
        for s, m in enumerate(jgang.members):
            key = jax.random.fold_in(jax.random.PRNGKey(m.seed), r)
            train_key, attack_key = jax.random.split(key)
            perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
            round_draws.append({"u": [np.array(jax.random.uniform(perm_key, masks[s].shape))],
                                "noise": np.array(jax.random.normal(attack_key, (comp, dim)))})
        draws.append(round_draws)
        jgang.train(rounds=1)
    flat = np.asarray(jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))(jgang.params))[:s_count]
    port_raw = cfg.model_dump()
    port_raw["tpu"].pop("num_devices")
    spec = {"raw": port_raw, "init": init, "draws": draws, "rounds": 2}
    return spec, flat, [dict(h) for h in jgang.histories]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, as the one-process gang in the test process and in the
    group.  The durability case's one-process run writes its snapshot
    first, which the group resumes; the group's, which the test process
    resumes after."""
    tmp = tmp_path_factory.mktemp("seed_axis")
    jax = {c: _jax_gang_spec(*c) for c in JAX_CASES}
    jax_param = {k: _jax_param_spec(k) for k in ("frontier", "grid")}
    raw = cases.gang_config()
    gang_specs = {
        "even": {"raw": raw, "seeds": SEEDS4, "rounds": 2},
        "uneven_fused": {"raw": raw, "seeds": SEEDS6, "rounds": 4, "rounds_per_dispatch": 2},
        "empty_rank": {"raw": raw, "seeds": SEEDS3, "rounds": 2},
    }
    group_tel, one_tel = str(tmp / "tel_group"), str(tmp / "tel_one")
    durability = {"raw": raw, "seeds": SEEDS6, "rounds": 2}
    one_durable = cases.gang_case({**durability, "snapshot_dir": str(tmp / "snap_one")})
    plan = ([("gang", jax[c][0]) for c in JAX_CASES]
            + [("gang", {**s, "telemetry": group_tel if k == "even" else None})
               for k, s in gang_specs.items()]
            + [("gang", {**durability, "snapshot_dir": str(tmp / "snap_group"),
                         "resume_from": str(tmp / "snap_one")})]
            + [("frontier", {"raw": _frontier_raw()}), ("grid", {"raw": _grid_raw()})])
    param_plan = [("param:frontier_gangs", {"raw": _param_raw("frontier"), "singles": True}),
                  ("param:grid_gangs", {"raw": _param_raw("grid"), "singles": True}),
                  ("param:gang", jax_param["frontier"][0]), ("param:gang", jax_param["grid"][0])]
    group = launch(cases.run_cases, (plan + param_plan,), world=cases.WORLD, axis="seed",
                   timeout_s=300)
    local_plan = ([("gang", jax[c][0]) for c in JAX_CASES]
                  + [("gang", {**s, "telemetry": one_tel if k == "even" else None})
                     for k, s in gang_specs.items()]
                  + [("gang", {**durability, "resume_from": str(tmp / "snap_group")})]
                  + plan[-2:]
                  + [("frontier_gangs", {"raw": _param_raw("frontier", 1)}),
                     ("grid_gangs", {"raw": _param_raw("grid", 1)})])
    local = cases.run_cases(local_plan)
    names = ([f"jax:{r}-{e}" for r, e in JAX_CASES] + list(gang_specs)
             + ["durability", "frontier", "grid", "p:frontier", "p:grid", "p:jax:frontier",
                "p:jax:grid"])
    return {"group": [dict(zip(names, g["results"])) for g in group],
            "local": dict(zip(names, local["results"])),
            "forbidden": [g["forbidden_modules"] for g in group],
            "jax": {f"jax:{r}-{e}": v[1:] for (r, e), v in jax.items()},
            "jax_param": {f"p:jax:{k}": v[1:] for k, v in jax_param.items()},
            "one_durable": one_durable, "tmp": tmp, "tel": (group_tel, one_tel)}


@pytest.mark.parametrize("case", [f"jax:{r}-{e}" for r, e in JAX_CASES])
def test_seed_group_matches_the_jax_gang_on_a_seed_mesh(runs, case):
    jax_flat, jax_histories = runs["jax"][case]
    got = runs["group"][0][case]
    assert [g[case]["block"] for g in runs["group"]] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    dim = jax_flat.shape[2]
    assert got["run"]["flat"].shape[:2] == jax_flat.shape[:2]
    assert _scaled(got["run"]["flat"][:, :, :dim], jax_flat) <= 1e-4
    for g, ref in zip(got["histories"], jax_histories):
        assert set(g) == set(ref)
        for k, v in ref.items():
            if k in DECISIONS:
                assert g[k] == v, k
            elif v:
                assert _scaled(g[k], v) <= (1e-3 if k == "agg_krum_score" else 1e-4), k
    if case.startswith("jax:krum"):
        # Krum selected somewhere (c = 1 < (5 - 2) / 2).
        assert any(own < 1 for h in got["histories"] for own in h["agg_selected_own"])


@pytest.mark.parametrize("name,blocks", [
    ("even", [(0, 1), (1, 2), (2, 3), (3, 4)]),
    ("uneven_fused", [(0, 1), (1, 3), (3, 4), (4, 6)]),
    ("empty_rank", [(0, 0), (0, 1), (1, 2), (2, 3)]),
])
def test_seed_group_is_bit_equal_to_the_one_process_gang(runs, name, blocks):
    ranks = [g[name] for g in runs["group"]]
    ref = runs["local"][name]
    assert [r["block"] for r in ranks] == blocks
    assert [r["local"] for r in ranks] == [hi - lo for lo, hi in blocks]
    assert "seed group: world 4, backend gloo" in ranks[0]["describe"]
    got = ranks[0]["run"]
    assert all(r["run"] is None for r in ranks[1:])
    assert got["flat"].shape == ref["run"]["flat"].shape
    assert got["flat"].tobytes() == ref["run"]["flat"].tobytes()
    for k, v in ref["run"]["state"].items():
        assert got["state"][k].tobytes() == v.tobytes(), k
    # Every rank records every member's history, the one-process gang's.
    for r in ranks:
        assert r["histories"] == ref["histories"]
        # Each rank built the chunk programs the one-process gang built.
        assert r["builds"] == ref["builds"] and r["batch"] == ref["batch"]
    hist = ref["histories"]
    assert min(min(h["agg_alive"]) for h in hist) < cases.N
    assert max(max(h["agg_quarantined"]) for h in hist) >= 1
    # The members are different experiments.
    assert hist[0]["mean_loss"] != hist[1]["mean_loss"]


def test_each_member_writes_its_telemetry_on_its_rank(runs):
    import json
    from pathlib import Path

    group_tel, one_tel = runs["tel"]
    assert [g["even"]["writers"] for g in runs["group"]] == [1, 1, 1, 1]
    assert runs["local"]["even"]["writers"] == 4
    for label in (f"seed_{s}" for s in SEEDS4):
        rounds = []
        for root in (group_tel, one_tel):
            events = [json.loads(line) for line in
                      (Path(root) / label / "events.jsonl").read_text().splitlines()]
            rounds.append([e["round"] for e in events if e.get("type") == "round"])
        assert rounds[0] == rounds[1] == [1, 2], (label, rounds)


def test_the_snapshot_is_the_one_process_gangs_and_resumes_across_layouts(runs):
    group = cases.snapshot_bytes(runs["tmp"] / "snap_group")
    one = cases.snapshot_bytes(runs["tmp"] / "snap_one")
    assert group["state"] == one["state"]
    assert group["history"] == one["history"]
    assert group["extra_meta"] == one["extra_meta"]
    full = runs["one_durable"]
    # Written in one process, resumed over the group of 4 ...
    got = runs["group"][0]["durability"]
    assert got["restored_round"] == 1
    assert got["resumed"]["flat"].tobytes() == full["run"]["flat"].tobytes()
    assert got["resumed_histories"] == full["histories"]
    for k, v in full["run"]["state"].items():
        assert got["resumed"]["state"][k].tobytes() == v.tobytes(), k
    # ... and written by the group, resumed in one process.
    back = runs["local"]["durability"]
    assert back["restored_round"] == 1
    assert back["resumed"]["flat"].tobytes() == full["run"]["flat"].tobytes()
    assert back["resumed_histories"] == full["histories"]
    # The group's uninterrupted run is the one-process run.
    assert got["run"]["flat"].tobytes() == full["run"]["flat"].tobytes()


_WALLS = ("wall_s", "bucket_wall_s", "mean_round_s")


def test_the_frontier_over_the_group_is_the_one_process_artifact(runs):
    ref = runs["local"]["frontier"]
    for g in runs["group"]:
        assert cases.without(g["frontier"], ("compiles",)) == cases.without(ref, ("compiles",))
        assert [c["compiles"] for c in g["frontier"]["cells"]] == \
            [c["compiles"] for c in ref["cells"]]
    cell = ref["cells"][0]
    assert cell["stages"] == 2 and len(cell["curve"]) >= 3
    assert all(rec["adaptive"] for rec in cell["curve"] if rec["strength"] > 0)


def test_the_grid_over_the_group_is_the_one_process_manifest(runs):
    ref = runs["local"]["grid"]
    assert [b["gang_size"] for b in ref["buckets"]] == [4, 2, 4, 2]
    for g in runs["group"]:
        got = g["grid"]
        assert cases.without(got, _WALLS) == cases.without(ref, _WALLS)
        assert got["total_compiles"] == ref["total_compiles"]


_PARAM_WALLS = ("compiles", "wall_s", "bucket_wall_s", "mean_round_s", "total_compiles",
                "key", "bucket")


@pytest.mark.parametrize("kind", ["frontier", "grid"])
def test_param_group_members_are_bit_equal_to_their_single_sharded_runs(runs, kind):
    _, gangs = runs["group"][0][f"p:{kind}"]
    assert len(gangs) == 1
    gang = gangs[0]
    assert len(gang["singles"]) == len(gang["labels"]) >= 3
    for s, single in enumerate(gang["singles"]):
        assert single["history"] == gang["histories"][s], gang["labels"][s]
        assert single["run"]["flat"][0].tobytes() == gang["run"]["flat"][s].tobytes()
        for k, v in single["run"]["state"].items():
            assert v[0].tobytes() == gang["run"]["state"][k][s].tobytes(), k
    # Every rank holds the same artifact (its own walls); the other ranks
    # return no state.
    for g in runs["group"][1:]:
        assert cases.without(g[f"p:{kind}"][0], _PARAM_WALLS) == \
            cases.without(runs["group"][0][f"p:{kind}"][0], _PARAM_WALLS)
        assert g[f"p:{kind}"][1][0]["run"] is None


@pytest.mark.parametrize("kind", ["frontier", "grid"])
def test_param_group_matches_the_command_at_one_shard(runs, kind):
    got_art, (got,) = runs["group"][0][f"p:{kind}"]
    ref_art, (ref,) = runs["local"][f"p:{kind}"]
    assert got["labels"] == ref["labels"]
    dim = ref["run"]["flat"].shape[2]
    assert got["run"]["flat"].shape[2] >= dim and not got["run"]["flat"][:, :, dim:].any()
    assert _scaled(got["run"]["flat"][:, :, :dim], ref["run"]["flat"]) <= 1e-4
    for g, r in zip(got["histories"], ref["histories"]):
        assert set(g) == set(r)
        for k, v in r.items():
            if k in DECISIONS:
                assert g[k] == v, k
            elif v:
                # The dense Krum score sums a Gram identity's column-block
                # partials in another order: 1e-3, as PERF.md §2's gang row.
                assert _scaled(g[k], v) <= (1e-3 if k == "agg_krum_score" else 1e-4), k
    # The artifact's and the manifest's keys, and what they decide, equal.
    assert (cases.without(got_art, _PARAM_WALLS).keys()
            == cases.without(ref_art, _PARAM_WALLS).keys())
    if kind == "frontier":
        (gc,), (rc,) = got_art["cells"], ref_art["cells"]
        assert gc["stages"] == rc["stages"] == 2
        assert [p["strength"] for p in gc["curve"]] == [p["strength"] for p in rc["curve"]]
        assert gc["breaking_point"] == rc["breaking_point"]
    else:
        assert [c["id"] for c in got_art["cells"]] == [c["id"] for c in ref_art["cells"]]


@pytest.mark.parametrize("kind", ["frontier", "grid"])
def test_param_group_gang_matches_the_jax_param_mesh_gang(runs, kind):
    jax_flat, jax_histories = runs["jax_param"][f"p:jax:{kind}"]
    got = runs["group"][0][f"p:jax:{kind}"]
    dim = jax_flat.shape[2]
    np.testing.assert_allclose(got["run"]["flat"][:, :, :dim], jax_flat, rtol=5e-5, atol=5e-6)
    assert not got["run"]["flat"][:, :, dim:].any()
    picked = False
    for g, ref in zip(got["histories"], jax_histories):
        assert set(g) == set(ref)
        for k, v in ref.items():
            if k in DECISIONS:
                assert g[k] == v, k
            elif v:
                np.testing.assert_allclose(g[k], v, rtol=5e-5, atol=5e-6, err_msg=k)
        picked |= any(own < 1 for own in g["agg_selected_own"])
    assert picked


def test_no_rank_loads_jax(runs):
    assert runs["forbidden"] == [[]] * cases.WORLD


# ---------------------------------------------------------------------------
# refusals


def test_the_daemon_is_refused_over_a_seed_axis_by_name(tmp_path, capsys):
    """The daemon over a seed axis runs in the seed group ``serve`` plans
    at its capacity (tests/test_torch_serve_group.py); built outside that
    group it is refused, and so is a tenant of another layout, in words
    naming both layouts."""
    from murmura_tpu_torch.serve.daemon import ServeDaemon
    from murmura_tpu_torch.utils.factories import check_serve_plan, serve_plan

    if torch.cuda.is_available():
        pytest.skip("the daemon plans on the visible cards here")
    serve = Config.model_validate(cases.gang_config(serve={"state_dir": str(tmp_path)}))
    assert cli._gang_layout(serve, torch.device("cpu"), serve.serve.capacity) == (4, "seed")
    assert "4 ranks of a seed group over gloo" in capsys.readouterr().out
    with pytest.raises(ConfigError, match=r"the daemon's config plans a seed group of 4 \(layout "
                                          r"\(seed, nodes, param\) \(4, 1, 1\)\) at 4 lanes, and "
                                          r"the daemon runs one process"):
        ServeDaemon(serve, device="cpu")
    running = serve_plan(serve, 4, "cpu")
    tenant = Config.model_validate(cases.gang_config(tpu={"num_devices": 2}))
    with pytest.raises(ConfigError, match=r"the tenant plans a seed group of 2 .* and the daemon "
                                          r"runs a seed group of 4"):
        check_serve_plan(tenant, 4, "cpu", running)


def test_the_daemon_stays_refused_over_a_param_group(tmp_path):
    """The daemon at ``tpu.param_shards: 4`` runs in a param group of 4
    (tests/test_torch_serve_group.py); built outside it, it is refused in
    words naming both layouts, and so is a tenant at one shard."""
    from murmura_tpu_torch.serve.daemon import ServeDaemon
    from murmura_tpu_torch.utils.factories import check_serve_plan, serve_plan

    cfg = Config.model_validate({**_param_base(), "serve": {"state_dir": str(tmp_path)}})
    with pytest.raises(ConfigError, match=r"the daemon's config plans a param group of 4 .* "
                                          r"and the daemon runs one process"):
        ServeDaemon(cfg, device="cpu")
    running = serve_plan(cfg, 4, "cpu")
    assert running[1:] == ("param", 4)
    with pytest.raises(ConfigError, match=r"the tenant plans one process .* and the daemon runs "
                                          r"a param group of 4"):
        check_serve_plan(Config.model_validate(_param_base(1)), 4, "cpu", running)


def test_a_gang_planned_at_seed_one_runs_in_one_process(capsys):
    """3 members (no bucket) of 8 nodes on 8 devices: (1, 8), the JAX
    package's node-sharded gang; the port prints the unused node factor and
    runs the gang in one process."""
    raw = cases.gang_config(tpu={"num_devices": 8}, sweep={"seeds": SEEDS3, "bucket": False})
    raw["experiment"]["rounds"] = 1
    cfg = Config.model_validate(raw)
    assert cli._gang_layout(cfg, torch.device("cpu"), 3) == (1, "seed")
    assert "one process; the node axis of 8 goes unused" in capsys.readouterr().out
    gang = build_gang_from_config(cfg, device="cpu")
    assert gang.seed_group is None and gang.flats.shape[0] == 3
    assert [h["round"] for h in gang.train(1)] == [[1]] * 3
