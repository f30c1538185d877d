"""The node axis in the port (``backend: tpu`` over W ranks of a node group),
on the CPU.

- ``window_frame`` cuts the offsets at their largest circular gap;
  ``plan_layout`` gives a node axis of every planned device at
  ``tpu.param_shards: 1`` (on the CPU ``tpu.num_devices``, else 1), and a
  node count the axis does not divide is refused in the JAX package's words
  (its ``shard_step`` on ``make_mesh(3)``).
- One spawned gloo group of 4 ranks (``launch(..., axis="nodes")``) runs
  every case of tests/torch_node_axis_cases.py, and the test process runs
  the same cases in one process:
  - the JAX package's tiny round (tests/test_param_sharding.py
    ``_tiny_program``, ``_step_args``) of Krum, fedavg, the median and the
    geometric median through ``make_mesh(4)`` and ``shard_step`` on the
    conftest's CPU devices, and Krum's two rounds fused through
    ``shard_multi_round``, JAX's initial parameters carried over and its
    shuffle draws injected, against the port's 4-rank rounds: rtol 5e-5,
    atol 5e-6 (the JAX test's own tolerance), Krum's picks equal;
  - each rule of {fedavg, Krum, median, trimmed mean, geometric median,
    BALANCE, Sketchguard} x {allgather, ppermute}, Krum and the median on
    the sparse exchange, and Krum with its audit taps, 2 rounds, over the
    group against one process: the decisions (picks, candidate counts,
    acceptance, the taps) equal, the float stats and parameters within a
    scaled 1e-4; on this CPU they are bit-equal but for the dense geometric
    median (its centre is the whole network's mean summed over the ranks
    in another order), and the test says which;
  - the flagship's levers (Krum under a gaussian attack, chaos_churn.yaml's
    faults with a NaN-emitting node) on the tiny MLP
    through Network: per round and fused against one process, fused
    bit-equal to per round, and a snapshot after round 1 resumed bit-equal
    to the uninterrupted run; a snapshot of another node-axis width
    refused both ways;
  - the exchange: under ppermute and the sparse exchange a rank receives
    exactly its window's rows each round (the collective's received rows
    counted), under allgather the whole [N, P]; the window plan on N = 12
    over 4 ranks at the exponential offsets, where rank 0 receives rows of
    rank 2, which is not its neighbour;
  - no rank loads JAX or the JAX package.
- ``train_row_block`` (a fixed row count a launch, what keeps a node
  block's training bit-equal to one process's on the card, ROADMAP Queue
  C 2) is bit-equal to training every row at once on this CPU.
- The refusals: every section the node axis does not run, by name, at a
  node axis above 1 (the round program's and the config's; the probe rules
  and the row-reading attacks run there, tests/test_torch_node_axis_probe.py),
  and the daemon
  over a node axis (a gang, the frontier and the grid follow their gang
  plan instead); and none at a node axis of 1.
"""

import numpy as np
import pytest
import torch

import torch_node_axis_cases as cases
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.parallel.launch import launch
from murmura_tpu_torch.parallel.mesh import NodeGroup, plan_layout, window_frame
from murmura_tpu_torch.utils.factories import (
    ConfigError,
    build_gang_from_config,
    build_network_from_config,
    node_axis_sections,
    refuse_node_axis,
)

# Stats that are decisions: equal, not within a tolerance.
DECISIONS = ("agg_selected_index", "agg_selected_own", "agg_num_candidates",
             "agg_trimmed_per_side", "agg_num_neighbors", "agg_acceptance_rate",
             "agg_alive", "agg_quarantined", "agg_attack_scrubbed", "agg_tap_selected_by",
             "agg_tap_considered_by", "agg_tap_quarantined", "agg_tap_alive",
             "agg_tap_attack_scrubbed")
RULE_CASES = [{"rule": r, "exchange": e} for r in cases.RULES for e in ("allgather", "ppermute")]
EXTRA_CASES = [
    # The exponential graph of 8 has 3 offsets: c = 0 < (4 - 2) / 2.
    {"rule": "krum", "exchange": "exponential", "params": {"num_compromised": 0}},
    {"rule": "median", "exchange": "exponential"},
    {"rule": "krum", "exchange": "allgather", "audit": True},
    {"rule": "krum", "exchange": "ppermute", "audit": True},
]
# Where the group and one process differ in the last bits on this CPU: the
# dense geometric median's centre is the block sums' all_reduce over N.
NOT_BIT_EQUAL = ("geometric_median-allgather",)
JAX_RULES = ("krum", "fedavg", "median", "geometric_median")


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not ref.size:
        return 0.0 if not got.size else float("inf")
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _case_id(spec):
    return "-".join(filter(None, (spec["rule"], spec["exchange"],
                                  "audit" if spec.get("audit") else "")))


# ---------------------------------------------------------------------------
# layout


@pytest.mark.parametrize("n,offsets,signed,low,high", [
    (16, [1, 2, 14, 15], {1: 1, 2: 2, 14: -2, 15: -1}, -2, 2),
    (16, [1, 2, 4, 8], {1: 1, 2: 2, 4: 4, 8: 8}, 0, 8),
    (12, [1, 2, 4, 8], {1: 1, 2: 2, 4: 4, 8: -4}, -4, 4),
    (8, [1, 2, 6, 7], {1: 1, 2: 2, 6: -2, 7: -1}, -2, 2),
    (8, [7], {7: -1}, -1, 0),
])
def test_window_frame_takes_the_shortest_window(n, offsets, signed, low, high):
    got, lo, hi = window_frame(n, offsets)
    assert (lo, hi) == (low, high)
    assert {o: got[o] for o in offsets} == signed and got[0] == 0


@pytest.mark.parametrize("n_dev,device", [(1, "cpu"), (2, "cpu"), (4, "cpu"), (None, "cpu")])
def test_plan_layout_gives_the_node_axis(n_dev, device):
    layout, devices = plan_layout(16, 1, device, n_dev)
    want = 1 if n_dev is None else n_dev
    assert layout == (1, want, 1) and devices == want


def test_node_count_the_axis_does_not_divide_is_refused_in_jax_words():
    from murmura_tpu.parallel.mesh import make_mesh, shard_step
    from test_param_sharding import _tiny_program

    prog = _tiny_program("krum")
    with pytest.raises(ValueError) as jax_err:
        shard_step(prog.train_step, prog, make_mesh(3), donate=False)
    raw = cases.tiny_config(tpu={"param_dtype": "float32", "num_devices": 3})
    with pytest.raises(ConfigError) as err:
        build_network_from_config(Config.model_validate(raw), device="cpu")
    assert str(err.value) == str(jax_err.value) == "num_nodes=8 not divisible by mesh node axis 3"


# ---------------------------------------------------------------------------
# the group: every case in one spawned node group of 4 gloo ranks


def _spread(a, n, rng):
    a = np.asarray(a)
    scale = 0.05 * (1.0 + np.arange(n) / n)
    noise = rng.normal(size=a.shape).astype(np.float32)
    return (a[:1] + scale.reshape((n,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)


def _u_draw(key, mask_shape):
    """The round key's shuffle draw (core/rounds.py: split(key) -> train and
    attack keys; split(train_key, local_epochs); split(epoch_key))."""
    import jax

    train_key, _ = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    return np.array(jax.random.uniform(perm_key, mask_shape))


def _jax_tiny_spec(rule):
    """The JAX package's tiny round of ``rule`` on a node mesh of 4, from
    spread initial parameters: (its spec for the port, its whole [N, P]
    output, its metrics)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.analysis.ir import AGG_CASES
    from murmura_tpu.parallel.mesh import make_mesh, shard_step
    from test_param_sharding import _step_args, _tiny_program

    prog = _tiny_program(rule)
    n = prog.num_nodes
    rng = np.random.default_rng(cases.SEED)
    init = jax.tree_util.tree_map(lambda a: _spread(a, n, rng), prog.init_params)
    mesh = make_mesh(cases.WORLD)
    assert dict(mesh.shape) == {"nodes": cases.WORLD}
    step = shard_step(prog.train_step, prog, mesh, donate=False)
    args = list(_step_args(prog))
    args[0] = jax.tree_util.tree_map(jnp.asarray, init)
    params, _, metrics = step(*args)
    flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(params))
    spec = {"init": init, "u": _u_draw(args[2], prog.data_arrays["mask"].shape),
            "agg_params": dict(AGG_CASES[rule]), "rule": rule}
    return spec, flat, {k: np.asarray(v) for k, v in metrics.items()}


def _jax_fused_krum():
    """JAX's Krum, 2 rounds fused by ``build_multi_round`` and laid on the
    node mesh of 4 by ``shard_multi_round``: (the port's spec, JAX's whole
    [N, P] output, its picks a round)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.analysis.ir import AGG_CASES
    from murmura_tpu.core.rounds import build_multi_round
    from murmura_tpu.parallel.mesh import make_mesh, shard_multi_round
    from test_param_sharding import _step_args, _tiny_program

    prog = _tiny_program("krum")
    n = prog.num_nodes
    rng = np.random.default_rng(cases.SEED + 1)
    init = jax.tree_util.tree_map(lambda a: _spread(a, n, rng), prog.init_params)
    fused = shard_multi_round(build_multi_round(prog, 2, 1), prog, make_mesh(cases.WORLD),
                              donate=False)
    args = list(_step_args(prog))
    base_key, adj = args[2], args[3]
    params, _, rows = fused(jax.tree_util.tree_map(jnp.asarray, init), args[1], base_key,
                            jnp.stack([adj, adj]), args[4], jnp.asarray(0, jnp.int32), args[6])
    flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(params))
    mask_shape = prog.data_arrays["mask"].shape
    u = [_u_draw(jax.random.fold_in(base_key, r), mask_shape) for r in range(2)]
    spec = {"init": init, "u_rounds": u, "agg_params": dict(AGG_CASES["krum"]),
            "rule": "krum"}
    return spec, flat, np.asarray(rows["agg_selected_index"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, in the group and in one process.  The resume case's
    snapshot is the group's, which the test process must refuse; the
    group refuses the test process's (a node axis of 1)."""
    tmp = tmp_path_factory.mktemp("node_axis")
    jax_tiny = {rule: _jax_tiny_spec(rule) for rule in JAX_RULES}
    jax_fused = _jax_fused_krum()
    one = cases.tiny_config(tpu={"num_devices": None})
    net = build_network_from_config(Config.model_validate(one), device="cpu")
    net.train(1)
    net.save_checkpoint(str(tmp / "snap1"))
    levers = cases.tiny_config()
    network_specs = {
        "resume": {"raw": levers, "rounds": 2, "resume": True,
                   "snapshot_dir": str(tmp / "snap4"), "refuse_dir": str(tmp / "snap1")},
        "per_round": {"raw": levers, "rounds": 4},
        "fused": {"raw": levers, "rounds": 4, "rounds_per_dispatch": 2},
        "ppermute": {"raw": cases.tiny_config(tpu={"exchange": "ppermute"}), "rounds": 2},
    }
    exchange_specs = {"exponential12": {"num_nodes": 12, "offsets": [1, 2, 4, 8]},
                      "allgather12": {"num_nodes": 12}}
    plan = ([("jax_tiny", jax_tiny[r][0]) for r in JAX_RULES]
            + [("jax_tiny", jax_fused[0])]
            + [("rule", s) for s in RULE_CASES + EXTRA_CASES]
            + [("network", s) for s in network_specs.values()]
            + [("exchange", s) for s in exchange_specs.values()])
    group = launch(cases.run_cases, (plan,), world=cases.WORLD, axis="nodes", timeout_s=300)
    local_plan = [(k, {**s, "snapshot_dir": None, "refuse_dir": None})
                  if k == "network" else (k, s) for k, s in plan]
    local = cases.run_cases(local_plan)
    names = ([f"jax:{r}" for r in JAX_RULES] + ["jax:fused"]
             + [_case_id(s) for s in RULE_CASES + EXTRA_CASES]
             + list(network_specs) + list(exchange_specs))
    return {"group": [dict(zip(names, g["results"])) for g in group],
            "local": dict(zip(names, local["results"])),
            "forbidden": [g["forbidden_modules"] for g in group],
            "jax": {r: v[1:] for r, v in jax_tiny.items()}, "jax_fused": jax_fused[1:],
            "tmp": tmp}


@pytest.mark.parametrize("rule", JAX_RULES)
def test_jax_tiny_round_matches_jax_shard_step(runs, rule):
    jax_flat, jax_metrics = runs["jax"][rule]
    got = runs["group"][0][f"jax:{rule}"]
    np.testing.assert_allclose(got["flat"], jax_flat, rtol=5e-5, atol=5e-6)
    for k, v in jax_metrics.items():
        if k in ("agg_selected_index", "agg_num_candidates"):
            np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["metrics"][k], v, rtol=5e-5, atol=5e-6, err_msg=k)
    if rule == "krum":
        # Krum selected somewhere (c = 1 on the whole graph of 8).
        assert not got["metrics"]["agg_selected_own"].all()


def test_jax_fused_krum_matches_jax_shard_multi_round(runs):
    jax_flat, jax_picks = runs["jax_fused"]
    got = runs["group"][0]["jax:fused"]
    np.testing.assert_allclose(got["flat"], jax_flat, rtol=5e-5, atol=5e-6)
    np.testing.assert_array_equal(np.stack([r["agg_selected_index"] for r in got["rounds"]]),
                                  jax_picks)


@pytest.mark.parametrize("spec", RULE_CASES + EXTRA_CASES, ids=_case_id)
def test_rule_over_the_node_axis_matches_one_process(runs, spec):
    name = _case_id(spec)
    got, ref = runs["group"][0][name], runs["local"][name]
    assert got["rows"][0] == cases.N // cases.WORLD and ref["rows"][0] == cases.N
    assert got["flat"].shape == ref["flat"].shape
    for g, r in zip(got["rounds"], ref["rounds"]):
        assert set(g) == set(r)
        for k in r:
            if k in DECISIONS:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                assert _scaled(g[k], r[k]) <= 1e-4, k
    assert _scaled(got["flat"], ref["flat"]) <= 1e-4
    # Bit-equal on this CPU, but for the case that is named.
    assert (got["flat"].tobytes() == ref["flat"].tobytes()) == (name not in NOT_BIT_EQUAL)
    if spec["rule"] == "krum":
        assert any(not r["agg_selected_own"].all() for r in ref["rounds"])
    if spec.get("audit"):
        assert "agg_tap_selected_by" in ref["rounds"][0]


@pytest.mark.parametrize("spec", RULE_CASES + EXTRA_CASES, ids=_case_id)
def test_a_rank_receives_only_its_window(runs, spec):
    """Each round one exchange: under allgather every rank's rows (N), under
    ppermute and the sparse exchange the rank's block plus the window's
    high - low rows, and nothing else."""
    for rank, res in enumerate(runs["group"]):
        counts = res[_case_id(spec)]["exchange"]
        r = cases.N // cases.WORLD
        if spec["exchange"] == "allgather":
            per_round = cases.N
        elif spec["exchange"] == "ppermute":
            per_round = r + 4  # offsets 1, 2, 6, 7: the window -2 .. +2
        else:
            per_round = r + 4  # offsets 1, 2, 4: the window 0 .. +4
        assert counts["calls"] == 2 and counts["rows"] == 2 * per_round, rank
        assert counts["rows_from_others"] == 2 * (per_round - r), rank


def test_window_plan_on_uneven_layouts(runs):
    """N = 12 over 4 ranks at the exponential offsets (signed -4 .. +4): the
    window of rank 0 takes rows 8-11 of ranks 2 and 3 and rows 3-6 of ranks
    1 and 2, and each rank receives exactly its window's ids."""
    want = {0: [8, 9, 10, 11, 0, 1, 2, 3, 4, 5, 6], 1: [11] + list(range(10)),
            2: list(range(2, 12)) + [0], 3: list(range(5, 12)) + [0, 1, 2, 3]}
    for rank, res in enumerate(runs["group"]):
        got = res["exponential12"]
        assert got["window"] == want[rank]
        assert got["ids"] == [float(x) for x in want[rank]]
        assert got["counts"]["rows"] == 11 and got["counts"]["rows_from_others"] == 8
        assert "rank 0: 8-11,0-6; rank 1: 11,0-9" in got["describe"]
        whole = res["allgather12"]
        assert whole["ids"] == [float(x) for x in range(12)] and whole["window"] is None
        assert whole["counts"]["rows_from_others"] == 9


def _assert_history_match(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k in DECISIONS or k == "round":
            assert got[k] == v, k
        else:
            assert _scaled(got[k], v) <= 1e-4, k


@pytest.mark.parametrize("name", ["per_round", "fused", "ppermute"])
def test_levers_through_network_match_one_process(runs, name):
    got, ref = runs["group"][0][name], runs["local"][name]
    assert got["rows"][0] == cases.N // cases.WORLD
    run, ref_run = got["run"], ref["run"]
    assert run["flat"].shape == ref_run["flat"].shape
    assert _scaled(run["flat"], ref_run["flat"]) <= 1e-4
    _assert_history_match(run["history"], ref_run["history"])
    for k, v in ref_run["state"].items():
        np.testing.assert_array_equal(run["state"][k], v, err_msg=k)
    hist = run["history"]
    # The faults bit: a crash, and node 2's NaN quarantined while alive.
    assert min(hist["agg_alive"]) < cases.N and max(hist["agg_quarantined"]) >= 1
    # Every other rank returns no state (rank 0 writes).
    assert all(g[name]["run"] is None for g in runs["group"][1:])


def test_fused_dispatch_is_bit_equal_to_per_round(runs):
    fused, per = runs["group"][0]["fused"]["run"], runs["group"][0]["per_round"]["run"]
    assert fused["flat"].tobytes() == per["flat"].tobytes()
    assert fused["history"] == per["history"]


def test_snapshot_resumes_bit_equal_and_other_widths_are_refused(runs):
    got = runs["group"][0]["resume"]
    assert got["restored_round"] == 1
    assert got["resumed"]["flat"].tobytes() == got["run"]["flat"].tobytes()
    assert got["resumed"]["history"] == got["run"]["history"]
    # The group refuses the one-process snapshot ...
    assert "node axis of 1 ranks but this run has a node axis of 4" in got["refused"]
    # ... and one process refuses the group's.
    net = build_network_from_config(
        Config.model_validate(cases.tiny_config(tpu={"num_devices": None})), device="cpu")
    with pytest.raises(ValueError, match="node axis of 4 ranks but this run has a node "
                                         "axis of 1"):
        net.restore_checkpoint(str(runs["tmp"] / "snap4"))


def test_no_rank_loads_jax(runs):
    assert runs["forbidden"] == [[]] * cases.WORLD


# ---------------------------------------------------------------------------
# refusals


REFUSED_SECTIONS = {
    "compression": {"compression": {"algorithm": "int8", "block": 8}},
    "exchange.max_staleness": {"exchange": {"max_staleness": 2}},
    "exchange.pipeline": {"exchange": {"pipeline": True}, "faults": {"enabled": False}},
    "population": {"population": {"enabled": True, "virtual_size": 32}},
}


@pytest.mark.parametrize("name", sorted(REFUSED_SECTIONS))
def test_each_unported_section_is_refused_by_name_over_a_node_axis(name):
    try:
        cfg = Config.model_validate(cases.tiny_config(**REFUSED_SECTIONS[name]))
    except Exception as e:  # the schema's own refusal of a combination
        pytest.fail(f"{name}: the tiny config does not validate: {e}")
    assert any(s.startswith(name) for s in node_axis_sections(cfg))
    with pytest.raises(ConfigError, match="over a node axis above 1") as err:
        build_network_from_config(cfg, device="cpu")
    assert name in str(err.value)
    # A node axis of 1 refuses nothing new.
    one = Config.model_validate(cases.tiny_config(**REFUSED_SECTIONS[name],
                                                  tpu={"num_devices": None}))
    refuse_node_axis(one, "cpu")


@pytest.mark.parametrize("what", ["compression", "bounded staleness",
                                  "the pipelined round", "tpu.param_shards > 1"])
def test_the_round_program_refuses_by_name_on_a_node_group(what):
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.core.stale import StalenessSpec
    from murmura_tpu_torch.ops.compress import CompressionSpec

    model = cases.tiny_model()
    kw = {"compression": dict(compression=CompressionSpec(algorithm="int8", block=8)),
          "bounded staleness": dict(staleness=StalenessSpec(
              max_staleness=1, discount=0.5, base_mask=np.ones((cases.N, cases.N), np.float32))),
          "the pipelined round": dict(pipeline=True),
          "tpu.param_shards > 1": dict(param_shards=2)}[what]
    agg = build_aggregator("krum", {"num_compromised": 1})
    group = NodeGroup(0, cases.WORLD, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="the node axis does not run these yet") as err:
        build_round_program(model, agg, cases.tiny_data(), device="cpu", group=group, **kw)
    assert what in str(err.value)


def test_gangs_frontier_grid_and_daemon_are_refused_over_a_node_axis(tmp_path):
    """A gang, the frontier, the grid and the serve daemon follow their own
    gang plan (a seed group, tests/test_torch_seed_axis.py and
    tests/test_torch_serve_group.py), so a planned node axis refuses none of
    them; built in a process outside a group, a gang runs there whole.  A
    daemon built outside the seed group its config plans is refused, its
    words naming the planned group, its layout and the one process it
    found."""
    from murmura_tpu_torch.serve.daemon import ServeDaemon
    from murmura_tpu_torch.serve.scheduler import plan_grid

    cfg = Config.model_validate(cases.tiny_config())
    gang = build_gang_from_config(cfg, seeds=[7, 8], device="cpu")
    assert gang.seed_group is None and tuple(gang.flats.shape[:2]) == (2, cases.N)
    if torch.cuda.is_available():
        pytest.skip("plan_grid and the daemon plan on the visible cards here")
    assert plan_grid(cfg)
    serve = Config.model_validate(cases.tiny_config(serve={"state_dir": str(tmp_path)}))
    with pytest.raises(ConfigError, match=r"the daemon's config plans a seed group of 4 \(layout "
                                          r"\(seed, nodes, param\) \(4, 1, 1\)\) at 4 lanes, and "
                                          r"the daemon runs one process"):
        ServeDaemon(serve, device="cpu")


# ---------------------------------------------------------------------------
# training at a fixed row count


@pytest.mark.parametrize("block", [1, 3, 8, 20])
def test_train_row_block_is_the_same_math(block):
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.core.rounds import build_round_program, round_generators

    model = cases.tiny_model()
    runs = []
    for rows in (None, block):
        prog = build_round_program(
            model, build_aggregator("krum", {"num_compromised": 1}), cases.tiny_data(),
            batch_size=8, lr=0.05, seed=cases.SEED, init_params=cases.spread_init(model),
            device="cpu", train_row_block=rows)
        flat, state = prog.init_flat, prog.init_agg_state
        adj = torch.ones((cases.N, cases.N)) - torch.eye(cases.N)
        for r in range(2):
            flat, state, _ = prog.train_step(flat, state, adj, torch.zeros(cases.N), float(r),
                                             generators=round_generators(cases.SEED, r, "cpu"))
        runs.append(flat)
    assert torch.equal(runs[0], runs[1])


def test_train_row_block_refuses_zero():
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.core.rounds import build_round_program

    with pytest.raises(ValueError, match="train_row_block must be >= 1"):
        build_round_program(cases.tiny_model(), build_aggregator("krum", {}), cases.tiny_data(),
                            device="cpu", train_row_block=0)
