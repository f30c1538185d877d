"""The serve daemon over a seed group and over a param group, on the CPU.

One spawned gloo group of 2 ranks (``launch(..., axis="seed")``) runs every
daemon case of tests/torch_serve_group_cases.py, its ranks re-bound as a
param group for the param cases; the test process runs the one-process
daemon of the same submissions and the JAX references:

- a daemon over the seed group at capacity 4 (the tiny flagship-shaped
  tenants at ``tpu.num_devices: 2``) drains generations of 4, 3 (uneven:
  one tenant on rank 0, two on rank 1) and 1 tenant (rank 0 holds none):
  every tenant's history, and the gang's whole state, bit-equal to the
  one-process daemon's (measured on this CPU, so no tolerance is taken);
  generations 2 and 3 build nothing on either rank;
- an eviction requested on rank 0 after round 1 of generation 2 freezes
  the lane (held on rank 1) before round 2 on both ranks, and the
  survivors are bit-equal to the run without it;
- the same generations with the JAX members' initial parameters and draws
  (the daemon's member programs and training patched in the ranks) against
  the JAX package's ``GangNetwork`` on its ("seed", "nodes") mesh of 2
  forced host devices (its daemon draws its own initial parameters, which
  the port cannot match): picks equal, parameters and histories within a
  scaled 1e-4 (the dense Krum score 1e-3), the gang row of PERF.md §2;
- a daemon over the param group at ``tpu.param_shards: 2``: each tenant
  bit-equal to its single sharded run (a one-member gang of the same
  config over the group); killed on every rank after round 1 and recovered
  from its snapshot, bit-equal again; with JAX's initial parameters and
  draws, within rtol 5e-5 / atol 5e-6 of the JAX package's gang on its
  ("seed", "nodes", "param") mesh of 2 forced host devices (JAX's own
  sharding tests' tolerance);
- an idle daemon over a param group of 2 (a second spawn, whose collective
  timeout is cut to IDLE_TIMEOUT_S) outlives three timeouts, then serves a
  generation through rank 0's socket (submit, status, list, evict, ping,
  metrics, shutdown);
- ``serve`` at ``tpu.num_devices: 2 --device cpu`` in a subprocess: three
  attacked tenants through its socket, SIGKILLed after its first snapshot:
  its socket answers no one and within 30 s none of its ranks is alive;
  ``serve`` restarted on the same state dir (``cli.serve`` in a thread of
  the test process, which spares a second interpreter's boot) recovers the
  killed generation, and every history equals the uninterrupted group
  daemon's;
- a tenant whose layout is not the daemon's is refused at submission, in
  words naming both; no rank loads JAX or the JAX package.

The three groups (the cases' group, the idle group and the subprocess's)
run at once, beside the JAX references in the test process.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

import torch_serve_group_cases as cases
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.ops.flatten import padded_dim
from murmura_tpu_torch.parallel.launch import launch
from murmura_tpu_torch.serve.daemon import SubmissionError, normalize_submission
from murmura_tpu_torch.serve.protocol import send_request

ROOT = Path(__file__).resolve().parents[1]
DECISIONS = ("round", "agg_selected_index", "agg_selected_own", "agg_num_candidates",
             "agg_alive", "agg_quarantined", "agg_attack_scrubbed", "agg_atk_accept")
SEEDS = [s for s, _ in cases.TENANTS]
# Generations of one bucket at capacity 4: 4 tenants, then 3 (lane 1
# evicted after round 1 in the real run), then 1.
GENERATIONS = ([7, 8, 9, 10], [10, 8, 7], [9])
EVICTED = (1, 1)  # (generation, lane)
PARAM_SEEDS = [7, 8]
CLI_ROUNDS = 8
IDLE_TIMEOUT_S = 5.0


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _jax_reference(group):
    """The JAX package's generation of the tenants of ``group`` ("seed": the
    four, at ``tpu.num_devices: 2``; "param": two at ``tpu.param_shards:
    2``) as its daemon runs one: the first tenant's one-member gang at
    ``min_batch`` of the tenant count on its mesh of 2 forced host devices,
    re-tenanted with each tenant's program (``build_gang_member_programs``
    of its own config, its seed and lr), 2 rounds: (the members' initial
    parameters and draws by seed, each member's whole [N, P] after the last
    round and its history by seed).  A member depends on its own program
    alone, so one generation of every tenant covers every generation of
    the port's."""
    import jax
    from jax.flatten_util import ravel_pytree

    from murmura_tpu.config import Config as JaxConfig
    from murmura_tpu.core.gang import GangMember as JaxMember
    from murmura_tpu.utils.factories import build_gang_from_config as jax_gang
    from murmura_tpu.utils.factories import build_gang_member_programs as jax_programs

    seeds = SEEDS if group == "seed" else PARAM_SEEDS

    def config(seed, sweep=False):
        raw = cases.tenant(seed, group)
        raw["tpu"] = {**raw["tpu"], "num_devices": cases.WORLD}
        if sweep:
            raw["sweep"] = {"members": [{"seed": seed, "lr": cases.LRS[seed]}]}
        return JaxConfig.model_validate(raw)

    jgang = jax_gang(config(seeds[0], sweep=True), min_batch=len(seeds))
    members = [JaxMember(seed=s, lr=cases.LRS[s]) for s in seeds]
    jgang.reset_run(members, member_programs=[jax_programs(config(s), [m])[0]
                                              for s, m in zip(seeds, members)])
    mesh = dict(jgang.mesh.shape)
    assert mesh["seed" if group == "seed" else "param"] == cases.WORLD, mesh
    s_count = jgang.gang_size
    init = {m.seed: jax.tree_util.tree_map(lambda a: np.asarray(a)[s], jgang.params)
            for s, m in enumerate(jgang.members)}
    masks = np.asarray(jgang._data["mask"])
    comp = int(np.asarray(jgang.compromised).sum())
    flat_of = jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))
    dim = int(np.asarray(flat_of(jgang.params)).shape[-1])
    if group == "param":
        # The noise covers the padded flat width, as the param mesh's round draws it.
        dim = padded_dim(dim, cases.WORLD)
    draws = {m.seed: [] for m in jgang.members}
    for r in range(2):
        for s, m in enumerate(jgang.members):
            key = jax.random.fold_in(jax.random.PRNGKey(m.seed), r)
            train_key, attack_key = jax.random.split(key)
            perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
            draws[m.seed].append({
                "u": [np.array(jax.random.uniform(perm_key, masks[s].shape))],
                "noise": np.array(jax.random.normal(attack_key, (comp, dim)))})
        jgang.train(rounds=1)
    flat = np.asarray(flat_of(jgang.params))[:s_count]
    return ({"init": init, "draws": draws},
            {m.seed: flat[s] for s, m in enumerate(jgang.members)},
            {m.seed: dict(h) for m, h in zip(jgang.members, jgang.histories)})


def _seed_spec(state, group="seed", **extra):
    return {"daemon": cases.daemon_raw(state, 4, group),
            "generations": [[cases.tenant(s, group) for s in g] for g in GENERATIONS],
            **extra}


def _param_spec(state, **extra):
    return {"daemon": cases.daemon_raw(state, 2, "param"),
            "generations": [[cases.tenant(s, "param") for s in PARAM_SEEDS]], **extra}


def _in_thread(fn, *args, **kwargs):
    """Run ``fn`` in a thread; returns a function that joins it and returns
    its value (or raises its exception)."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised by the joiner
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


def _wait(pred, seconds, what):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _answers(sock) -> bool:
    try:
        return send_request(str(sock), {"op": "ping"}, timeout=2.0, retries=0)["ok"]
    except Exception:  # noqa: BLE001 — nothing answers
        return False


def _status(sock, sub_id):
    return send_request(str(sock), {"op": "status", "id": sub_id})["submission"]


def _serve(cfg, log):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-m", "murmura_tpu_torch", "serve", str(cfg),
                             "--device", "cpu"], cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def _serve_in_thread(cfg):
    """``serve`` (cli.serve, the command's entry point) of ``cfg`` in a
    thread of this process: it launches the daemon's group of 2 and returns
    at its shutdown.  Returns a function that joins it and returns what it
    printed."""
    import contextlib
    import io

    from murmura_tpu_torch import cli

    def run():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.serve(cfg, device="cpu")
        return printed.getvalue()

    return _in_thread(run)


def _cli_kill_and_restart(tmp):
    """``serve`` of a seed-group daemon (capacity 2, CLI_ROUNDS rounds,
    checkpoint_every 1) in a subprocess: three attacked tenants through its
    socket, SIGKILLed once the first generation's first snapshot is on
    disk; then ``serve`` again on the same state dir (in a thread here,
    while the killed process's ranks are watched) until every tenant is
    done."""
    state = tmp / "cli_state"
    cfg = tmp / "serve.yaml"
    cfg.write_text(yaml.safe_dump(cases.daemon_raw(state, 2, rounds=CLI_ROUNDS)))
    sock = state / "daemon.sock"
    out = {}
    with open(tmp / "serve1.log", "w") as log:
        proc = _serve(cfg, log)
        _wait(lambda: _answers(sock) or proc.poll() is not None, 180, "serve to listen")
        assert proc.poll() is None, (tmp / "serve1.log").read_text()[-3000:]
        ids = []
        for s in SEEDS[:3]:
            raw = cases.tenant(s)
            raw["experiment"]["rounds"] = CLI_ROUNDS
            ids.append(send_request(str(sock), {"op": "submit", "config": raw})["id"])
        _wait(lambda: list(state.glob("buckets/*/gen_1/meta.json")), 180,
              "the first snapshot")
        ranks = cases.children(proc.pid)
        out["ranks"] = ranks
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
    out["answers_after_kill"] = _answers(sock)
    out["running"] = sorted(
        json.loads(p.read_text())["id"] for p in (state / "submissions").glob("*.json")
        if json.loads(p.read_text())["state"] == "running")
    out["log"] = (tmp / "serve1.log").read_text()
    restarted = _serve_in_thread(cfg)
    out["left"] = cases.survivors(ranks)
    try:
        _wait(lambda: all(_answers(sock) and _status(sock, i)["state"] == "done"
                          for i in ids), 240, "every tenant done")
        out["records"] = {i: _status(sock, i) for i in ids}
        out["counters"] = send_request(str(sock), {"op": "ping"})["counters"]
    finally:
        send_request(str(sock), {"op": "shutdown"}, retries=2)
        out["restart_log"] = restarted()
    return out


def _idle_client(sock, timeout_s):
    """Rank 0's socket of the idle group: wait until the daemon has been up
    for three collective timeouts and more, then one generation through
    the protocol's ops, then shutdown."""
    _wait(lambda: _answers(sock), 180, "the idle daemon to listen")
    _wait(lambda: send_request(str(sock), {"op": "ping"})["uptime_s"] > 3.2 * timeout_s,
          120, "three collective timeouts")
    up = send_request(str(sock), {"op": "ping"})["uptime_s"]
    refused = send_request(str(sock), {"op": "submit", "config": cases.tenant(7, None)})
    sub_id = send_request(str(sock), {"op": "submit", "config": cases.tenant(7, "param")})["id"]
    queued = send_request(str(sock), {"op": "submit", "config": cases.tenant(8, "param")})["id"]
    evicted = send_request(str(sock), {"op": "evict", "id": queued, "reason": "client"})
    _wait(lambda: _status(sock, sub_id)["state"] in ("done", "failed"), 120, "the generation")
    out = {"uptime_s": up, "refused": refused, "evicted": evicted["submission"]["state"],
           "record": _status(sock, sub_id),
           "list": send_request(str(sock), {"op": "list"}),
           "metrics": send_request(str(sock), {"op": "metrics"})["text"],
           "ping": send_request(str(sock), {"op": "ping"})}
    send_request(str(sock), {"op": "shutdown"})
    return out


def _write_inputs(path, inputs):
    """The JAX inputs for the ranks, written whole before they can read."""
    part = path.with_suffix(".part")
    part.write_bytes(pickle.dumps(inputs))
    os.replace(part, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group starts first (the idle group, the subprocess's and the
    cases' group, whose JAX cases wait for the inputs the test process
    writes once its JAX references have run); then the idle daemon's
    client and the one-process daemon run here."""
    tmp = tmp_path_factory.mktemp("serve_group")
    # The subprocess's chain (two boots) is the longest: it starts first.
    cli = _in_thread(_cli_kill_and_restart, tmp)
    idle_state = tmp / "idle"
    idle_raw = cases.daemon_raw(idle_state, 2, "param", poll_interval_s=0.2)
    idle_group = _in_thread(launch, cases.run_cases, ([("param:idle", {"daemon": idle_raw})],),
                            world=cases.WORLD, axis="seed", timeout_s=IDLE_TIMEOUT_S)
    cli_ref = cases.daemon_raw(tmp / "cli_ref", 2, rounds=CLI_ROUNDS)
    cli_tenants = [cases.tenant(s) for s in SEEDS[:3]]
    for t in cli_tenants:
        t["experiment"]["rounds"] = CLI_ROUNDS
    inputs = {k: tmp / f"jax_{k}.pkl" for k in ("seed", "param")}
    plan = [("seed:daemon", _seed_spec(tmp / "seed", evict={EVICTED[0]: EVICTED[1]})),
            ("seed:daemon", {"daemon": cli_ref, "generations": [cli_tenants]}),
            ("param:daemon", _param_spec(tmp / "param")),
            ("param:daemon", _param_spec(tmp / "param_killed", kill=True)),
            ("param:single", {"tenants": [cases.tenant(s, "param") for s in PARAM_SEEDS]}),
            ("seed:daemon", _seed_spec(tmp / "seed_jax", jax=str(inputs["seed"]))),
            ("param:daemon", _param_spec(tmp / "param_jax", jax=str(inputs["param"])))]
    group = _in_thread(launch, cases.run_cases, (plan,), world=cases.WORLD, axis="seed")
    jax = {}
    for k in ("seed", "param"):
        ref = _jax_reference(k)
        _write_inputs(inputs[k], ref[0])
        jax[k] = ref[1:]
    idle = _idle_client(idle_state / "daemon.sock", IDLE_TIMEOUT_S)
    local = cases.run_cases([("seed:daemon", _seed_spec(tmp / "local", group=None))])
    names = ["seed", "cli_ref", "param", "param_killed", "single", "seed_jax", "param_jax"]
    ranks = group()
    return {"group": [dict(zip(names, g["results"])) for g in ranks],
            "forbidden": [g["forbidden_modules"] for g in ranks],
            "local": local["results"][0], "idle": idle, "idle_ranks": idle_group(),
            "cli": cli(), "jax": jax}


def _ledger(run, g):
    return [rec["history"] for rec in run["gens"][g]["ledger"]]


@pytest.mark.parametrize("g", range(len(GENERATIONS)))
def test_seed_group_generations_are_bit_equal_to_the_one_process_daemon(runs, g):
    ranks = [r["seed"] for r in runs["group"]]
    ref = runs["local"]["gens"][g]
    n = len(GENERATIONS[g])
    assert [r["gens"][g]["block"] for r in ranks] == [(0, n // 2), (n // 2, n)]
    assert [r["plan"][1:] for r in ranks] == [("seed", 2)] * 2
    assert runs["local"]["plan"][1:] == (None, 1)
    got = ranks[0]["gens"][g]
    assert [rec["state"] for rec in got["ledger"]] == [
        "evicted" if (g, lane) == EVICTED else "done" for lane in range(n)]
    for lane, (hist, want) in enumerate(zip(_ledger(ranks[0], g), _ledger(runs["local"], g))):
        if (g, lane) != EVICTED:
            assert hist == want, (g, lane)
    # The gang's whole state (the frozen lane kept computing) is the one
    # process's, bit for bit, and every rank recorded every tenant.
    assert got["run"]["flat"].tobytes() == ref["run"]["flat"].tobytes()
    for k, v in ref["run"]["state"].items():
        assert got["run"]["state"][k].tobytes() == v.tobytes(), k
    assert ranks[1]["gens"][g]["run"] is None
    for r in ranks:
        for lane, (hist, want) in enumerate(zip(r["gens"][g]["histories"], ref["histories"])):
            if (g, lane) != EVICTED:
                assert hist == want, (g, lane)


def test_a_rank_holds_no_tenant_in_a_generation_of_one(runs):
    assert [r["seed"]["gens"][2]["held"] for r in runs["group"]] == [0, 1]
    assert [r["seed"]["gens"][1]["held"] for r in runs["group"]] == [1, 2]


def test_warm_generations_build_nothing_on_either_rank(runs):
    for r in runs["group"]:
        built = [gen["built"] for gen in r["seed"]["gens"]]
        assert built[0] >= 1 and built[1:] == [0, 0], built
    assert runs["group"][0]["seed"]["gens"][2]["counters"]["generations"] == 3


def test_an_eviction_freezes_the_same_lane_at_the_same_round_on_every_rank(runs):
    g, lane = EVICTED
    full = runs["local"]["gens"][g]["histories"][lane]
    for r in runs["group"]:
        gen = r["seed"]["gens"][g]
        assert gen["active"] == [True, False, True]
        frozen = gen["histories"][lane]
        assert frozen["round"] == [1]
        assert frozen == {k: v[:1] for k, v in full.items()}
    rec = runs["group"][0]["seed"]["gens"][g]["ledger"][lane]
    assert rec["state"] == "evicted" and rec["error"] == "case eviction"
    # The lane lived on rank 1; rank 0 requested the eviction.
    assert runs["group"][1]["seed"]["gens"][g]["block"] == (1, 3)


def _hold_to_jax(hist, ref, flat, ref_flat, tol):
    dim = ref_flat.shape[-1]
    tol(flat[:, :dim], ref_flat)
    assert not flat[:, dim:].any()
    assert set(hist) == set(ref)
    for k, v in ref.items():
        if k in DECISIONS:
            assert hist[k] == v, k
        elif v:
            tol(hist[k], v, k)


def _scaled_tol(got, ref, key=None):
    assert _scaled(got, ref) <= (1e-3 if key == "agg_krum_score" else 1e-4), key


def _jax_tol(got, ref, key=None):
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-6, err_msg=str(key))


@pytest.mark.parametrize("g", range(len(GENERATIONS)))
def test_seed_group_daemon_matches_the_jax_gang_on_a_seed_mesh(runs, g):
    flats, hists = runs["jax"]["seed"]
    got = runs["group"][0]["seed_jax"]["gens"][g]
    for lane, seed in enumerate(GENERATIONS[g]):
        _hold_to_jax(got["histories"][lane], hists[seed], got["run"]["flat"][lane],
                     flats[seed], _scaled_tol)
    if g == 0:
        assert any(own < 1 for h in got["histories"] for own in h["agg_selected_own"])


def test_param_group_tenants_are_bit_equal_to_their_single_sharded_runs(runs):
    ranks = [r["param"] for r in runs["group"]]
    assert [r["plan"][1:] for r in ranks] == [("param", 2)] * 2
    (gen,) = ranks[0]["gens"]
    singles = runs["group"][0]["single"]
    assert [rec["state"] for rec in gen["ledger"]] == ["done", "done"]
    for lane, single in enumerate(singles):
        assert gen["ledger"][lane]["history"] == single["history"]
        assert gen["run"]["flat"][lane].tobytes() == single["run"]["flat"][0].tobytes()
        for k, v in single["run"]["state"].items():
            assert gen["run"]["state"][k][lane].tobytes() == v[0].tobytes(), k
    for r in ranks:
        assert r["gens"][0]["histories"] == [s["history"] for s in singles]
        assert r["gens"][0]["held"] == 2


def test_param_group_daemon_recovers_from_its_snapshot_bit_equal(runs):
    killed = runs["group"][0]["param_killed"]
    assert killed["recovered"] == ["sub-00001", "sub-00002"]
    (gen,) = killed["gens"]
    (whole,) = runs["group"][0]["param"]["gens"]
    assert gen["counters"]["resumes"] == 2
    assert [rec["history"] for rec in gen["ledger"]] == \
        [rec["history"] for rec in whole["ledger"]]
    assert gen["run"]["flat"].tobytes() == whole["run"]["flat"].tobytes()


def test_param_group_daemon_matches_the_jax_gang_on_a_param_mesh(runs):
    flats, hists = runs["jax"]["param"]
    (got,) = runs["group"][0]["param_jax"]["gens"]
    picked = False
    for lane, seed in enumerate(PARAM_SEEDS):
        _hold_to_jax(got["histories"][lane], hists[seed], got["run"]["flat"][lane],
                     flats[seed], _jax_tol)
        picked |= any(own < 1 for own in got["histories"][lane]["agg_selected_own"])
    assert picked


def test_an_idle_daemon_outlives_three_collective_timeouts(runs):
    idle = runs["idle"]
    assert idle["uptime_s"] > 3 * IDLE_TIMEOUT_S
    rec = idle["record"]
    assert rec["state"] == "done" and rec["history"]["round"] == [1, 2]
    assert all(np.isfinite(rec["history"]["mean_loss"]))
    ranks = runs["idle_ranks"]
    assert [r["results"][0]["served_s"] > 3 * IDLE_TIMEOUT_S for r in ranks] == [True, True]
    assert [r["forbidden_modules"] for r in ranks] == [[], []]


def test_rank_zero_answers_the_protocol(runs):
    idle = runs["idle"]
    assert not idle["refused"]["ok"]
    assert idle["evicted"] == "evicted"
    assert [row["state"] for row in idle["list"]["submissions"]] == ["done", "evicted"]
    assert idle["metrics"].endswith("# EOF\n")
    assert "murmura_serve_lifetime_total" in idle["metrics"]
    assert idle["ping"]["counters"]["generations"] == 1
    assert idle["ping"]["pid"] == runs["idle_ranks"][0]["results"][0]["pid"]


def test_a_tenant_of_another_layout_is_refused_in_words_naming_both(runs):
    words = runs["idle"]["refused"]["error"]
    assert ("the tenant plans one process (layout (seed, nodes, param) (1, 1, 1)) at 2 lanes, "
            "and the daemon runs a param group of 2 (layout (seed, nodes, param) (1, 1, 2))"
            in words), words


def test_a_mismatched_tenant_is_refused_at_normalization():
    from murmura_tpu_torch.utils.factories import check_serve_plan, serve_plan

    running = serve_plan(Config.model_validate(cases.tenant(7, "param")), 2, "cpu")
    assert running[1:] == ("param", 2)
    with pytest.raises(SubmissionError, match=r"the tenant plans a seed group of 2 .* and the "
                                              r"daemon runs a param group of 2"):
        normalize_submission(cases.tenant(7), check=lambda c: check_serve_plan(
            c, 2, "cpu", running))


def test_a_killed_serve_leaves_no_rank_and_recovers_bit_equal(runs):
    cli = runs["cli"]
    assert len(cli["ranks"]) >= cases.WORLD and cli["left"] == []
    assert not cli["answers_after_kill"]
    assert cli["running"] and cli["counters"]["resumes"] == len(cli["running"])
    want = _ledger(runs["group"][0]["cli_ref"], 0)
    got = [cli["records"][f"sub-{i:05d}"]["history"] for i in (1, 2, 3)]
    assert got == want
    for log in (cli["log"], cli["restart_log"]):
        assert "seed layout (seed, nodes, param) (2, 1, 1) over 2 cpu device(s)" in log
    assert cli["restart_log"].rstrip().endswith("murmura_tpu_torch serve: stopped")


def test_no_rank_loads_jax(runs):
    assert runs["forbidden"] == [[]] * cases.WORLD
