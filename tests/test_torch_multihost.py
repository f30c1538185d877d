"""``tpu.multihost``: a run started as several processes that meet at a tcp
rendezvous (parallel/launch.py ``join``), on the CPU.

- Two ``python -m murmura_tpu_torch run`` processes (``process_id`` 0 and
  1, ``coordinator_address`` 127.0.0.1:<free port>, ``tpu.num_devices: 4``,
  so 2 local gloo ranks each: a node group of 4) of a tiny
  dmtt_mobility.yaml (8 nodes, the MLP at hidden [16], Krum at
  ``num_compromised: 1``, 2 rounds): process 0 prints the layout naming the
  processes and the global world and writes the history, which equals the
  same config run in one process in the test, every column bit for bit
  but the Krum score (the dense Krum centre sums the blocks' partials over
  the group: within the node axis's KRUM_SCORE_RTOL); process 1 prints one
  line naming its global ranks, writes nothing and exits 0.
- Beside them, two ``run --seeds 2`` processes at ``tpu.num_devices: 2``
  (a seed group of 2 over tcp, one rank in each process, no spawn): every
  member bit-equal to the one-process gang.  Both pairs run at once.
  Neither process of either pair loads JAX or the JAX package.
- The same tiny config against the JAX package's
  ``build_network_from_config`` at ``tpu.num_devices: 4`` on the conftest's
  CPU devices: the port in one process from JAX's initial parameters on
  JAX's draws (the joined run equals the one-process run above), rtol 5e-5,
  the DMTT counts and Krum's picks equal.
- The refusals by name (each unset field, a ``process_id`` out of range, a
  global count ``num_processes`` does not divide, a plan that leaves a
  process's devices out, ``transfer_guard`` over processes); the flag read
  and ignored off ``backend: tpu``; ``frontier``, ``grid`` and ``serve``
  through the join with the process's global ranks (a stubbed entry, no
  process started); a peer that never comes failing within a short group
  timeout, naming the coordinator; a second join in a process that is a
  rank already, ignored.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from murmura_tpu_torch import cli
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.parallel import launch as launcher
from murmura_tpu_torch.parallel.mesh import NodeGroup, SeedGroup, set_process_group
from murmura_tpu_torch.utils.factories import (
    ConfigError,
    build_network_from_config,
    processes_of,
    unported_sections,
)

ROOT = Path(__file__).resolve().parents[1]
# The dense Krum score over a node group (tests/test_torch_node_axis_probe.py).
KRUM_SCORE_RTOL = 1e-3
# What a process runs: the CLI, then the modules of JAX it loaded.
_MAIN = ("import sys; from murmura_tpu_torch.cli import main; "
         "from murmura_tpu_torch.parallel.launch import forbidden_modules; "
         "main(sys.argv[1:]); print('FORBIDDEN', forbidden_modules())")
DMTT_COUNTS = ("agg_dmtt_collab_count", "agg_dmtt_received_count", "agg_selected_own")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_dmtt(**tpu) -> dict:
    """dmtt_mobility.yaml at 8 nodes, the MLP at hidden [16], Krum (c = 1),
    2 rounds, ``backend: tpu`` with ``tpu``."""
    raw = yaml.safe_load((ROOT / "examples/configs/dmtt_mobility.yaml").read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    raw["topology"]["num_nodes"] = 8
    raw["aggregation"] = {"algorithm": "krum", "params": {"num_compromised": 1}}
    raw["data"]["params"]["num_samples"] = 640
    raw["model"]["params"]["hidden_dims"] = [16]
    raw["backend"] = "tpu"
    raw["tpu"] = {"param_dtype": "float32", **tpu}
    return raw


def _multihost(raw: dict, port: int, pid: int, processes: int = 2) -> dict:
    return {**raw, "tpu": {**raw["tpu"], "multihost": True, "num_processes": processes,
                           "coordinator_address": f"127.0.0.1:{port}", "process_id": pid}}


def _write(tmp_path: Path, name: str, raw: dict) -> Path:
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _start(cfg: Path, *args) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", _MAIN, "run", str(cfg), "--device", "cpu",
                             *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _jax_reference(raw: dict):
    """The JAX package's network of ``raw`` at ``tpu.num_devices: 4``, and the
    port's one-process network from its initial parameters on its draws,
    each trained 2 rounds: (JAX's history, the port's)."""
    import jax

    from murmura_tpu.config.schema import Config as JaxConfig
    from murmura_tpu.utils.factories import build_network_from_config as jax_build
    from murmura_tpu_torch.core.network import Network
    from murmura_tpu_torch.utils import factories as F
    from test_torch_dmtt import _jax_draws

    jnet = jax_build(JaxConfig.model_validate(raw))
    assert jnet.mesh is not None and jnet.mesh.devices.size == 4
    init = jax.tree_util.tree_map(np.asarray, jnet.params)
    jax_hist = jnet.train(2)

    cfg = Config.model_validate({**raw, "tpu": {"param_dtype": "float32"}})
    topology, attack = F.build_topology(cfg), F.build_attack(cfg)
    seed = cfg.experiment.seed
    program, _ = F.build_program(cfg, topology, attack, seed, torch.device("cpu"),
                                 init_params=init)
    comp = attack.compromised.astype(np.float32)
    step = program.train_step

    def on_jax_draws(flat, state, adj, compromised, round_idx, generators=None, **kw):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), int(round_idx))
        draws = _jax_draws(key, tuple(program.data["mask"].shape), comp, program.model_dim)
        return step(flat, state, adj, compromised, round_idx, draws=draws, **kw)

    program.train_step = on_jax_draws
    net = Network(program, topology, attack=attack, seed=seed,
                  mobility=F.build_mobility(cfg))
    return jax_hist, net.train(2)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Both process pairs started at once; the one-process references and
    the JAX package's run made while they run."""
    tmp = tmp_path_factory.mktemp("multihost")
    dmtt = tiny_dmtt(num_devices=4)
    seeds = tiny_dmtt(num_devices=2)
    # A gang needs equal data shapes across seeds: dirichlet shards differ.
    seeds["data"]["params"].update(partition_method="iid", alpha=None)
    port_a, port_b = _free_port(), _free_port()
    procs = {}
    for pid in (0, 1):
        procs[("run", pid)] = _start(_write(tmp, f"run{pid}", _multihost(dmtt, port_a, pid)),
                                     "-o", str(tmp / f"run{pid}.json"))
        procs[("seeds", pid)] = _start(_write(tmp, f"seeds{pid}",
                                              _multihost(seeds, port_b, pid)),
                                       "--seeds", "2", "-o", str(tmp / f"seeds{pid}.json"))
    one = {**dmtt, "tpu": {"param_dtype": "float32"}}
    ref_run, _ = cli.run(_write(tmp, "one", one), None, "cpu")
    ref_seeds, _ = cli.run(_write(tmp, "seeds_one", {**seeds, "tpu": {"param_dtype": "float32"}}),
                           None, "cpu", num_seeds=2)
    jax_hist, port_hist = _jax_reference(dmtt)
    outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{outs[k][0][-2000:]}\n{outs[k][1][-4000:]}"
    return {"tmp": tmp, "outs": outs, "ports": (port_a, port_b), "ref_run": ref_run,
            "ref_seeds": ref_seeds, "jax": jax_hist, "port_on_jax_draws": port_hist}


def test_two_joined_run_processes_equal_one_process(pairs):
    tmp, outs = pairs["tmp"], pairs["outs"]
    out0 = outs[("run", 0)][0]
    assert ("node layout (seed, nodes, param) (1, 4, 1) over 4 cpu device(s) of 2 processes "
            f"(2 each, joined at tcp://127.0.0.1:{pairs['ports'][0]}): 4 ranks over gloo"
            ) in out0
    assert "node group: world 4 over 2 processes of 2 ranks, backend gloo" in out0
    got = json.loads((tmp / "run0.json").read_text())
    ref = pairs["ref_run"]
    assert set(got) == set(ref) and got["round"] == [1, 2]
    for k, v in ref.items():
        if k == "agg_krum_score":
            np.testing.assert_allclose(got[k], v, rtol=KRUM_SCORE_RTOL, err_msg=k)
        else:
            assert got[k] == v, k
    # Krum picked a neighbour somewhere, and DMTT selected collaborators.
    assert min(ref["agg_selected_own"]) < 1.0 and min(ref["agg_dmtt_collab_count"]) > 0


def test_process_one_prints_its_ranks_and_writes_nothing(pairs):
    tmp, outs = pairs["tmp"], pairs["outs"]
    lines = [line for line in outs[("run", 1)][0].splitlines() if line.strip()]
    assert lines == ["murmura_tpu_torch process 1 of 2: global ranks [2, 4) of the nodes group "
                     "of 4 ran; process 0 prints and writes", "FORBIDDEN []"]
    assert not (tmp / "run1.json").exists() and not (tmp / "seeds1.json").exists()
    assert outs[("seeds", 1)][0].splitlines()[0].startswith(
        "murmura_tpu_torch process 1 of 2: global ranks [1, 2) of the seed group of 2 ran")


def test_two_joined_seed_processes_equal_the_one_process_gang(pairs):
    out0 = pairs["outs"][("seeds", 0)][0]
    assert "seed layout (seed, nodes, param) (2, 1, 1) over 2 cpu device(s) of 2 processes" in out0
    assert "seed group: world 2 over 2 processes of 1 ranks" in out0
    got = json.loads((pairs["tmp"] / "seeds0.json").read_text())
    ref = pairs["ref_seeds"]
    assert list(got) == list(ref) and len(ref) == 2
    for label, hist in ref.items():
        assert got[label] == hist, label


def test_no_joined_process_loads_jax(pairs):
    for k, (out, _) in pairs["outs"].items():
        assert "FORBIDDEN []" in out, k


def test_tiny_dmtt_config_matches_the_jax_package_node_mesh(pairs):
    """The one-process port (equal to the joined run) from JAX's initial
    parameters on JAX's draws against JAX's 4-device node mesh."""
    ref, got = pairs["jax"], pairs["port_on_jax_draws"]
    assert set(got) == set(ref) and got["round"] == ref["round"] == [1, 2]
    for k, v in ref.items():
        if k in DMTT_COUNTS:
            assert got[k] == v, k
        elif k == "agg_krum_score":
            np.testing.assert_allclose(got[k], v, rtol=KRUM_SCORE_RTOL, err_msg=k)
        elif v and isinstance(v[0], (int, float)):
            np.testing.assert_allclose(got[k], v, rtol=5e-5, atol=5e-6, err_msg=k)


# ---------------------------------------------------------------------------
# refusals, and the routing of the gang commands


@pytest.mark.parametrize("field", ["coordinator_address", "num_processes", "process_id"])
def test_each_unset_field_is_refused_by_name(field):
    raw = _multihost(tiny_dmtt(num_devices=4), 1234, 0)
    raw["tpu"][field] = None
    cfg = Config.model_validate(raw)
    assert unported_sections(cfg) == []
    with pytest.raises(ConfigError, match=f"tpu.multihost needs tpu.{field} set"):
        build_network_from_config(cfg, device="cpu")


@pytest.mark.parametrize("tpu, words", [
    ({"process_id": 2}, r"tpu.process_id 2 is not in \[0, tpu.num_processes=2\)"),
    ({"process_id": -1}, r"tpu.process_id -1 is not in"),
    ({"num_devices": 3}, "global device count 3 is not a multiple of tpu.num_processes=2"),
    ({"coordinator_address": "localhost"}, "must be host:port"),
])
def test_a_join_that_cannot_be_made_is_refused_by_name(tmp_path, tpu, words):
    raw = _multihost(tiny_dmtt(num_devices=4), 1234, 0)
    raw["tpu"].update(tpu)
    with pytest.raises(ConfigError, match=words):
        cli.run(_write(tmp_path, "cfg", raw), None, "cpu")


def test_a_plan_leaving_a_process_devices_out_is_refused(tmp_path):
    # A gang of 2 at 4 global devices plans a seed group of 2: the other two
    # devices would sit out.
    raw = _multihost(tiny_dmtt(num_devices=4), 1234, 0)
    with pytest.raises(ConfigError, match="leaves devices of some process out of the run"):
        cli.run(_write(tmp_path, "cfg", raw), None, "cpu", num_seeds=2)


def test_transfer_guard_over_processes_is_refused_in_jax_words():
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.core.network import Network
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.topology.generators import create_topology
    from torch_sharding_cases import tiny_data, tiny_model

    group = NodeGroup(0, 2, "gloo", torch.device("cpu"), processes=2)
    prog = build_round_program(tiny_model(), build_aggregator("fedavg", {}), tiny_data(),
                               device="cpu", group=group)
    topology = create_topology("k-regular", 8, k=4)
    with pytest.raises(ValueError, match="tpu.transfer_guard is single-host only"):
        Network(prog, topology, transfer_guard=True)
    Network(prog, topology)  # without the guard


def test_a_multihost_config_with_its_fields_names_no_unported_section():
    cfg = Config.model_validate(_multihost(tiny_dmtt(num_devices=4), 1234, 1))
    assert unported_sections(cfg) == [] and processes_of(cfg) == 2


def test_the_flag_is_read_and_ignored_off_the_tpu_backend():
    raw = _multihost(tiny_dmtt(), 1234, 0)
    raw["backend"] = "simulation"
    raw["tpu"].update(coordinator_address=None, process_id=None)
    cfg = Config.model_validate(raw)
    assert processes_of(cfg) == 1 and unported_sections(cfg) == []


def _stub_join(calls):
    def join(fn, args=(), **kw):
        calls.append({"fn": fn.__name__, **kw})
        return ["rank value"]

    return join


def _gang_commands(tmp_path, pid):
    """(command, config) of frontier, grid and serve at a multihost layout of
    4 global devices (each gang plans a seed group of 4)."""
    frontier_raw = yaml.safe_load((ROOT / "examples/configs/frontier_krum.yaml").read_text())
    grid_raw = yaml.safe_load((ROOT / "examples/configs/serve_grid.yaml").read_text())
    serve_raw = {**grid_raw, "serve": {"state_dir": str(tmp_path / "state"), "capacity": 4}}
    serve_raw.pop("grid", None)
    out = {}
    for name, raw in (("frontier", frontier_raw), ("grid", grid_raw), ("serve", serve_raw)):
        raw = {**raw, "backend": "tpu", "tpu": {**(raw.get("tpu") or {}), "num_devices": 4}}
        out[name] = _write(tmp_path, name, _multihost(raw, 4321, pid))
    return out


@pytest.mark.parametrize("command", ["frontier", "grid", "serve"])
def test_gang_commands_join_with_their_global_ranks(tmp_path, monkeypatch, capsys, command):
    calls = []
    monkeypatch.setattr(launcher, "join", _stub_join(calls))
    monkeypatch.setattr(launcher, "launch", lambda *a, **k: pytest.fail("launched"))
    for pid in (0, 1):
        path = _gang_commands(tmp_path, pid)[command]
        if command == "serve":
            cli.serve(path, "cpu")
        else:
            getattr(cli, command)(path, tmp_path / f"{command}.json", "cpu")
        out = capsys.readouterr().out
        if pid == 0:
            assert ("seed layout (seed, nodes, param) (4, 1, 1) over 4 cpu device(s) of 2 "
                    "processes (2 each, joined at tcp://127.0.0.1:4321)") in out
            assert "process 0 of" not in out
        else:
            assert "layout" not in out
            assert out.splitlines()[0] == (
                "murmura_tpu_torch process 1 of 2: global ranks [2, 4) of the seed group of 4 "
                "ran; process 0 prints and writes")
    assert [(c["process_id"], c["num_processes"], c["local_world"], c["axis"],
             c["coordinator"], c["device_type"]) for c in calls] == [
        (pid, 2, 2, "seed", "127.0.0.1:4321", "cpu") for pid in (0, 1)]
    assert {c["fn"] for c in calls} == {command}
    assert not (tmp_path / f"{command}.json").exists()


def test_a_peer_that_never_comes_fails_naming_the_coordinator():
    port = _free_port()
    with pytest.raises(launcher.GroupError, match=f"at tcp://127.0.0.1:{port} within 1 s"):
        launcher.join(len, ([],), coordinator=f"127.0.0.1:{port}", num_processes=2,
                      process_id=0, timeout_s=1, axis="nodes")


def test_a_second_join_in_a_rank_is_ignored():
    set_process_group(SeedGroup(0, 2, "gloo", torch.device("cpu"), processes=2))
    try:
        assert launcher.join(len, ([1, 2, 3],), coordinator="127.0.0.1:1", num_processes=2,
                             process_id=0, axis="seed") == [3]
    finally:
        set_process_group(None)
