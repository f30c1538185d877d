"""The seed axis and the param group through the CLI, on the CPU.

- ``sweep``, ``run --seeds 2``, ``frontier -o`` and ``grid -o`` of the tiny
  flagship-shaped config (tests/torch_node_axis_cases.py ``tiny_config``:
  Krum under a gaussian attack and chaos_churn.yaml's faults) at
  ``tpu.num_devices: 2`` each lay a seed axis of 2 and run 2 gloo ranks of a
  seed group, all six commands of this file started together: each prints its layout line
  (rank 0 the group's), and writes what one process writes: the sweep's
  and ``run --seeds``'s histories byte for byte those of the same command
  without ``tpu.num_devices`` (one process, run in this process), the
  frontier's artifact and the
  grid's manifest equal to ``run_frontier`` and ``run_grid`` of the same
  config in this process (the one-process gangs) apart from the walls,
  ``compiles`` included.
- ``frontier -o`` and ``grid -o`` at ``tpu.param_shards: 2`` lay a param
  axis of 2 and run 2 ranks of a param group: the
  artifact's and the manifest's cells those of the same config at one
  shard, every value finite.
- ``serve`` at a seed axis of 2 and at ``tpu.param_shards: 2`` prints its
  layout line and launches its group of 2 once (the group daemon itself:
  tests/test_torch_serve_group.py).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

import torch_seed_axis_cases as cases
from murmura_tpu_torch import cli
from murmura_tpu_torch.config.schema import Config

ROOT = Path(__file__).resolve().parents[1]
_WALLS = ("wall_s", "bucket_wall_s", "mean_round_s")


def _start(command, cfg, out, *extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "murmura_tpu_torch", command, str(cfg), "-o", str(out),
         "--device", "cpu", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs):
    outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{outs[k][0][-2000:]}\n{outs[k][1][-4000:]}"
    return {k: o[0] for k, o in outs.items()}


def _raw(**over):
    raw = cases.gang_config(tpu={"num_devices": 2}, **over)
    raw["experiment"]["verbose"] = False
    raw["sweep"] = {"seeds": [7, 8, 9]}
    raw["frontier"] = {"rules": ["krum"], "attacks": ["gaussian"], "topologies": ["dense"],
                       "points": 2, "seeds": [7], "stages": 2, "rounds": 2}
    raw["grid"] = {"rules": ["krum"], "attacks": ["gaussian", "none"], "topologies": ["dense"],
                   "strengths": [1.0], "seeds": [7, 8, 9], "rounds": 2}
    return raw


def _write(path, raw):
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _param_raw():
    raw = _raw()
    raw.pop("faults")
    raw["tpu"] = {"param_dtype": "float32", "param_shards": 2}
    return raw


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    """Every command of this file, started together: the four gang
    commands at a seed axis of 2 and the frontier and the grid at
    ``tpu.param_shards: 2`` (each 2 gloo ranks); meanwhile the one-process
    references in this process: ``sweep`` and ``run --seeds 2`` without
    ``tpu.num_devices``, ``run_frontier`` and ``run_grid`` of the seed-axis
    config."""
    from murmura_tpu_torch.frontier import run_frontier
    from murmura_tpu_torch.serve.scheduler import run_grid

    tmp = tmp_path_factory.mktemp("seed_axis_cli")
    raw = _raw()
    two = _write(tmp / "two.yaml", raw)
    one = _write(tmp / "one.yaml",
                 {**raw, "tpu": {k: v for k, v in raw["tpu"].items() if k != "num_devices"}})
    p2 = _write(tmp / "p2.yaml", _param_raw())
    procs = {(c, "seed"): _start(c, two, tmp / f"{c}-two.json", *extra)
             for c, extra in (("sweep", ()), ("run", ("--seeds", "2")), ("frontier", ()),
                              ("grid", ()))}
    procs.update({(c, "param"): _start(c, p2, tmp / f"{c}-p2.json")
                  for c in ("frontier", "grid")})
    cli.sweep(one, output=tmp / "sweep-one.json", device="cpu")
    cli.run(one, output=tmp / "run-one.json", num_seeds=2, device="cpu")
    cfg = Config.model_validate(raw)
    refs = {"frontier": run_frontier(cfg, device="cpu"), "grid": run_grid(cfg, device="cpu")}
    return {"out": _wait(procs), "tmp": tmp, "refs": refs}


def test_gang_commands_over_a_seed_group_of_two_write_what_one_process_writes(commands):
    tmp, out = commands["tmp"], commands["out"]
    for command, gang in (("sweep", 3), ("run", 2), ("frontier", 3), ("grid", 3)):
        stdout = out[(command, "seed")]
        assert (f"seed layout (seed, nodes, param) (2, 1, 1) over 2 cpu device(s): 2 ranks of "
                "a seed group over gloo") in stdout, (command, stdout[-2000:])
        if command in ("sweep", "run"):
            assert (f"seed group: world 2, backend gloo, rank 0 on cpu, members "
                    f"[0,{gang // 2}) [{gang // 2},{gang}) of {gang}") in stdout
            got = (tmp / f"{command}-two.json").read_bytes()
            assert got == (tmp / f"{command}-one.json").read_bytes(), command
    assert list(json.loads((tmp / "run-two.json").read_text())) == ["seed_7", "seed_8"]
    frontier = json.loads((tmp / "frontier-two.json").read_text())
    assert cases.without(frontier, _WALLS) == cases.without(commands["refs"]["frontier"], _WALLS)
    grid = json.loads((tmp / "grid-two.json").read_text())
    assert cases.without(grid, _WALLS) == cases.without(commands["refs"]["grid"], _WALLS)
    assert [b["gang_size"] for b in grid["buckets"]] == [3, 3]


def test_frontier_and_grid_over_a_param_group_of_two(commands):
    from murmura_tpu_torch.serve.scheduler import plan_grid

    tmp, out = commands["tmp"], commands["out"]
    raw = _param_raw()
    one = Config.model_validate({**raw, "tpu": {"param_dtype": "float32"}})
    for command in ("frontier", "grid"):
        assert ("param layout (seed, nodes, param) (1, 1, 2) over 2 cpu device(s): 2 ranks "
                "over gloo") in out[(command, "param")], out[(command, "param")][-2000:]
        art = json.loads((tmp / f"{command}-p2.json").read_text())
        values = [v for c in art["cells"] for v in _numbers(c)]
        assert values and all(math.isfinite(v) for v in values), command
    grid = json.loads((tmp / "grid-p2.json").read_text())
    assert [c["id"] for c in grid["cells"]] == [c.cell_id for b in plan_grid(one)
                                                 for c in b.cells]
    (cell,) = json.loads((tmp / "frontier-p2.json").read_text())["cells"]
    assert cell["stages"] == 2 and cell["rule"] == "krum"


def _numbers(x):
    if isinstance(x, bool):
        return
    if isinstance(x, (int, float)):
        yield float(x)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from _numbers(v)


@pytest.mark.parametrize("tpu,words", [
    ({"num_devices": 2}, "serve over a seed axis or a node axis above 1"),
    ({"param_shards": 2}, "serve with tpu.param_shards > 1"),
])
def test_serve_is_refused_by_name_on_either_axis(tmp_path, capsys, monkeypatch, tpu, words):
    """``serve`` on either axis is no longer refused (``words`` were the
    refusal's): it prints its layout line and launches the group's 2 ranks
    once for the daemon (the launcher stood in for here; the group daemon
    itself runs in tests/test_torch_serve_group.py)."""
    from murmura_tpu_torch.parallel import launch as launch_mod

    raw = _raw()
    raw.pop("sweep"), raw.pop("frontier"), raw.pop("grid")
    raw["tpu"] = {"param_dtype": "float32", **tpu}
    raw["serve"] = {"state_dir": str(tmp_path / "state"), "capacity": 2}
    cfg = _write(tmp_path / "serve.yaml", raw)
    calls = []
    monkeypatch.setattr(launch_mod, "launch", lambda fn, args, **kw: calls.append((fn, kw)))
    cli.main(["serve", str(cfg), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert words not in err
    axis = "seed" if "num_devices" in tpu else "param"
    assert [(fn, kw["world"], kw["axis"]) for fn, kw in calls] == [(cli.serve, 2, axis)]
    assert f"{axis} layout (seed, nodes, param)" in out
    assert out.rstrip().endswith("murmura_tpu_torch serve: stopped")
