"""``sharded_model.yaml`` through both CLIs.

- ``python -m murmura_tpu_torch run examples/configs/sharded_model.yaml
  --device cpu`` lays (1, 1, 4) over 4 CPU devices and runs 4 gloo ranks
  (parallel/launch.py); the JAX package's CLI runs the same config at
  ``tpu.num_devices: 4`` on 4 forced host devices, its (1, 1, 4) mesh.  Both
  cut to 2 rounds, started together: the same history keys, the fault
  schedule's counts exactly equal, the accuracy within the band of
  tests/test_torch_slice.py, every value finite.
- ``run --seeds 2`` and ``sweep`` of the tiny sharded config
  (tests/torch_sharding_cases.py ``tiny_config``: Krum under faults,
  staleness and int8, ``tpu.param_shards: 4``; 120 samples a node) through
  both CLIs, all four
  started together: the port lays the gang over 2 CPU devices
  (``tpu.num_devices: 2``) and runs it in a group of 2 ranks, the JAX
  package on its ("seed", "nodes", "param") mesh of 4 forced host
  devices; the same member labels and history keys, the fault counts
  equal, the accuracy within the band.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import yaml

import torch_sharding_cases as cases
from test_torch_slice import ACCURACY_BAND

ROOT = Path(__file__).resolve().parents[1]
SHARDED_MODEL = ROOT / "examples" / "configs" / "sharded_model.yaml"


def _start(module, cfg, out, env, *extra, command="run"):
    return subprocess.Popen(
        [sys.executable, "-m", module, command, str(cfg), "-o", str(out), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _envs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env, dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")


def test_sharded_model_through_both_clis(tmp_path):
    raw = yaml.safe_load(SHARDED_MODEL.read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    port_cfg = tmp_path / "port.yaml"
    port_cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    raw["tpu"]["num_devices"] = 4
    jax_cfg = tmp_path / "jax.yaml"
    jax_cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    env, jax_env = _envs()
    procs = {"jax": _start("murmura_tpu", jax_cfg, tmp_path / "jax.json", jax_env),
             "torch": _start("murmura_tpu_torch", port_cfg, tmp_path / "torch.json", env,
                             "--device", "cpu")}
    outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][0][-2000:] + outs[k][1][-4000:])
    stdout = outs["torch"][0]
    assert "param layout (seed, nodes, param) (1, 1, 4) over 4 cpu device(s): 4 ranks over " \
           "gloo" in stdout
    assert "param group: world 4, backend gloo" in stdout
    assert "columns [0,103744) [103744,207488) [207488,311232) [311232,414976)" in stdout
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "torch.json").read_text())
    assert set(got) == set(ref)
    assert got["round"] == ref["round"] == [1, 2]
    for k in ("agg_alive", "agg_quarantined", "agg_attack_scrubbed"):
        assert got[k] == ref[k], k
    assert {"agg_compress_error", "agg_compress_residual_norm", "agg_stale_used"} <= set(got)
    for k in ("mean_accuracy", "honest_accuracy"):
        assert abs(got[k][-1] - ref[k][-1]) <= ACCURACY_BAND, k
    for k, v in got.items():
        assert all(math.isfinite(x) for x in v), k



def test_sharded_gangs_through_both_clis(tmp_path):
    # 120 samples a node and lr 0.1: both packages' members reach 0.77-0.89
    # mean accuracy in 2 rounds (at 20 samples a node the final accuracy
    # of a member moves by 0.2 with its initialisation alone).
    raw = cases.tiny_config(
        sweep={"seeds": [7, 9]}, training={"lr": 0.1},
        data={"params": {"num_samples": 960, "input_shape": [6], "num_classes": 3}})
    raw["experiment"]["verbose"] = False
    port_raw = {**raw, "tpu": {**raw["tpu"], "num_devices": 2}}
    jax_raw = {**raw, "tpu": {**raw["tpu"], "num_devices": 4}}
    cfgs = {}
    for name, r in (("torch", port_raw), ("jax", jax_raw)):
        cfgs[name] = tmp_path / f"{name}.yaml"
        cfgs[name].write_text(yaml.safe_dump(r, sort_keys=False))
    env, jax_env = _envs()
    procs = {}
    for command, extra in (("run", ("--seeds", "2")), ("sweep", ())):
        procs[("jax", command)] = _start("murmura_tpu", cfgs["jax"],
                                         tmp_path / f"jax-{command}.json", jax_env, *extra,
                                         command=command)
        procs[("torch", command)] = _start("murmura_tpu_torch", cfgs["torch"],
                                           tmp_path / f"torch-{command}.json", env, *extra,
                                           "--device", "cpu", command=command)
    outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][0][-2000:] + outs[k][1][-4000:])
    for command, labels in (("run", ["seed_7", "seed_8"]), ("sweep", ["seed_7", "seed_9"])):
        stdout = outs[("torch", command)][0]
        assert ("param layout (seed, nodes, param) (1, 1, 2) over 2 cpu device(s): 2 ranks "
                "over gloo") in stdout, stdout[-2000:]
        assert "param group: world 2, backend gloo" in stdout
        ref = json.loads((tmp_path / f"jax-{command}.json").read_text())
        got = json.loads((tmp_path / f"torch-{command}.json").read_text())
        assert list(got) == list(ref) == labels
        for label in labels:
            g, r = got[label], ref[label]
            assert set(g) == set(r), label
            assert g["round"] == r["round"] == [1, 2]
            for k in ("agg_alive", "agg_quarantined", "agg_attack_scrubbed"):
                assert g[k] == r[k], (label, k)
            for k in ("mean_accuracy", "honest_accuracy"):
                assert abs(g[k][-1] - r[k][-1]) <= ACCURACY_BAND, (label, k)
            for k, v in g.items():
                assert all(math.isfinite(x) for x in v), (label, k)
        # The members are different experiments.
        assert got[labels[0]]["mean_loss"] != got[labels[1]]["mean_loss"]
