"""``sharded_model.yaml`` through both CLIs.

- ``python -m murmura_tpu_torch run examples/configs/sharded_model.yaml
  --device cpu`` lays (1, 1, 4) over 4 CPU devices and runs 4 gloo ranks
  (parallel/launch.py); the JAX package's CLI runs the same config at
  ``tpu.num_devices: 4`` on 4 forced host devices, its (1, 1, 4) mesh.  Both
  cut to 2 rounds, started together: the same history keys, the fault
  schedule's counts exactly equal, the accuracy within the band of
  tests/test_torch_slice.py, every value finite.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import yaml

from test_torch_slice import ACCURACY_BAND

ROOT = Path(__file__).resolve().parents[1]
SHARDED_MODEL = ROOT / "examples" / "configs" / "sharded_model.yaml"


def _start(module, cfg, out, env, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", module, "run", str(cfg), "-o", str(out), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_sharded_model_through_both_clis(tmp_path):
    raw = yaml.safe_load(SHARDED_MODEL.read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    port_cfg = tmp_path / "port.yaml"
    port_cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    raw["tpu"]["num_devices"] = 4
    jax_cfg = tmp_path / "jax.yaml"
    jax_cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
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

