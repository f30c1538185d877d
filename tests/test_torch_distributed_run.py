"""One spawned run of the port's ZMQ backend, through the CLI:
``python -m murmura_tpu_torch run <cfg> --device cpu`` on a ``backend:
distributed`` config (3 nodes on a ring, Krum, a tiny MLP on synthetic
data, 2 rounds): a monitor process and one process per node.  It exits 0,
its history has rounds [1, 2], finite losses, and the keys of the port's
own ``simulation`` run of the same config, apart from the distributed-only
``skipped_nodes`` / ``reporting_nodes`` (as the JAX package's test of its
backend checks).

The run waits mostly on the wall clock: ``startup_grace_s`` covers the
slowest node's boot (a fresh interpreter importing torch: 4.5-5.0 s on an
idle 8-core CPU, 5.4-5.9 s beside a 5-worker test run at load 12.5) about
3.4 times over, and each round window covers a round's work (0.01-0.1 s
here) 40 times over.  That is 31-41 s of test time, most of it waiting:
marked slow, so that the tier-1 run spends its time on the in-process
comparisons (tests/test_torch_distributed.py).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
STARTUP_GRACE_S = 20.0
ROUND_DURATION_S = 4.0


@pytest.mark.slow
def test_spawned_distributed_run_matches_the_simulation_schema(tmp_path):
    raw = {
        "experiment": {"name": "dist-run", "seed": 42, "rounds": 2},
        "topology": {"type": "ring", "num_nodes": 3},
        "aggregation": {"algorithm": "krum"},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 240, "input_dim": 16, "num_classes": 4}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "num_classes": 4, "hidden_dims": [16]}},
        "backend": "distributed",
        "distributed": {"transport": "ipc", "ipc_dir": str(tmp_path / "ipc"),
                        "round_duration_s": ROUND_DURATION_S,
                        "startup_grace_s": STARTUP_GRACE_S},
    }
    cfg_path, out = tmp_path / "dist.yaml", tmp_path / "history.json"
    cfg_path.write_text(yaml.safe_dump(raw))
    proc = subprocess.run(
        [sys.executable, "-m", "murmura_tpu_torch", "run", str(cfg_path), "--device", "cpu",
         "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    history = json.loads(out.read_text())
    assert history["round"] == [1, 2], proc.stdout
    assert np.isfinite(history["mean_loss"]).all(), history
    assert proc.stdout.count("s before round 0, on cpu") == 3, proc.stdout

    raw["backend"] = "simulation"
    sim = build_network_from_config(Config.model_validate(raw), device="cpu").train(rounds=2)

    def populated(h):
        return {k for k, v in h.items() if len(v) > 0}

    assert populated(history) - {"skipped_nodes", "reporting_nodes"} == populated(sim), (
        populated(history) ^ populated(sim))
