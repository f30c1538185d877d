"""The node axis through the CLI: ``python -m murmura_tpu_torch run`` of the
tiny flagship-shaped config (tests/torch_node_axis_cases.py ``tiny_config``:
Krum under a gaussian attack and chaos_churn.yaml's faults, ``backend:
tpu``) at ``tpu.num_devices: 2`` and ``tpu.exchange: ppermute`` lays a node
axis of 2 over the CPU and runs 2 gloo ranks; the same config without
``tpu.num_devices`` runs in one process.  Both started together: the layout
and the group's lines printed, the histories' decisions (picks, the fault
counts) equal, every other value within a scaled 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import yaml

import torch_node_axis_cases as cases

ROOT = Path(__file__).resolve().parents[1]
DECISIONS = ("round", "agg_selected_index", "agg_selected_own", "agg_alive",
             "agg_quarantined", "agg_attack_scrubbed")


def _start(cfg, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "murmura_tpu_torch", "run", str(cfg), "-o", str(out),
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_run_over_a_node_axis_of_two_matches_one_process(tmp_path):
    raw = cases.tiny_config(tpu={"exchange": "ppermute", "num_devices": 2})
    raw["experiment"]["verbose"] = False
    two = tmp_path / "two.yaml"
    two.write_text(yaml.safe_dump(raw, sort_keys=False))
    one_raw = {**raw, "tpu": {k: v for k, v in raw["tpu"].items() if k != "num_devices"}}
    one = tmp_path / "one.yaml"
    one.write_text(yaml.safe_dump(one_raw, sort_keys=False))
    procs = {"two": _start(two, tmp_path / "two.json"),
             "one": _start(one, tmp_path / "one.json")}
    outs = {k: p.communicate(timeout=240) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{outs[k][0][-2000:]}\n{outs[k][1][-4000:]}"
    stdout = outs["two"][0]
    assert ("node layout (seed, nodes, param) (1, 2, 1) over 2 cpu device(s): 2 ranks over "
            "gloo") in stdout
    # The window of offsets 1, 2, 6, 7 (-2 .. +2) around each block of 4.
    assert ("node group: world 2, backend gloo, rank 0 on cpu, node blocks [0,4) [4,8); "
            "window exchange at offsets [1, 2, 6, 7], rows received rank 0: 6-7,0-5; "
            "rank 1: 2-7,0-1") in stdout
    assert "node layout" not in outs["one"][0]
    got = json.loads((tmp_path / "two.json").read_text())
    ref = json.loads((tmp_path / "one.json").read_text())
    assert set(got) == set(ref) and got["round"] == [1, 2]
    for k, v in ref.items():
        if k in DECISIONS:
            assert got[k] == v, k
        else:
            try:
                r = np.asarray(v, np.float64)
            except (TypeError, ValueError):  # a non-numeric entry: equal
                assert got[k] == v, k
                continue
            g = np.asarray(got[k], np.float64)
            assert g.shape == r.shape, k
            if r.size:
                assert np.max(np.abs(g - r)) <= 1e-4 * max(1.0, np.max(np.abs(r))), k
