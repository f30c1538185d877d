"""The port's slice end to end against the JAX package, on the CPU.

- ``python -m murmura_tpu_torch run <yaml> --device cpu`` against
  ``python -m murmura_tpu run <yaml>`` on a cut-down flagship (the committed
  femnist_krum_tpu.yaml with the tiny CNN, fewer and easier samples, six
  rounds): both exit 0, their history JSON has the same keys, and the
  port's accuracy climbs to within a stated band of the JAX package's.
  The two packages draw their shuffles and noise from independent RNGs, so
  the trajectories are compared in a band, not value for value.
- Every bundled example config validates to the same ``model_dump()``
  under both schemas, and the lever refusal messages the copied schema
  cites are the JAX package's.
- Every example config the slice does not run is refused by name.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from murmura_tpu.config import load_config as jax_load_config
from murmura_tpu import levers as jax_levers
from murmura_tpu_torch import levers
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.utils.factories import ConfigError, build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples" / "configs").glob("*.yaml"))
FLAGSHIP = ROOT / "examples" / "configs" / "femnist_krum_tpu.yaml"
# Final-round accuracy band between the two packages (independent RNGs;
# over seeds 7 and 8 the final accuracies differed by at most 0.05).
ACCURACY_BAND = 0.15
# The port's mean accuracy must gain at least this much over six rounds
# (it gains about 0.25 on this config).
MIN_CLIMB = 0.1


def _tiny_flagship(tmp_path: Path, exchange: str) -> Path:
    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["experiment"].update(rounds=6, verbose=False)
    raw["model"]["factory"] = "leaf.femnist.tiny"
    raw["data"]["params"] = {"num_samples": 1600, "cluster_std": 0.5}
    raw["training"].update(local_epochs=2, batch_size=16, lr=0.02)
    raw["tpu"]["exchange"] = exchange
    path = tmp_path / f"tiny_{exchange}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _run(module: str, cfg: Path, out: Path, *extra: str) -> dict:
    # One CPU device: tests/conftest.py asks XLA for eight virtual ones,
    # which would shard the JAX run's node axis eight ways.
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", module, "run", str(cfg), "-o", str(out), *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_cli_matches_jax_package(tmp_path):
    ref = _run("murmura_tpu", _tiny_flagship(tmp_path, "allgather"), tmp_path / "jax.json")
    got = {
        ex: _run("murmura_tpu_torch", _tiny_flagship(tmp_path, ex),
                 tmp_path / f"torch_{ex}.json", "--device", "cpu")
        for ex in ("allgather", "ppermute")
    }
    for hist in got.values():
        assert set(hist) == set(ref)
        assert hist["round"] == ref["round"] == list(range(1, 7))
        acc = hist["mean_accuracy"]
        assert acc[-1] - acc[0] >= MIN_CLIMB, acc
        assert abs(acc[-1] - ref["mean_accuracy"][-1]) <= ACCURACY_BAND
        assert abs(hist["honest_accuracy"][-1] - ref["honest_accuracy"][-1]) <= ACCURACY_BAND
    # num_compromised 3 with 4 neighbours fails Krum's c < (m-2)/2, so every
    # node keeps its own state in both exchange modes and the two runs
    # train identically.
    assert got["allgather"]["agg_selected_own"] == [1.0] * 6
    assert got["allgather"]["mean_accuracy"] == got["ppermute"]["mean_accuracy"]


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_examples_validate_as_in_jax_package(path):
    try:
        ref = jax_load_config(path)
    except Exception as e:  # noqa: BLE001 - the port must refuse it the same way
        with pytest.raises(type(e)):
            load_config(path)
        return
    assert load_config(path).model_dump() == ref.model_dump()


def test_lever_refusals_are_the_jax_packages():
    schema = ROOT / "murmura_tpu_torch" / "config" / "schema.py"
    cited = set()
    for node in ast.walk(ast.parse(schema.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "refusal_reason":
            args = [a.value for a in node.args]
            cited.add((*sorted(args[:2]), args[2] if len(args) > 2 else None))
    assert cited and cited <= set(levers._REFUSALS)
    for key in levers._REFUSALS:
        assert levers.refusal_reason(*key) == jax_levers.refusal_reason(*key)


@pytest.mark.parametrize(
    "path", [p for p in EXAMPLES if p != FLAGSHIP], ids=lambda p: p.stem
)
def test_unported_examples_refused_by_name(path):
    config = load_config(path)
    with pytest.raises((ConfigError, ValueError), match="not ported|does not run"):
        build_network_from_config(config, device="cpu")


def test_distributed_backend_refused_by_name(tmp_path):
    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["backend"] = "distributed"
    raw.pop("tpu")
    path = tmp_path / "dist.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(ConfigError, match="backend: distributed"):
        build_network_from_config(load_config(path), device="cpu")


def test_ppermute_needs_a_circulant_topology(tmp_path):
    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["topology"] = {"type": "erdos", "num_nodes": 16, "p": 0.3}
    raw["tpu"]["exchange"] = "ppermute"
    raw["model"]["factory"] = "leaf.femnist.tiny"
    raw["data"]["params"] = {"num_samples": 320}
    path = tmp_path / "erdos.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(ConfigError, match="circulant"):
        build_network_from_config(load_config(path), device="cpu")
