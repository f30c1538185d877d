"""The port stands alone: it imports nothing of JAX or of the JAX package,
and it never moves to the CPU unless asked to.

- In a fresh interpreter, importing every module of ``murmura_tpu_torch``
  and running one CPU round each of Krum, the circulant median and
  Sketchguard loads no ``jax`` and no ``murmura_tpu.*`` module (counted
  against what the interpreter had loaded at start).
- An AST scan of the port and of chip_smoke.py finds no such import.
- Without CUDA, ``python -m murmura_tpu_torch run`` without ``--device
  cpu`` fails with a message, and chip_smoke.py exits non-zero, printing
  no result; so does chip_smoke.py copied alone into an empty directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "murmura_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "murmura_tpu")

_PROBE = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import numpy as np
import torch
import murmura_tpu_torch
for info in pkgutil.walk_packages(murmura_tpu_torch.__path__, "murmura_tpu_torch."):
    if info.name != "murmura_tpu_torch.__main__":
        importlib.import_module(info.name)
from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.core.rounds import build_round_program, round_generators
from murmura_tpu_torch.data.registry import build_federated_data
from murmura_tpu_torch.models.cnn import make_femnist_cnn
from murmura_tpu_torch.ops.flatten import model_dimension
from murmura_tpu_torch.topology.generators import create_topology

data = build_federated_data("leaf.femnist", {"num_samples": 160}, num_nodes=8, seed=1)
attack = make_gaussian_attack(8, 0.25, seed=1)
adj = torch.from_numpy(create_topology("k-regular", 8, k=4).mask())
comp = torch.from_numpy(attack.compromised.astype(np.float32))
model = make_femnist_cnn(variant="tiny")
dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
for name, params in (("krum", {"num_compromised": 1}),
                     ("median", {"exchange_offsets": [1, 2, 6, 7]}),
                     ("sketchguard", {"sketch_size": 100})):
    agg = build_aggregator(name, params, model_dim=dim)
    prog = build_round_program(model, agg, data, attack=attack, batch_size=8, seed=1,
                               device="cpu")
    assert prog.model_dim == dim
    flat, _, _ = prog.train_step(prog.init_flat, prog.init_agg_state, adj, comp, 0.0,
                                 generators=round_generators(1, 0, "cpu"))
    assert bool(torch.isfinite(flat).all())
    prog.eval_step(flat)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "murmura_tpu"})
print("LOADED", bad)
"""


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_import_and_one_round_load_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_point_refuses_to_drop_to_cpu():
    _no_cuda()
    from murmura_tpu_torch.cli import resolve_device

    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "murmura_tpu_torch", "run",
         str(ROOT / "examples" / "configs" / "femnist_krum_tpu.yaml")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def _smoke(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""),
    )


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
