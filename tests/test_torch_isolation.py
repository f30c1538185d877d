"""The port stands alone: it imports nothing of JAX or of the JAX package,
and it never moves to the CPU unless asked to.

- In a fresh interpreter, importing every module of ``murmura_tpu_torch``
  and running one CPU round each of Krum, the circulant median,
  Sketchguard, UBAR (both exchanges), an evidential wearable-MLP round,
  evidential trust (both exchanges), the geometric median under ALIE, a
  faulted, int8-compressed Krum round under ppermute fused into a chunk,
  two stale Krum rounds with audit taps through a Network that writes
  a telemetry run dir, read back by the port's report, and two pipelined
  Krum rounds snapshotted, restored into a new Network and resumed for a
  round (durability/ and core/pipeline.py, the retry envelope around it),
  loads no ``jax`` and no ``murmura_tpu.*`` module (counted against what
  the interpreter had loaded at start).
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
from murmura_tpu_torch.models.registry import build_model
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
                     ("sketchguard", {"sketch_size": 100}),
                     ("ubar", {"rho": 0.8}),
                     ("ubar", {"rho": 0.8, "exchange_offsets": [1, 2, 6, 7]}),
                     ("wearables", {"num_compromised": 1}),
                     ("evidential_trust", {}),
                     ("evidential_trust", {"exchange_offsets": [1, 2, 6, 7]}),
                     ("alie", {})):
    if name == "alie":
        from murmura_tpu_torch.attacks.alie import make_alie_attack
        attack = make_alie_attack(8, 0.25, seed=1)
        name = "geometric_median"
    if name == "wearables":
        data = build_federated_data("wearables.uci_har", {"num_samples": 160}, num_nodes=8,
                                    seed=1)
        model = build_model("wearables.uci_har", {})
        name = "krum"
    agg = build_aggregator(name, params, model_dim=dim)
    prog = build_round_program(model, agg, data, attack=attack, batch_size=8, seed=1,
                               device="cpu")
    assert prog.model_dim == model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    flat, _, _ = prog.train_step(prog.init_flat, prog.init_agg_state, adj, comp, 0.0,
                                 generators=round_generators(1, 0, "cpu"))
    assert bool(torch.isfinite(flat).all())
    prog.eval_step(flat)
from murmura_tpu_torch.core.rounds import build_multi_round
from murmura_tpu_torch.faults.schedule import FaultSchedule, FaultSpec
from murmura_tpu_torch.ops.compress import CompressionSpec
agg = build_aggregator("krum", {"num_compromised": 1, "exchange_offsets": [1, 2, 6, 7]})
prog = build_round_program(model, agg, data, attack=attack, batch_size=8, seed=1, device="cpu",
                           faults=FaultSpec(nan_inject_nodes=(2,)),
                           compression=CompressionSpec("int8", error_feedback=True))
sched = FaultSchedule(8, crash_prob=0.3, recovery_prob=0.5, seed=1)
adj_stack = torch.from_numpy(np.stack([sched.masked_adjacency(adj.numpy(), r) for r in range(2)]))
flat, state, rows = build_multi_round(prog, 2, 1)(
    prog.init_flat, prog.init_agg_state, 1, adj_stack, comp, 0,
    alive_stack=torch.from_numpy(sched.alive_stack(0, 2)))
assert bool(torch.isfinite(flat).all()) and len(rows) == 2
assert "agg_quarantined" in rows[0][1] and "compress_residual" in state
import tempfile
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.core.stale import StalenessSpec
from murmura_tpu_torch.telemetry.report import build_report
from murmura_tpu_torch.telemetry.writer import TelemetryWriter
agg = build_aggregator("krum", {})
prog = build_round_program(model, agg, data, batch_size=8, seed=1, device="cpu",
                           faults=FaultSpec(), audit_taps=True,
                           staleness=StalenessSpec(2, 0.7, base_mask=adj.numpy()))
sched = FaultSchedule(8, straggler_prob=0.3, link_drop_prob=0.3, seed=1)
with tempfile.TemporaryDirectory() as run_dir:
    writer = TelemetryWriter(run_dir, memory_stats=True)
    net = Network(prog, create_topology("k-regular", 8, k=4), seed=1, fault_schedule=sched,
                  telemetry=writer)
    hist = net.train(2)
    writer.close()
    assert "agg_tap_stale_used" in hist and "stale_cache" in net.agg_state
    assert build_report(run_dir)["staleness"]["stale_in_edges"]
from murmura_tpu_torch.durability import RetryPolicy, run_with_retry
topo = create_topology("k-regular", 8, k=4)
with tempfile.TemporaryDirectory() as ckpt:
    def pipelined():
        prog = build_round_program(model, build_aggregator("krum", {}), data, batch_size=8,
                                   seed=1, device="cpu", pipeline=True)
        return Network(prog, topo, seed=1)
    net = pipelined()
    net.train(2, checkpoint_dir=ckpt)
    resumed = pipelined()
    assert run_with_retry(lambda i: resumed.restore_checkpoint(ckpt),
                          policy=RetryPolicy(max_retries=1)) == 2
    hist = resumed.train(1)
    assert hist["agg_pipe_valid"] == [0.0, 1.0, 1.0]
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
