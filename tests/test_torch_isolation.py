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
  a gang round of two seeds (core/gang.py, through the CLI's ``sweep``),
  a sparse round on the exponential and one_peer graphs
  (topology/sparse.py), two population rounds across a swap (population/,
  a memory-mapped million-user bank), two DMTT rounds under mobility
  and the topology liar (dmtt/, topology/dynamic.py), a DMTT gang round
  of two seeds under mobility, a char-LSTM Krum round on int64 tokens
  (models/lstm.py, the synthetic_sequences adapter), an adaptive round
  (the bisection around the gaussian attack under Krum,
  attacks/adaptive.py), one frontier cell of two stages with its stage
  reset (frontier.py) and one grid bucket (serve/scheduler.py) whose
  manifest and daemon-free telemetry readers (telemetry/metrics.py,
  spans.py, registry.py, report.render_grid) run too, and one round of the
  ZMQ backend's LocalNode (distributed/local.py: train, Krum on its mini
  network, eval), loads no ``jax`` and no ``murmura_tpu.*`` module (counted
  against what the interpreter had loaded at start).
- Every module of the port imports where ``zmq`` cannot be imported.
- An AST scan of the port and of chip_smoke.py finds no such import.
- Without CUDA, ``python -m murmura_tpu_torch run`` without ``--device
  cpu`` fails with a message, as do a distributed node, its LocalNode and
  the DistributedRunner, and chip_smoke.py exits non-zero, printing
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
import yaml
from murmura_tpu_torch import cli
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.utils.factories import build_network_from_config
raw = yaml.safe_load(open("examples/configs/sweep_seeds.yaml"))
raw["experiment"]["rounds"] = 1
with tempfile.TemporaryDirectory() as tmp:
    cfg = tmp + "/sweep.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    histories, gang = cli.sweep(cfg, seeds=[1, 2], device="cpu")
    assert list(histories) == ["seed_1", "seed_2"] and gang.flats.shape[0] == 2
raw.pop("sweep")
for kind in ("exponential", "one_peer"):
    raw["topology"] = {"type": kind, "num_nodes": 8}
    net = build_network_from_config(Config.model_validate(raw), device="cpu")
    assert net.program.sparse and net.train(1)["round"] == [1]
raw["population"] = {"enabled": True, "virtual_size": 1000000, "sampler": "stratified"}
net = build_network_from_config(Config.model_validate(raw), device="cpu")
assert net.train(2)["round"] == [1, 2] and net.cohorts_seen == 2 and net.bank.path
net.bank.close()
raw = yaml.safe_load(open("examples/configs/dmtt_mobility.yaml"))
raw["experiment"].update(rounds=2, verbose=False)
raw["data"]["params"]["num_samples"] = 320
net = build_network_from_config(Config.model_validate(raw), device="cpu")
assert net.mobility is not None and len(net.train(2)["agg_dmtt_collab_count"]) == 2
from murmura_tpu_torch.utils.factories import build_gang_from_config
raw["topology"]["num_nodes"] = 8
raw["data"]["params"]["num_samples"] = 960
raw["training"]["max_samples"] = 24
raw["attack"]["params"]["seed"] = 42
gang = build_gang_from_config(Config.model_validate(raw), seeds=[42, 43], device="cpu")
assert gang.mobility is not None and len(gang.train(1)[1]["agg_dmtt_collab_count"]) == 1
seq = build_federated_data("synthetic_sequences", {"num_samples": 160, "seq_len": 10,
                                                   "vocab_size": 20}, num_nodes=8, seed=1)
lstm = build_model("leaf.shakespeare", {"vocab_size": 20, "hidden": 8, "seq_len": 10})
prog = build_round_program(lstm, build_aggregator("krum", {"num_compromised": 1}), seq,
                           attack=make_gaussian_attack(8, 0.25, seed=1), batch_size=8, seed=1,
                           device="cpu")
flat, _, _ = prog.train_step(prog.init_flat, prog.init_agg_state, adj, comp, 0.0,
                             generators=round_generators(1, 0, "cpu"))
assert prog.data["x"].dtype == torch.int64 and bool(torch.isfinite(flat).all())
from murmura_tpu_torch.attacks.adaptive import make_bisection_attack
from murmura_tpu_torch.frontier import run_cell
attack = make_bisection_attack(make_gaussian_attack(8, 0.25, seed=1))
prog = build_round_program(model, build_aggregator("krum", {"num_compromised": 1}), data,
                           attack=attack, batch_size=8, seed=1, device="cpu")
flat, state, metrics = prog.train_step(prog.init_flat, prog.init_agg_state, adj, comp, 0.0,
                                       generators=round_generators(1, 0, "cpu"))
assert "atk_scale" in state and "agg_atk_accept" in metrics
raw = yaml.safe_load(open("examples/configs/frontier_krum.yaml"))
raw["frontier"].update(rules=["krum"], attacks=["gaussian"], topologies=["dense"], points=2,
                       seeds=[7], stages=2, rounds=1)
cfg = Config.model_validate(raw)
cell = run_cell(cfg, cfg.frontier, "krum", "gaussian", "dense", [7], device="cpu")
assert cell.compiles == 1 and cell.curve
import murmura_tpu_torch.serve
from murmura_tpu_torch.serve.scheduler import run_grid
from murmura_tpu_torch.telemetry import metrics, registry, report, spans
raw = yaml.safe_load(open("examples/configs/serve_grid.yaml"))
raw["grid"].update(rules=["krum"], strengths=[0.0, 1.0], seeds=[7], rounds=1)
art = run_grid(Config.model_validate(raw), device="cpu")
assert art["total_cells"] == 2 and art["total_compiles"] == 1
report.render_grid(art, out=lambda line: None)
with tempfile.TemporaryDirectory() as tmp:
    cfg = Config.model_validate({**raw, "telemetry": {"enabled": True, "dir": tmp + "/run"}})
    cfg.grid = None
    build_network_from_config(cfg, device="cpu").train(1)
    text = metrics.render_openmetrics(metrics.fold_run_events(metrics.MetricsRegistry(),
                                                              tmp + "/run"))
    assert "murmura_rounds_total 1" in text and text.endswith("# EOF\n")
    assert spans.validate_spans(spans.build_spans(tmp + "/run")) == []
    assert [r["kind"] for r in registry.index_runs([tmp])] == ["run"]
from murmura_tpu_torch.distributed.local import LocalNode
from murmura_tpu_torch.models.mlp import make_mlp
rng = np.random.default_rng(0)
node = LocalNode(0, make_mlp(8, (8,), 3), build_aggregator("krum", {}),
                 rng.normal(size=(32, 8)).astype(np.float32), rng.integers(0, 3, 32),
                 max_neighbors=3, batch_size=8, device="cpu")
node.local_train(0)
own = node.get_flat_state()
node.aggregate_with_neighbors({1: own + 0.1, 2: own - 0.1}, 0)
assert np.isfinite(node.get_flat_state()).all() and node.evaluate()["loss"] > 0
assert "selected_index" in node.get_aggregator_statistics()
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


def test_port_imports_without_pyzmq():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['zmq'] = None\n"
        "import murmura_tpu_torch\n"
        "for info in pkgutil.walk_packages(murmura_tpu_torch.__path__, 'murmura_tpu_torch.'):\n"
        "    if info.name != 'murmura_tpu_torch.__main__':\n"
        "        importlib.import_module(info.name)\n"
        "print('IMPORTED')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "IMPORTED" in proc.stdout, proc.stderr[-4000:]


def test_distributed_nodes_refuse_to_drop_to_cpu(tmp_path):
    _no_cuda()
    import numpy as np

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.distributed.local import LocalNode
    from murmura_tpu_torch.distributed.node_process import resolve_node_device
    from murmura_tpu_torch.distributed.runner import DistributedRunner
    from murmura_tpu_torch.models.mlp import make_mlp

    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_node_device("cuda", 3)
    with pytest.raises(RuntimeError, match="--device cpu"):
        LocalNode(0, make_mlp(4, (4,), 2), build_aggregator("fedavg", {}),
                  np.zeros((8, 4), np.float32), np.zeros(8, np.int32), max_neighbors=1)
    cfg = Config.model_validate({
        "experiment": {"name": "x", "seed": 1, "rounds": 1},
        "topology": {"type": "ring", "num_nodes": 3},
        "aggregation": {"algorithm": "fedavg"},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.1},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 48, "input_dim": 4, "num_classes": 2}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 4, "hidden_dims": [4], "num_classes": 2}},
        "backend": "distributed",
        "distributed": {"ipc_dir": str(tmp_path)},
    })
    runner = DistributedRunner(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.start()
    assert runner.node_procs == [] and runner._monitor is None


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
