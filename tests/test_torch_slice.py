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
- Every example config the port does not run is refused by name, and
  ``basic_fedavg.yaml`` (fedavg, fully connected, the LEAF FEMNIST CNN)
  runs; so do ``ubar_attack.yaml`` (UBAR on an erdos graph) and UBAR on
  the flagship under ppermute, cut to the tiny CNN; and the three
  lever-free configs of evidential trust, ALIE and label flip, with the
  JAX package's history keys.
- The tiny flagship with ``aggregation: sketchguard`` (carried state, the
  ``total_rounds`` schedule) runs through both CLIs with the same history
  keys, the same acceptance and accuracy in the same band.
- ``chaos_churn.yaml`` (the fault model), ``compressed_exchange.yaml``
  (int8 with error feedback), ``telemetry_audit_report.yaml`` (telemetry
  and its audit taps over chaos_churn's faults), ``stale_gossip.yaml``
  (bounded staleness), ``resumable_run.yaml`` (durability) and
  ``pipelined_rounds.yaml`` (pipelined rounds, the recompile guard on),
  each cut to 3 rounds (pipelined_rounds as committed, 12), run through
  both CLIs, each package with its own telemetry and checkpoint
  directories, with the same history keys and ``agg_alive`` /
  ``agg_quarantined`` / ``agg_stale_used`` exactly equal (the fault
  schedule alone decides them), ``agg_pipe_valid`` [0, 1, ...] and each
  package's ``checkpoint`` events; the accuracy in the same band, except
  stale_gossip's (see ``BAND_EXEMPT``); and ``report <run_dir> --json``
  renders the port's telemetry run dir.  The config whose lever is still
  missing (gang sweeps) is refused, naming that lever and not the levers
  ported so far.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from murmura_tpu.config import load_config as jax_load_config
from murmura_tpu import levers as jax_levers
from murmura_tpu.core.network import empty_history as jax_empty_history
from murmura_tpu_torch import levers
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.utils.factories import ConfigError, build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples" / "configs").glob("*.yaml"))
FLAGSHIP = ROOT / "examples" / "configs" / "femnist_krum_tpu.yaml"
BASIC_FEDAVG = ROOT / "examples" / "configs" / "basic_fedavg.yaml"
# Final-round accuracy band between the two packages (independent RNGs;
# over seeds 7 and 8 the final accuracies differed by at most 0.05).
ACCURACY_BAND = 0.15
# The port's mean accuracy must gain at least this much over six rounds
# (it gains about 0.25 on this config).
MIN_CLIMB = 0.1


def _tiny_flagship(
    tmp_path: Path, exchange: str, algorithm: str = "krum", rounds: int = 6
) -> Path:
    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["experiment"].update(rounds=rounds, verbose=False)
    raw["model"]["factory"] = "leaf.femnist.tiny"
    raw["data"]["params"] = {"num_samples": 1600, "cluster_std": 0.5}
    raw["training"].update(local_epochs=2, batch_size=16, lr=0.02)
    raw["tpu"]["exchange"] = exchange
    if algorithm != "krum":
        raw["aggregation"] = {"algorithm": algorithm, "params": {}}
    path = tmp_path / f"tiny_{algorithm}_{exchange}.yaml"
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


def test_sketchguard_cli_matches_jax_package(tmp_path):
    # Every node starts from its own random initialisation, so averaging
    # with neighbours holds the accuracy near chance for these few rounds in
    # both packages (Krum above keeps each node's own state and climbs);
    # the check is the filter's decisions and the band.
    cfg = _tiny_flagship(tmp_path, "allgather", "sketchguard", rounds=4)
    ref = _run("murmura_tpu", cfg, tmp_path / "jax.json")
    got = _run("murmura_tpu_torch", cfg, tmp_path / "torch.json", "--device", "cpu")
    assert set(got) == set(ref)
    assert got["round"] == ref["round"] == list(range(1, 5))
    # The three std-10 senders are rejected by each of their 4 receivers, so
    # at most 52 of the 64 edges are accepted in any round.  The honest
    # edges' distances follow each package's own training draws, so the two
    # may part on an edge or two near the decaying threshold.
    for hist in (got, ref):
        assert max(hist["agg_acceptance_rate"]) <= 52 / 64
    assert got["agg_acceptance_rate"][0] == ref["agg_acceptance_rate"][0] == 52 / 64
    assert all(abs(a - b) <= 2 / 64 + 1e-9
               for a, b in zip(got["agg_acceptance_rate"], ref["agg_acceptance_rate"]))
    assert abs(got["mean_accuracy"][-1] - ref["mean_accuracy"][-1]) <= ACCURACY_BAND
    assert abs(got["honest_accuracy"][-1] - ref["honest_accuracy"][-1]) <= ACCURACY_BAND


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


PORTED = {"femnist_krum_tpu", "basic_fedavg", "ubar_attack", "uci_har_byzantine",
          "uci_har_dirichlet", "pamap2_dirichlet", "uci_har_evidential_trust",
          "alie_geometric_median", "label_flip_poisoning", "chaos_churn",
          "compressed_exchange", "telemetry_audit_report", "stale_gossip",
          "resumable_run", "pipelined_rounds"}


@pytest.mark.parametrize(
    "path", [p for p in EXAMPLES if p.stem not in PORTED], ids=lambda p: p.stem
)
def test_unported_examples_refused_by_name(path):
    config = load_config(path)
    with pytest.raises((ConfigError, ValueError), match="not ported|does not run"):
        build_network_from_config(config, device="cpu")


# Configs refused for a lever the port still lacks: the lever the message names.
STILL_REFUSED = {
    "sweep_seeds": "sweep",
}


@pytest.mark.parametrize("name", sorted(STILL_REFUSED))
def test_configs_with_missing_levers_name_them(name):
    config = load_config(ROOT / "examples" / "configs" / f"{name}.yaml")
    with pytest.raises(ConfigError, match="does not run") as err:
        build_network_from_config(config, device="cpu")
    assert STILL_REFUSED[name] in str(err.value)
    # The levers ported so far are no longer among the refusals.
    for lever in ("faults", "compression", "rounds_per_dispatch", "telemetry",
                  "max_staleness", "durability", "pipeline"):
        assert lever not in str(err.value)


# stale_gossip.yaml: Krum c = 0 on non-IID (Dirichlet 0.3) shards of 30
# samples adopts one neighbour's model a round, so its accuracy after 3
# rounds spreads with the initial draw.  Through the two CLIs on the CPU,
# with the staleness on, seeds 1-5 and 42 ended at 0.22-0.45 (JAX package)
# and 0.11-0.29 (port); with it off, seeds 1-7 and 42 at 0.30-0.41 and
# 0.05-0.54; without faults at 0.14-0.58 and 0.07-0.51: wider than the
# band.  The stale rounds are held to a scaled 1e-4 from the same draws in
# tests/test_torch_stale.py instead.
BAND_EXEMPT = {"stale_gossip"}
# pipelined_rounds.yaml runs its 12 rounds as committed: after 3, its
# accuracy (8 nodes, 64 eval samples) spreads with the draws, at seeds 1-5
# and 42 0.34-0.50 (JAX package) and 0.33-0.64 (port) through the two
# packages' networks on the CPU; after 12, 0.70-0.86 and 0.64-0.84, each
# seed's pair within 0.15.  The pipelined rounds are held to a scaled 1e-4
# from the same draws in tests/test_torch_pipeline.py.
FULL_ROUNDS = {"pipelined_rounds": 12}


@pytest.mark.parametrize(
    "name", ["chaos_churn", "compressed_exchange", "telemetry_audit_report", "stale_gossip",
             "resumable_run", "pipelined_rounds"])
def test_lever_configs_cli_match_jax_package(tmp_path, name):
    raw = yaml.safe_load((ROOT / "examples" / "configs" / f"{name}.yaml").read_text())
    rounds = FULL_ROUNDS.get(name, 3)
    raw["experiment"].update(rounds=rounds, verbose=False)
    cfgs = {}
    # Each package its own run and snapshot directories: each refuses the
    # other's snapshot, and resume: true would try to read it.
    for pkg in ("jax", "torch"):
        if "telemetry" in raw:
            raw["telemetry"]["dir"] = str(tmp_path / f"run_{pkg}")
        if "durability" in raw:
            raw["durability"]["checkpoint_dir"] = str(tmp_path / f"ckpt_{pkg}")
        cfgs[pkg] = tmp_path / f"{name}_{pkg}.yaml"
        cfgs[pkg].write_text(yaml.safe_dump(raw, sort_keys=False))
    ref = _run("murmura_tpu", cfgs["jax"], tmp_path / "jax.json")
    got = _run("murmura_tpu_torch", cfgs["torch"], tmp_path / "torch.json", "--device", "cpu")
    assert set(got) == set(ref)
    assert got["round"] == ref["round"] == list(range(1, rounds + 1))
    if name in ("chaos_churn", "telemetry_audit_report"):
        for k in ("agg_alive", "agg_quarantined", "agg_attack_scrubbed"):
            assert got[k] == ref[k], k
        assert got["agg_quarantined"] != [0.0] * 3  # node 2 diverges whenever it is alive
    if name == "compressed_exchange":
        assert {"agg_compress_error", "agg_compress_residual_norm"} <= set(got)
    if name == "telemetry_audit_report":
        assert {"agg_tap_quarantined", "agg_tap_alive", "agg_tap_selected_by"} <= set(got)
        # Krum's in-degree under the faults is the schedule's.
        assert got["agg_tap_considered_by"] == ref["agg_tap_considered_by"]
    if name == "stale_gossip":
        for k in ("agg_alive", "agg_stale_used", "agg_stale_expired", "agg_tap_stale_used",
                  "agg_tap_stale_age"):
            assert got[k] == ref[k], k
        assert got["agg_stale_used"][-1] > 0  # the cache serves from round 2 on
    if name == "pipelined_rounds":
        assert got["agg_pipe_valid"] == ref["agg_pipe_valid"] == [0.0] + [1.0] * 11
    if name == "resumable_run":
        for pkg in ("jax", "torch"):
            saves = [json.loads(line) for line in
                     (tmp_path / f"run_{pkg}" / "events.jsonl").read_text().splitlines()]
            saves = [e for e in saves if e["type"] == "checkpoint"]
            assert [(e["action"], e["round"]) for e in saves] == [("save", 3)], pkg
            assert (tmp_path / f"ckpt_{pkg}" / "meta.json").exists(), pkg
    if name not in BAND_EXEMPT:
        for k in ("mean_accuracy", "honest_accuracy"):
            assert abs(got[k][-1] - ref[k][-1]) <= ACCURACY_BAND, k
    for k, v in got.items():
        assert all(math.isfinite(x) for x in v), k


def test_report_json_renders_the_ports_run_dir(tmp_path):
    raw = yaml.safe_load((ROOT / "examples" / "configs" / "telemetry_audit_report.yaml")
                         .read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    raw["telemetry"]["dir"] = str(tmp_path / "run")
    cfg = tmp_path / "tar.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    _run("murmura_tpu_torch", cfg, tmp_path / "torch.json", "--device", "cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "murmura_tpu_torch", "report", str(tmp_path / "run"), "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(proc.stdout)
    assert "manifest" not in rep and rep["accuracy"]["rounds_recorded"] == 2
    assert len(rep["taps"]["considered_by"]) == len(rep["faults"]["alive_rounds"]) == 8
    assert rep["faults"]["quarantined_rounds"][2] == rep["faults"]["alive_rounds"][2] > 0
    assert rep["influence"]["rule"] == "krum" and rep["time"]["rounds_timed"] == 2
    missing = subprocess.run(
        [sys.executable, "-m", "murmura_tpu_torch", "report", str(tmp_path / "none")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert missing.returncode == 1 and "no readable manifest.json" in missing.stderr


def test_basic_fedavg_runs_on_cpu():
    # As committed except for less training per round (the baseline CNN at
    # full width trains slowly on the CPU): fewer samples, one local epoch.
    config = load_config(BASIC_FEDAVG)
    config.training.max_samples = 160
    config.training.local_epochs = 1
    network = build_network_from_config(config, device="cpu")
    history = network.train(rounds=2)
    assert history["round"] == [1, 2]
    assert history["agg_num_neighbors"] == [4.0, 4.0]  # fully connected, 5 nodes
    assert all(0.0 <= a <= 1.0 for a in history["mean_accuracy"])
    assert bool(torch.isfinite(network.flat).all())


# The rule stats each lever-free config records (the JAX package's agg_* keys).
LEVER_FREE = {
    "uci_har_evidential_trust": ("acceptance_rate", "mean_trust", "mean_vacuity",
                                 "mean_entropy", "threshold"),
    "alie_geometric_median": ("num_candidates", "max_weight_share", "mean_dist_to_gm"),
    "label_flip_poisoning": ("num_candidates", "trimmed_per_side"),
}


@pytest.mark.parametrize("name", sorted(LEVER_FREE))
def test_lever_free_configs_run_on_cpu(name):
    # As committed except for the data size (fewer synthetic samples) and
    # two rounds; the wearable MLP keeps its published widths.
    config = load_config(ROOT / "examples" / "configs" / f"{name}.yaml")
    config.data.params = {**config.data.params, "num_samples": 40 * config.topology.num_nodes}
    config.experiment.rounds = 2
    config.experiment.verbose = False
    network = build_network_from_config(config, device="cpu")
    history = network.train(rounds=2)
    assert set(history) == set(jax_empty_history()) | {f"agg_{k}" for k in LEVER_FREE[name]}
    for k, v in history.items():
        assert len(v) == 2 and all(math.isfinite(x) for x in v), k
    assert bool(torch.isfinite(network.flat).all())
    if name == "uci_har_evidential_trust":
        # The probe takes max_eval_samples (100) a node, not the batch (32).
        s = network.program.data["x"].shape[1]
        assert network.program.data["probe_x"].shape[1] == min(100, s) > 32
        assert min(history["agg_acceptance_rate"]) < 1.0  # the std-10 senders rejected
    if name == "label_flip_poisoning":
        # The compromised nodes train on rotated labels.
        assert network.attack.trains_locally and network.attack.data_poison_fn is not None


@pytest.mark.parametrize("which", ["ubar_attack", "flagship_ppermute"])
def test_ubar_runs_on_cpu(tmp_path, which):
    # The committed config with the tiny CNN, 12 nodes, fewer samples and
    # two rounds; the flagship with algorithm: ubar under ppermute.
    if which == "ubar_attack":
        raw = yaml.safe_load((ROOT / "examples" / "configs" / "ubar_attack.yaml").read_text())
        raw["topology"]["num_nodes"] = 12
    else:
        raw = yaml.safe_load(FLAGSHIP.read_text())
        raw["aggregation"] = {"algorithm": "ubar", "params": {"rho": 0.8}}
        raw["tpu"]["exchange"] = "ppermute"
    raw["experiment"].update(rounds=2, verbose=False)
    raw["model"] = {"factory": "leaf.femnist.tiny", "params": {}}
    raw["data"]["params"] = {"num_samples": 40 * raw["topology"]["num_nodes"]}
    raw["training"].update(local_epochs=1, batch_size=16)
    path = tmp_path / f"{which}.yaml"
    path.write_text(yaml.safe_dump(raw))
    network = build_network_from_config(load_config(path), device="cpu")
    history = network.train(rounds=2)
    for k in ("agg_stage1_acceptance_rate", "agg_stage2_acceptance_rate", "agg_own_loss"):
        assert len(history[k]) == 2 and all(v == v for v in history[k]), k
    # The std-10 broadcasts are never accepted, so some neighbour is dropped.
    assert min(history["agg_stage1_acceptance_rate"]) < 1.0
    assert bool(torch.isfinite(network.flat).all())


@pytest.mark.parametrize("algorithm", ["balance", "sketchguard", "ubar"])
def test_bfloat16_params_train_records_finite_stats(tmp_path, algorithm):
    # These rules' stats come out in the parameters' dtype; numpy has no
    # bfloat16, so Network.train must widen them before the host copy.
    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    raw["topology"] = {"type": "k-regular", "num_nodes": 8, "k": 4}
    raw["aggregation"] = {"algorithm": algorithm, "params": {}}
    raw["model"] = {"factory": "leaf.femnist.tiny", "params": {}}
    raw["data"]["params"] = {"num_samples": 8 * 40}
    raw["training"].update(local_epochs=1, batch_size=16)
    raw["tpu"]["param_dtype"] = "bfloat16"
    path = tmp_path / f"{algorithm}_bf16.yaml"
    path.write_text(yaml.safe_dump(raw))
    network = build_network_from_config(load_config(path), device="cpu")
    history = network.train(rounds=2)
    assert network.flat.dtype == torch.bfloat16
    stats = [k for k in history if k.startswith("agg_")]
    assert stats
    for k in stats:
        assert len(history[k]) == 2, k
        assert all(isinstance(v, float) and math.isfinite(v) for v in history[k]), k


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
