"""Telemetry in the port against the JAX package, on the CPU.

- The writer: a run killed before it finalizes leaves a readable manifest
  (``finalized: false``) and a valid event prefix, a torn last line
  included, read by either package's reader; a fresh run into the same
  directory rotates the old stream and manifest to ``*.prev``.  The CPU's
  memory event says ``stats: null``.
- The audit taps of every rule that taps (Krum, BALANCE, UBAR, evidential
  trust), dense and circulant, against the JAX rules on the same own /
  bcast / adjacency: every ``tap_*`` exactly equal, except evidential
  trust's ``tap_trust_received``, a mean of trust values from the probe
  forwards, within rtol 1e-5 (the trust tolerance of
  tests/test_torch_evidential_trust.py).  The rules that tap nothing in
  the JAX package tap nothing in the port, and every rule declares the
  JAX package's influence contract.
- One faulted round of the 16-32-4 MLP through both round programs with
  the audit taps on (a dead node, a NaN-injected node, an IPM attacker
  whose broadcast overflows): ``tap_quarantined``, ``tap_attack_scrubbed``
  and ``tap_alive`` exactly equal.
- The history is bit-equal with telemetry off and on with audit taps (the
  taps only add ``agg_tap_*`` columns); ``phase_times`` record per-round
  wall times, or ``elapsed/k`` over a fused chunk with the mode saying
  which; each round event's ``in_degree`` is the column sums of the
  adjacency staged for it.
- The profiler window: a torch.profiler trace written as Chrome trace JSON
  with the ``profile`` started/stopped events, opened by a chunk that
  overlaps it; ``run --profile`` traces the whole run.
- Cross-reading: telemetry_audit_report.yaml and stale_gossip.yaml, cut to
  3 rounds, run through both packages; each package's ``build_report``
  reads both run directories to the same per-node sections, and the
  sections the fault schedule alone decides (alive, quarantined,
  considered, stale in-edges and ages) are equal between the two runs.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.attacks.ipm import make_ipm_attack as jax_ipm
from murmura_tpu.config import load_config as jax_load_config
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.faults.schedule import FaultSpec as JaxSpec
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.telemetry import report as jax_report
from murmura_tpu.telemetry import writer as jax_writer
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu.utils.factories import build_network_from_config as jax_build_network
from murmura_tpu_torch import cli
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.attacks.ipm import make_ipm_attack
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.core.network import effective_adjacency
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops.flatten import make_flatteners, tree_to_torch
from murmura_tpu_torch.telemetry import report
from murmura_tpu_torch.telemetry.schema import EVENTS_FILE, MANIFEST_FILE
from murmura_tpu_torch.telemetry.writer import (
    TelemetryWriter,
    events_of_type,
    iter_events,
    read_manifest,
)
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "examples" / "configs"


# ---------------------------------------------------------------------------
# the writer

_KILLED = r"""
import os, sys
from murmura_tpu_torch.telemetry.writer import TelemetryWriter
w = TelemetryWriter(sys.argv[1])
for r in range(3):
    w.round_event(r + 1, {"accuracy": [0.5, 0.25], "agg_tap_selected_by": [1.0, 0.0]},
                  in_degree=[1.0, 1.0])
w._events.write('{"type": "round", "seq": 9, "metr')  # torn mid-line
w._events.flush()
os._exit(9)  # killed: no finalize, no close
"""


def test_killed_run_leaves_a_valid_event_prefix(tmp_path):
    run = tmp_path / "run"
    proc = subprocess.run([sys.executable, "-c", _KILLED, str(run)], cwd=ROOT, timeout=120)
    assert proc.returncode == 9
    for read, manifest in ((iter_events, read_manifest),
                           (jax_writer.iter_events, jax_writer.read_manifest)):
        events = list(read(run))
        assert [e["type"] for e in events] == ["run", "round", "round", "round"]
        assert [e["seq"] for e in events] == [0, 1, 2, 3]
        assert [e["round"] for e in events[1:]] == [1, 2, 3]
        m = manifest(run)
        assert m["schema_version"] == 2 and m["finalized"] is False and m["kind"] == "run"


def test_fresh_run_into_the_same_dir_rotates(tmp_path):
    run = tmp_path / "run"
    w = TelemetryWriter(run)
    w.phase_times(0, "per_round", 0.5)
    w.finalize(history={"round": [1]})
    w.close()
    first = read_manifest(run)["run_id"]
    w = TelemetryWriter(run)  # a fresh run into the same directory
    w.close()
    assert [e["type"] for e in iter_events(run)] == ["run"]
    prev = json.loads((run / (MANIFEST_FILE + ".prev")).read_text())
    assert prev["run_id"] == first and prev["finalized"] and prev["history"] == {"round": [1]}
    with open(run / (EVENTS_FILE + ".prev")) as f:
        assert [json.loads(line)["type"] for line in f] == ["run", "phase_times"]
    assert read_manifest(run)["run_id"] != first and not read_manifest(run)["finalized"]


def test_cpu_memory_event_has_no_stats(tmp_path):
    w = TelemetryWriter(tmp_path / "run", memory_stats=True)
    w.memory_event(3, "cpu")
    w.close()
    (e,) = events_of_type(tmp_path / "run", "memory")
    assert e["round"] == 3 and e["stats"] is None and e["device_kind"] == "cpu"
    w = TelemetryWriter(tmp_path / "off")
    w.memory_event(3, "cpu")
    w.close()
    assert events_of_type(tmp_path / "off", "memory") == []


# ---------------------------------------------------------------------------
# the rules' taps

N, B = 12, 10
IN_DIM, HIDDEN, K = 20, (32, 16), 5
OFFSETS = [1, 2, 10, 11]  # k-regular(4) on 12 nodes
POISONED = [2, 7]
TAPPING = {"krum": {"num_compromised": 1}, "balance": {}, "ubar": {"rho": 0.8},
           "evidential_trust": {}}


def _circulant_adj(n, offsets):
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
    return adj


def _setup(evidential, seed=5):
    """(jax ctx, port ctx, own, bcast) on spread MLP states, two of them
    broadcasting noise of std 10, with per-node probe batches."""
    jmodel = jax_mlp(IN_DIM, HIDDEN, K, evidential=evidential)
    template = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    flat0, j_unravel = ravel_pytree(template)
    rng = np.random.default_rng(seed)
    spread = 0.2 * (1.0 + np.arange(N) / N)
    own = (np.asarray(flat0)[None] + spread[:, None] * rng.normal(size=(N, flat0.size)))
    own = own.astype(np.float32)
    bcast = own.copy()
    bcast[POISONED] += (10.0 * rng.normal(size=(len(POISONED), flat0.size))).astype(np.float32)
    px = rng.normal(size=(N, B, IN_DIM)).astype(np.float32)
    py = rng.integers(0, K, size=(N, B)).astype(np.int32)
    pm = (rng.random((N, B)) < 0.9).astype(np.float32)
    jctx = JaxCtx(apply_fn=jmodel.apply, unravel=j_unravel, probe_x=jnp.asarray(px),
                  probe_y=jnp.asarray(py), probe_mask=jnp.asarray(pm), evidential=evidential,
                  num_classes=K, total_rounds=10, audit=True)
    _, t_unravel, _ = make_flatteners(tree_to_torch(template))
    tctx = AggContext(apply_fn=make_mlp(IN_DIM, HIDDEN, K, evidential=evidential).apply,
                      unravel=t_unravel, probe_x=torch.from_numpy(px),
                      probe_y=torch.from_numpy(py).long(), probe_mask=torch.from_numpy(pm),
                      evidential=evidential, num_classes=K, total_rounds=10, audit=True)
    return jctx, tctx, own, bcast


@pytest.mark.parametrize("exchange", ["dense", "dense_fractional", "circulant"])
@pytest.mark.parametrize("rule", sorted(TAPPING))
def test_rule_taps_match_jax(rule, exchange):
    jctx, tctx, own, bcast = _setup(evidential=rule == "evidential_trust")
    adj = _circulant_adj(N, OFFSETS)
    kw = dict(TAPPING[rule])
    if exchange == "circulant":
        kw["exchange_offsets"] = OFFSETS
    if exchange == "dense_fractional":
        # Stale re-added edges (core/stale.py) weigh 0.7 and 0.49.
        adj[0, 1], adj[3, 4], adj[5, 3], adj[9, 11] = 0.7, 0.49, 0.7, 0.49
    jr, tr = JAX_AGGREGATORS[rule](**kw), AGGREGATORS[rule](**kw)
    j_state = {k: jnp.asarray(v) for k, v in jr.init_state(N).items()}
    t_state = {k: torch.as_tensor(v) for k, v in tr.init_state(N).items()}
    _, _, js = jr.aggregate(jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
                            jnp.asarray(1.0, jnp.float32), j_state, jctx)
    _, _, ts = tr.aggregate(torch.from_numpy(own), torch.from_numpy(bcast),
                            torch.from_numpy(adj), 1.0, t_state, tctx)
    j_taps = {k for k in js if k.startswith("tap_")}
    assert j_taps and {k for k in ts if k.startswith("tap_")} == j_taps
    for k in j_taps:
        got, ref = ts[k].numpy(), np.asarray(js[k])
        assert got.shape == ref.shape == (N,), k
        if k == "tap_trust_received":
            np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    # The taps add stats; the rule's own stats keep their names.
    assert {k for k in ts if not k.startswith("tap_")} == {
        k for k in js if not k.startswith("tap_")}
    if "tap_selected_by" in ts and rule != "evidential_trust":
        # Someone rejected a poisoned sender.
        assert any(ts["tap_considered_by"][p] > ts["tap_selected_by"][p] for p in POISONED)


@pytest.mark.parametrize("rule", sorted(AGGREGATORS))
def test_untapping_rules_tap_nothing_and_declarations_match(rule):
    jr = JAX_AGGREGATORS[rule](**({"model_dim": 64} if rule == "sketchguard" else {}))
    tr = AGGREGATORS[rule](**({"model_dim": 64} if rule == "sketchguard" else {}))
    assert (tr.influence.kind, tr.influence.note) == (jr.influence.kind, jr.influence.note)
    for k in range(1, 9):
        assert tr.influence.describe(k) == jr.influence.describe(k)
    if rule in TAPPING:
        return
    own = np.random.default_rng(0).normal(size=(6, 64)).astype(np.float32)
    adj = _circulant_adj(6, [1, 5])
    state = {k: torch.as_tensor(v) for k, v in tr.init_state(6).items()}
    _, _, stats = tr.aggregate(torch.from_numpy(own), torch.from_numpy(own),
                               torch.from_numpy(adj), 0.0, state, AggContext(audit=True))
    assert not any(k.startswith("tap_") for k in stats)


# ---------------------------------------------------------------------------
# the faulted round's taps

FN, SEED = 8, 3
DEAD, NAN_NODE, ATTACKER = 5, 2, 3
DATA = {"num_samples": 640, "input_dim": 16, "num_classes": 4}
HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)


def test_faulted_round_taps_match_jax():
    data = jax_data("synthetic", DATA, num_nodes=FN, seed=SEED)
    spec = dict(nan_quarantine=True, nan_inject_nodes=(NAN_NODE,), nan_inject_from_round=0)
    jattack = jax_ipm(FN, 0.125, epsilon=1e39, seed=SEED)
    jprog = jax_build_round(jax_mlp(16, [32], 4), jax_make_krum(num_compromised=1), data,
                            attack=jattack, faults=JaxSpec(**spec), audit_taps=True, **HP)
    rng = np.random.default_rng(SEED)
    scale = 0.05 * (1.0 + np.arange(FN) / FN)
    init = jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((FN,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)
    adj = jax_topology("fully", FN).mask()
    alive = np.ones(FN, np.float32)
    alive[DEAD] = 0.0
    comp = jattack.compromised.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    _, _, j_metrics = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key,
        jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(alive),
        jnp.asarray(0.0, jnp.float32),
        {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()},
    )
    train_key, _ = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))
    prog = build_round_program(make_mlp(16, [32], 4), make_krum(num_compromised=1), data,
                               attack=make_ipm_attack(FN, 0.125, epsilon=1e39, seed=SEED),
                               faults=FaultSpec(**spec), init_params=init, audit_taps=True,
                               device="cpu", **HP)
    _, _, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.from_numpy(comp),
        0.0, draws={"u": [u]}, alive=torch.from_numpy(alive))
    assert set(metrics) == set(j_metrics)
    for k in ("agg_tap_quarantined", "agg_tap_attack_scrubbed", "agg_tap_alive",
              "agg_tap_selected_by", "agg_tap_considered_by"):
        np.testing.assert_array_equal(metrics[k].numpy(), np.asarray(j_metrics[k]), err_msg=k)
    assert metrics["agg_tap_quarantined"].tolist() == [float(i == NAN_NODE) for i in range(FN)]
    assert metrics["agg_tap_attack_scrubbed"].tolist() == [float(i == ATTACKER)
                                                          for i in range(FN)]
    assert metrics["agg_tap_alive"].tolist() == alive.tolist()


# ---------------------------------------------------------------------------
# through the orchestrator


def _config(name, tmp_path, rounds=3, **telemetry):
    config = load_config(CONFIGS / f"{name}.yaml")
    config.experiment.verbose = False
    config.experiment.rounds = rounds
    config.telemetry.dir = str(tmp_path / f"{name}_port")
    for k, v in telemetry.items():
        setattr(config.telemetry, k, v)
    return config


def test_history_bit_equal_with_telemetry_off_and_on(tmp_path):
    on = _config("telemetry_audit_report", tmp_path)
    off = _config("telemetry_audit_report", tmp_path, enabled=False, audit_taps=False,
                  phase_times=False, memory_stats=False)
    h0 = build_network_from_config(off, device="cpu").train(3)
    net = build_network_from_config(on, device="cpu")
    h1 = net.train(3)
    for k, v in h0.items():
        assert h1[k] == v, k
    assert {k for k in h1 if k not in h0} == {
        "agg_tap_selected_by", "agg_tap_considered_by", "agg_tap_quarantined",
        "agg_tap_attack_scrubbed", "agg_tap_alive"}
    run = Path(on.telemetry.dir)
    m = read_manifest(run)
    assert m["finalized"] and m["history"] == json.loads(json.dumps(h1))
    records = events_of_type(run, "phase_times")
    assert [r["round"] for r in records] == [0, 1, 2]
    assert all(r["mode"] == "per_round" and r["evaluated"] and not r["deferred"]
               for r in records)
    assert [r["wall_s"] for r in records] == pytest.approx(net.round_times)
    assert [e["round"] for e in events_of_type(run, "memory")] == [0, 1, 2]
    # in_degree: the column sums of the adjacency staged for the round.
    for e in events_of_type(run, "round"):
        adj = effective_adjacency(net.topology, None, net.fault_schedule, e["round"] - 1)
        assert e["in_degree"] == adj.sum(axis=0).tolist()
        assert len(e["metrics"]["agg_tap_alive"]) == 8


def test_fused_phase_times_and_profile_window_mid_chunk(tmp_path):
    config = _config("stale_gossip", tmp_path, rounds=4, profile_start_round=1,
                     profile_rounds=1, profile_dir=str(tmp_path / "trace"))
    net = build_network_from_config(config, device="cpu")
    net.train(4, rounds_per_dispatch=3)
    run = Path(config.telemetry.dir)
    records = events_of_type(run, "phase_times")
    assert [(r["round"], r["mode"], r["chunk"]) for r in records] == [
        (0, "fused", 3), (1, "fused", 3), (2, "fused", 3), (3, "fused", 1)]
    assert [r["wall_s"] for r in records] == pytest.approx(net.round_times)
    prof = events_of_type(run, "profile")
    # The window [1, 2) lies inside the first chunk [0, 3): it opens there.
    assert [(e["status"], e["round"]) for e in prof] == [("started", 0), ("stopped", 2)]
    trace = json.loads(Path(prof[1]["trace_file"]).read_text())
    assert trace["traceEvents"]
    assert Path(prof[1]["trace_file"]).parent == tmp_path / "trace"


def test_run_profile_traces_the_whole_run(tmp_path, monkeypatch):
    raw = yaml.safe_load((CONFIGS / "stale_gossip.yaml").read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    raw["telemetry"] = {"enabled": False}
    raw["exchange"] = {"max_staleness": 0}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    monkeypatch.chdir(tmp_path)  # the default run dir is relative
    _, network = cli.run(path, device="cpu", profile=True)
    run = tmp_path / "murmura_runs" / "stale-gossip"
    prof = events_of_type(run, "profile")
    assert [(e["status"], e["round"]) for e in prof] == [("started", 0), ("stopped", 1)]
    trace = tmp_path / prof[1]["trace_file"]
    assert trace.parent == run / "trace" and json.loads(trace.read_text())["traceEvents"]
    assert network.telemetry is not None


def test_tpu_profile_dir_traces_each_train_call(tmp_path):
    config = _config("stale_gossip", tmp_path, rounds=2, profile_rounds=1)
    config.tpu.profile_dir = str(tmp_path / "whole")
    net = build_network_from_config(config, device="cpu")
    net.train(1)
    net.train(1)
    traces = sorted(p.name for p in (tmp_path / "whole").iterdir())
    assert traces == ["train_0-0.pt.trace.json", "train_1-1.pt.trace.json"]
    # The telemetry window does not nest inside the whole-run trace.
    assert events_of_type(Path(config.telemetry.dir), "profile") == []


# ---------------------------------------------------------------------------
# cross-reading


SECTIONS = ("faults", "taps", "staleness", "influence")
SCHEDULE_DECIDED = {
    "faults": ("alive_rounds", "quarantined_rounds", "scrubbed_rounds"),
    "taps": ("considered_by",),
    "staleness": ("stale_in_edges", "total_stale_edges", "age_histogram"),
}


@pytest.mark.parametrize("name", ["telemetry_audit_report", "stale_gossip"])
def test_both_reports_read_both_run_dirs(tmp_path, name):
    port_cfg = _config(name, tmp_path)
    build_network_from_config(port_cfg, device="cpu").train(3)
    jcfg = jax_load_config(CONFIGS / f"{name}.yaml")
    jcfg.experiment.verbose = False
    jcfg.experiment.rounds = 3
    jcfg.telemetry.dir = str(tmp_path / f"{name}_jax")
    jax_build_network(jcfg).train(3)
    reports = {}
    for who, run in (("port", port_cfg.telemetry.dir), ("jax", jcfg.telemetry.dir)):
        got, ref = report.build_report(run), jax_report.build_report(run)
        for section in SECTIONS + ("accuracy", "robustness", "memory"):
            assert got.get(section) == ref.get(section), (who, section)
        assert got["time"]["rounds_timed"] == ref["time"]["rounds_timed"] == 3
        reports[who] = got
    for section, keys in SCHEDULE_DECIDED.items():
        for k in keys:
            if k in reports["jax"].get(section, {}):
                assert reports["port"][section][k] == reports["jax"][section][k], (section, k)
    assert reports["port"]["influence"]["rule"] == "krum"
    if name == "stale_gossip":
        assert reports["port"]["staleness"]["total_stale_edges"] > 0
    else:
        assert reports["port"]["faults"]["quarantined_rounds"][2] > 0
    lines = []
    report.render_report(port_cfg.telemetry.dir, out=lines.append)
    text = "\n".join(lines)
    assert "Per-node audit" in text and "declared influence (krum)" in text
