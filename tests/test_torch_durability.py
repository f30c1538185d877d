"""Run durability in the port (durability/, utils/checkpoint.py, the
Network's snapshot hooks, the CLI's flags), on the CPU.

- The dispatch envelope against the JAX package's: ``classify_error`` on
  the same exceptions, seeded ``backoff_delays`` equal, ``run_with_retry``
  retrying then succeeding, a fatal error raised at once, exhausted
  retries re-raising the original.
- The snapshot: a roundtrip with every reserved carried-state key of the
  port (bfloat16, int8 and NaN leaves among them) comes back bit for bit
  and a missing section is detected; the registry equals the package's
  ``*_STATE_KEYS`` tuples; a spliced payload is refused as torn and a
  crash before the ``meta.json`` commit restores the previous snapshot;
  old generations are collected after the commit; a snapshot directory
  written by the JAX package (its own ``save_checkpoint``) is refused by
  name; a snapshot of another seed, width or carried state is refused
  before anything is assigned.
- Resume bit-equal: a 6-round run stopped and restored into a fresh
  Network at every round boundary ends with the uninterrupted run's
  history, final ``flat`` and ``agg_state`` bit for bit, for Krum with
  int8 error feedback (resumable_run.yaml), stale gossip under faults
  (stale_gossip.yaml), pipelined Krum (pipelined_rounds.yaml) and
  pipelined with staleness, per round and fused in chunks of 2; and a
  restore into the same running Network (telemetry on, so its staged
  in-degrees are live) replays bit for bit.
- Telemetry across the seam: the stream is appended, not rotated, with one
  ``run_resumed`` event, ``checkpoint`` events that ``save`` and
  ``restore``, the manifest ``resumed`` under the first run's id, and the
  report counting both.
- The CLI: the JAX package's refusals (a snapshot already in the directory
  without ``--resume``, ``--resume`` or ``--retries`` without a directory,
  a transient failure before the first snapshot), a transient failure
  after one restored and retried to the uninterrupted history,
  ``--require-tpu`` (and its config and env twins) refusing ``--device
  cpu``, and a subprocess run SIGKILLed after a snapshot and started again
  ending with the uninterrupted history, bit for bit.
"""

import errno
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from murmura_tpu.durability import dispatch as jax_dispatch
from murmura_tpu.utils import checkpoint as jax_checkpoint
from murmura_tpu_torch import cli
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.core import network as net_mod
from murmura_tpu_torch.durability import dispatch as D
from murmura_tpu_torch.durability import snapshot as S
from murmura_tpu_torch.telemetry.report import build_report, render_report
from murmura_tpu_torch.telemetry.writer import events_of_type, read_manifest
from murmura_tpu_torch.utils import checkpoint as C
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "murmura_tpu_torch"
CONFIGS = ROOT / "examples" / "configs"
ROUNDS = 6

# ---------------------------------------------------------------------------
# the dispatch envelope against the JAX package's

EXCEPTIONS = [
    ConnectionError("boom"), TimeoutError(), ConnectionResetError("peer"),
    RuntimeError("DEADLINE_EXCEEDED while waiting"), RuntimeError("socket closed"),
    RuntimeError("tunnel reset by peer"), RuntimeError("heartbeat lost"),
    RuntimeError("UNAVAILABLE: connection to worker"),
    OSError(errno.EADDRINUSE, "address in use"), OSError(errno.ENOENT, "no such file"),
    ValueError("shape mismatch [5,3] vs [5,4]"), TypeError("unsupported operand"),
    KeyError("missing"), RuntimeError("CUDA error: an illegal memory access was encountered"),
    MemoryError(), KeyboardInterrupt(),
]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=lambda e: f"{type(e).__name__}:{e}"[:40])
def test_classify_error_equals_jax(exc):
    assert D.classify_error(exc) == jax_dispatch.classify_error(exc)


def test_backend_requirement_is_fatal_in_both():
    for mod in (D, jax_dispatch):
        assert mod.classify_error(mod.BackendRequirementError("tunnel unavailable")) == "fatal"


def test_a_sticky_cuda_error_is_fatal():
    # It kills the process's CUDA context: a retry in this process cannot cure it.
    assert D.classify_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "fatal"


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_seeded_backoff_equals_jax(seed):
    kw = dict(max_retries=6, base_delay_s=0.5, max_delay_s=8.0, jitter=0.25, seed=seed)
    got = list(D.backoff_delays(D.RetryPolicy(**kw)))
    assert got == list(jax_dispatch.backoff_delays(jax_dispatch.RetryPolicy(**kw)))
    assert len(got) == 6


def test_run_with_retry_restores_then_succeeds():
    calls, sleeps, hooks = [], [], []

    def attempt(try_idx):
        calls.append(try_idx)
        if try_idx < 2:
            raise ConnectionError("tunnel died")
        return "done"

    stats = D.RetryStats()
    result = D.run_with_retry(
        attempt, policy=D.RetryPolicy(max_retries=3, base_delay_s=0.01, max_delay_s=0.04,
                                      seed=0),
        on_retry=lambda e, i, d: (hooks.append(i), stats.hook(e, i, d)), sleep=sleeps.append)
    assert result == "done" and calls == [0, 1, 2] and hooks == [1, 2]
    assert sleeps == list(D.backoff_delays(D.RetryPolicy(
        max_retries=3, base_delay_s=0.01, max_delay_s=0.04, seed=0)))[:2]
    assert stats.counters() == {"dispatch_retries": 2, "dispatch_backoff_s": sum(sleeps)}


def test_fatal_error_raises_at_once():
    calls = []

    def attempt(try_idx):
        calls.append(try_idx)
        raise ValueError("deterministic bug")

    with pytest.raises(ValueError, match="deterministic"):
        D.run_with_retry(attempt, policy=D.RetryPolicy(max_retries=5),
                         sleep=lambda s: pytest.fail("must not sleep on a fatal error"))
    assert calls == [0]


def test_exhausted_retries_reraise_the_original():
    hooks = []

    def attempt(try_idx):
        raise TimeoutError(f"try {try_idx}")

    with pytest.raises(TimeoutError, match="try 2"):
        D.run_with_retry(attempt, policy=D.RetryPolicy(max_retries=2, base_delay_s=0.0, seed=1),
                         on_retry=lambda e, i, d: hooks.append(i), sleep=lambda s: None)
    assert hooks == [1, 2]


def test_require_tpu_refuses_the_cpu(monkeypatch):
    with pytest.raises(D.BackendRequirementError, match="device is 'cpu'"):
        D.require_tpu("cpu")
    monkeypatch.delenv("MURMURA_REQUIRE_TPU", raising=False)
    config = load_config(CONFIGS / "resumable_run.yaml")
    assert not D.tpu_required(config)
    config.durability.require_tpu = True
    assert D.tpu_required(config)
    monkeypatch.setenv("MURMURA_REQUIRE_TPU", "1")
    assert D.tpu_required(None)


# ---------------------------------------------------------------------------
# the snapshot


def _every_reserved_key_state(seed=0):
    """One tensor a reserved key, in the dtypes the port carries (bfloat16
    parameters, int8 codes, float32 with NaN and inf, a 0-d flag)."""
    g = torch.Generator().manual_seed(seed)
    dtypes = [torch.bfloat16, torch.int8, torch.float32]
    state = {}
    for i, k in enumerate(sorted(k for keys in S.resolve_reserved_agg_state_keys().values()
                                 for k in keys)):
        dt = dtypes[i % 3]
        if dt == torch.int8:
            v = torch.randint(-128, 128, (4, 33), generator=g, dtype=torch.int8)
        else:
            v = torch.randn((4, 33), generator=g).to(dt)
            v[0, 0], v[1, 1] = float("nan"), float("inf")
        state[k] = v
    state["pipe_valid"] = torch.ones(())
    return state


def test_snapshot_roundtrip_with_every_reserved_key(tmp_path):
    state = _every_reserved_key_state()
    payload = {"params": torch.randn(4, 33).to(torch.bfloat16), "agg_state": state,
               "rng": 11, "round": 3, "history": {"round": [1, 2, 3]},
               "round_times": [0.1, 0.2, 0.3]}
    assert S.snapshot_roundtrip_missing_sections(tmp_path / "a", payload) == ([], [])
    params, got, rng, rnd, *_ = C.restore_checkpoint(tmp_path / "a")
    assert (rng, rnd) == (11, 3) and params.dtype == torch.bfloat16
    assert {v.dtype for v in got.values()} == {torch.bfloat16, torch.int8, torch.float32}
    missing = {k: v for k, v in payload.items() if k != "rng"}
    assert S.snapshot_roundtrip_missing_sections(tmp_path / "b", missing) == (["rng"], [])


def test_snapshot_roundtrip_detects_a_corrupted_key(tmp_path, monkeypatch):
    state = _every_reserved_key_state()
    real = C._host

    def lossy(t):  # a container that stores bfloat16 as float16
        t = real(t)
        return t.to(torch.float16) if t.dtype == torch.bfloat16 else t

    monkeypatch.setattr(C, "_host", lossy)
    payload = {"params": torch.zeros(4, 33), "agg_state": state, "rng": 1, "round": 1,
               "history": {}, "round_times": []}
    _, corrupted = S.snapshot_roundtrip_missing_sections(tmp_path, payload)
    assert corrupted and all(state[k].dtype == torch.bfloat16 for k in corrupted)


def test_registry_equals_the_packages_state_key_groups():
    found = S.discover_state_key_groups(PORT)
    assert found == S.RESERVED_AGG_STATE_KEY_GROUPS
    assert found["DMTT_STATE_KEYS"] == "murmura_tpu_torch.core.rounds"
    assert set(S.resolve_reserved_agg_state_keys()) == set(found)


def _config(name, **over):
    config = load_config(CONFIGS / f"{name}.yaml")
    config.experiment.verbose = False
    config.telemetry.enabled = False
    for section, values in over.items():
        for k, v in values.items():
            setattr(getattr(config, section), k, v)
    return config


def test_spliced_payload_is_refused_as_torn(tmp_path):
    ckpt = tmp_path / "ckpt"
    net = build_network_from_config(_config("resumable_run"), device="cpu")
    net.train(2, checkpoint_dir=str(ckpt), checkpoint_every=2)
    keep = (ckpt / "state.2.pt").read_bytes()
    net.train(2, checkpoint_dir=str(ckpt), checkpoint_every=2)
    assert json.loads((ckpt / "meta.json").read_text())["round"] == 4
    assert sorted(p.name for p in ckpt.iterdir()) == ["meta.json", "state.4.pt"]
    (ckpt / "state.4.pt").write_bytes(keep)
    fresh = build_network_from_config(_config("resumable_run"), device="cpu")
    before = fresh.flat.clone()
    with pytest.raises(ValueError, match="Torn"):
        fresh.restore_checkpoint(str(ckpt))
    assert torch.equal(fresh.flat, before) and fresh.current_round == 0


def test_crash_before_the_meta_commit_restores_the_previous_snapshot(tmp_path):
    ckpt = tmp_path / "ckpt"
    net = build_network_from_config(_config("resumable_run"), device="cpu")
    net.train(2, checkpoint_dir=str(ckpt), checkpoint_every=2)
    old_meta, old_state = (ckpt / "meta.json").read_bytes(), (ckpt / "state.2.pt").read_bytes()
    at_two = net.flat.clone()
    net.train(2, checkpoint_dir=str(ckpt), checkpoint_every=2)
    # The picture a crash between the payload write and the meta replace
    # leaves: the new generation on disk, meta.json still the old commit.
    (ckpt / "meta.json").write_bytes(old_meta)
    (ckpt / "state.2.pt").write_bytes(old_state)
    fresh = build_network_from_config(_config("resumable_run"), device="cpu")
    assert fresh.restore_checkpoint(str(ckpt)) == 2
    assert torch.equal(fresh.flat, at_two) and fresh.history["round"] == [1, 2]
    assert not list(ckpt.glob("*.tmp"))


def _jax_snapshot(directory):
    jax_checkpoint.save_checkpoint(
        directory, params={"w": np.zeros((4, 3), np.float32)}, agg_state={},
        rng=jax.random.PRNGKey(0), round_num=2, history={"round": [1, 2]},
        round_times=[0.1, 0.1])


def test_a_jax_package_snapshot_is_refused_by_name(tmp_path):
    _jax_snapshot(tmp_path / "jax")
    assert (tmp_path / "jax" / "state.2.msgpack").exists()
    assert C.has_checkpoint(tmp_path / "jax")
    net = build_network_from_config(_config("resumable_run"), device="cpu")
    before = net.flat.clone()
    with pytest.raises(ValueError, match="written by the JAX package"):
        net.restore_checkpoint(str(tmp_path / "jax"))
    assert torch.equal(net.flat, before) and net.history["round"] == []


@pytest.mark.parametrize("change", ["seed", "width", "carried_state"])
def test_a_snapshot_of_another_run_is_refused_before_anything_is_assigned(tmp_path, change):
    ckpt = tmp_path / "ckpt"
    build_network_from_config(_config("resumable_run"), device="cpu").train(
        1, checkpoint_dir=str(ckpt))
    over = {"seed": {"experiment": {"seed": 43}},
            "width": {"model": {"params": {"input_dim": 16, "hidden_dims": [16],
                                           "num_classes": 4}}},
            "carried_state": {"compression": {"algorithm": "none"}}}[change]
    other = build_network_from_config(_config("resumable_run", **over), device="cpu")
    flat, state = other.flat.clone(), dict(other.agg_state)
    with pytest.raises(ValueError, match={"seed": "seed 42", "width": "params",
                                          "carried_state": "agg_state keys"}[change]):
        other.restore_checkpoint(str(ckpt))
    assert torch.equal(other.flat, flat) and other.agg_state.keys() == state.keys()
    assert other.current_round == 0 and other.history["round"] == []


# ---------------------------------------------------------------------------
# resume bit-equal at every round boundary

RESUME_CASES = {
    # case: (config, overrides, rounds_per_dispatch)
    "krum_int8_ef": ("resumable_run", {}, 1),
    "krum_int8_ef_fused": ("resumable_run", {}, 2),
    "stale_gossip_faults": ("stale_gossip", {}, 1),
    "pipelined_krum": ("pipelined_rounds", {}, 1),
    "pipelined_krum_fused": ("pipelined_rounds", {}, 2),
    "pipelined_stale": ("stale_gossip", {"exchange": {"pipeline": True}}, 1),
}


def _assert_same_run(a, b):
    assert a.history == b.history
    assert torch.equal(a.flat, b.flat)
    assert a.agg_state.keys() == b.agg_state.keys()
    for k in a.agg_state:
        assert a.agg_state[k].dtype == b.agg_state[k].dtype, k
        assert torch.equal(a.agg_state[k], b.agg_state[k]), k
    assert a.current_round == b.current_round


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_at_every_round_boundary_is_bit_equal(tmp_path, case):
    name, over, rpd = RESUME_CASES[case]
    ref = build_network_from_config(_config(name, **over), device="cpu")
    ref.train(ROUNDS, rounds_per_dispatch=rpd)
    carried = {"resumable_run": "compress_residual", "stale_gossip": "stale_cache",
               "pipelined_rounds": "pipe_bcast"}[name]
    assert carried in ref.agg_state
    for stop in range(1, ROUNDS):
        ckpt = tmp_path / f"stop{stop}"
        first = build_network_from_config(_config(name, **over), device="cpu")
        first.train(stop, rounds_per_dispatch=rpd, checkpoint_dir=str(ckpt))
        resumed = build_network_from_config(_config(name, **over), device="cpu")
        assert resumed.restore_checkpoint(str(ckpt)) == stop
        resumed.train(ROUNDS - stop, rounds_per_dispatch=rpd, checkpoint_dir=str(ckpt))
        _assert_same_run(ref, resumed)
        assert len(resumed.round_times) == ROUNDS


def test_restore_into_the_running_network_replays_bit_equal(tmp_path):
    config = _config("stale_gossip", exchange={"pipeline": True})
    config.telemetry.enabled = True
    config.telemetry.dir = str(tmp_path / "run")
    net = build_network_from_config(config, device="cpu")
    net.train(3, rounds_per_dispatch=2, checkpoint_dir=str(tmp_path / "ckpt"))
    net.train(3)
    full = ({k: list(v) for k, v in net.history.items()}, net.flat.clone(),
            {k: v.clone() for k, v in net.agg_state.items()})
    assert net.restore_checkpoint(str(tmp_path / "ckpt")) == 3
    assert net._in_degree == {}
    net.train(3)
    net.telemetry.close()
    assert net.history == full[0] and torch.equal(net.flat, full[1])
    for k, v in full[2].items():
        assert torch.equal(net.agg_state[k], v), k


# ---------------------------------------------------------------------------
# telemetry across the seam


def test_telemetry_stream_appends_across_a_resume(tmp_path):
    run_dir, ckpt = tmp_path / "run", tmp_path / "ckpt"
    config = _config("resumable_run")
    config.telemetry.enabled = True
    config.telemetry.dir = str(run_dir)
    first = build_network_from_config(config, device="cpu", checkpoint_dir=str(ckpt))
    first.train(4, checkpoint_dir=str(ckpt), checkpoint_every=2)
    first.telemetry.close()
    run_id = read_manifest(run_dir)["run_id"]
    resumed = build_network_from_config(config, device="cpu", checkpoint_dir=str(ckpt))
    assert resumed.restore_checkpoint(str(ckpt)) == 4
    resumed.train(2, checkpoint_dir=str(ckpt), checkpoint_every=2)
    resumed.telemetry.close()
    assert not (run_dir / "events.jsonl.prev").exists()
    runs = events_of_type(run_dir, "run")
    assert [e["status"] for e in runs] == ["started", "resumed"]
    assert [e["round"] for e in events_of_type(run_dir, "run_resumed")] == [4]
    ckpts = [(e["action"], e["round"]) for e in events_of_type(run_dir, "checkpoint")]
    assert ckpts == [("save", 2), ("save", 4), ("restore", 4), ("save", 6)]
    assert all(e["bytes"] > 0 for e in events_of_type(run_dir, "checkpoint"))
    manifest = read_manifest(run_dir)
    assert manifest["resumed"] and manifest["run_id"] == run_id
    assert manifest["history"]["round"] == list(range(1, 7))
    seqs = [json.loads(line)["seq"] for line in (run_dir / "events.jsonl").read_text().splitlines()]
    assert seqs == list(range(len(seqs)))
    report = build_report(run_dir)
    assert report["checkpoints"]["saves"] == 3 and report["checkpoints"]["restores"] == 1
    assert report["accuracy"]["rounds_recorded"] == 6
    lines = []
    render_report(run_dir, out=lines.append)
    assert any("Checkpoints" in line for line in lines)


# ---------------------------------------------------------------------------
# the CLI


def _yaml(tmp_path, name="resumable_run", rounds=6, **sections):
    raw = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())
    raw["experiment"].update(rounds=rounds, verbose=False)
    raw.setdefault("durability", {})
    raw["durability"]["checkpoint_dir"] = str(tmp_path / "ckpt")
    raw["durability"].update(retry_base_delay_s=0.0, retry_max_delay_s=0.0)
    if "telemetry" in raw:
        raw["telemetry"]["dir"] = str(tmp_path / "run")
    for k, v in sections.items():
        raw[k] = {**raw.get(k, {}), **v}
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def test_cli_refusals_are_the_jax_packages(tmp_path):
    path = _yaml(tmp_path, durability={"resume": False, "retries": 0})
    cli.run(path, device="cpu", checkpoint_every=3)
    assert C.has_checkpoint(tmp_path / "ckpt")
    with pytest.raises(cli.UsageError, match="already holds a snapshot; pass --resume"):
        cli.run(path, device="cpu")
    bare = _yaml(tmp_path / "bare", durability={"resume": False, "retries": 0,
                                               "checkpoint_dir": None})
    with pytest.raises(cli.UsageError, match="--resume requires --checkpoint-dir"):
        cli.run(bare, device="cpu", resume=True)
    with pytest.raises(cli.UsageError, match="--retries requires --checkpoint-dir"):
        cli.run(bare, device="cpu", retries=2)
    # A JAX package snapshot counts as a snapshot: no fresh run overwrites it.
    _jax_snapshot(tmp_path / "jax")
    with pytest.raises(cli.UsageError, match="already holds a snapshot"):
        cli.run(bare, device="cpu", checkpoint_dir=tmp_path / "jax")
    with pytest.raises(ValueError, match="written by the JAX package"):
        cli.run(bare, device="cpu", checkpoint_dir=tmp_path / "jax", resume=True)


def _failing_train(monkeypatch, rounds_before_failure):
    """Network.train whose first call trains ``rounds_before_failure`` rounds
    (snapshotting as asked) and then fails with a transient error."""
    real = net_mod.Network.train
    calls = []

    def train(self, rounds, *args, **kwargs):
        calls.append(rounds)
        if len(calls) == 1:
            real(self, rounds_before_failure, *args, **kwargs)
            raise ConnectionError("transport: connection reset")
        return real(self, rounds, *args, **kwargs)

    monkeypatch.setattr(net_mod.Network, "train", train)
    return calls


def test_a_transient_failure_before_the_first_snapshot_is_refused(tmp_path, monkeypatch):
    path = _yaml(tmp_path, durability={"retries": 2})
    _failing_train(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="before the first snapshot landed"):
        cli.run(path, device="cpu", checkpoint_every=100)


def test_a_transient_failure_is_restored_and_retried(tmp_path, monkeypatch):
    ref, _ = cli.run(_yaml(tmp_path / "ref", durability={"retries": 0}), device="cpu")
    path = _yaml(tmp_path, durability={"retries": 2, "checkpoint_every": 2})
    # The first attempt snapshots at round 2 and at its end (round 3), then fails.
    calls = _failing_train(monkeypatch, 3)
    history, network = cli.run(path, device="cpu")
    assert calls == [6, 3] and history == ref
    assert [(c["action"], c["round"]) for c in network.checkpoints] == [
        ("save", 2), ("save", 3), ("restore", 3), ("save", 4), ("save", 6)]
    events = events_of_type(tmp_path / "run", "backend_degraded")
    assert len(events) == 1 and events[0]["retry"] == 1


def test_require_tpu_refuses_device_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("MURMURA_REQUIRE_TPU", raising=False)
    path = _yaml(tmp_path, durability={"resume": False, "retries": 0})
    with pytest.raises(D.BackendRequirementError, match="--require-tpu"):
        cli.run(path, device="cpu", require_tpu=True)
    strict = _yaml(tmp_path / "strict", durability={"require_tpu": True})
    with pytest.raises(D.BackendRequirementError, match="durability.require_tpu"):
        cli.run(strict, device="cpu")
    env = dict(os.environ, MURMURA_REQUIRE_TPU="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "murmura_tpu_torch", "run", str(path),
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 2 and "refusing to run on the CPU" in proc.stderr
    assert not C.has_checkpoint(tmp_path / "ckpt")


def _cli(path, out, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "murmura_tpu_torch", "run", str(path), "--device", "cpu",
         "-o", str(out), *extra],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_sigkill_after_a_snapshot_then_resume_is_bit_equal(tmp_path):
    # resumable_run.yaml as committed (30 rounds, a snapshot every 5, resume
    # on), its directories pointed into tmp_path.
    ref_path = _yaml(tmp_path / "ref", rounds=30)
    ref = _cli(ref_path, tmp_path / "ref.json")
    path = _yaml(tmp_path, rounds=30)
    proc = _cli(path, tmp_path / "got.json")
    meta = tmp_path / "ckpt" / "meta.json"
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            if json.loads(meta.read_text())["round"] >= 5:
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.005)
    killed = proc.poll() is None
    proc.send_signal(signal.SIGKILL)
    proc.communicate(timeout=60)
    assert killed, "the run ended before it could be killed"
    stopped_at = json.loads(meta.read_text())["round"]
    assert 5 <= stopped_at < 30 and not (tmp_path / "got.json").exists()
    resumed = _cli(path, tmp_path / "got.json")
    out, err = resumed.communicate(timeout=600)
    assert resumed.returncode == 0, err[-3000:]
    assert f"Resumed from round {stopped_at}" in out
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == json.loads((tmp_path / "ref.json").read_text())
    assert got["round"] == list(range(1, 31))
    assert [e["status"] for e in events_of_type(tmp_path / "run", "run")] == [
        "started", "resumed"]
    assert len(events_of_type(tmp_path / "run", "run_resumed")) == 1
