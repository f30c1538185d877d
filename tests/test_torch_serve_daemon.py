"""The port's serve daemon (serve/daemon.py, serve/protocol.py and the
re-tenanting half of core/gang.py) on the CPU, mirroring the JAX package's
tests/test_serve_daemon.py representatives (5-node ring, 2 rounds, the
synthetic MLP):

- the admission refusals carry the JAX package's messages, and the
  admission key (the structural fingerprint) is the JAX package's string;
- eviction: a queued tenant never runs; idempotent, and loud on an unknown
  id; a running tenant's lane is frozen;
- a warm bucket's second generation builds nothing (no chunk program, no
  ``nvcc`` build: the daemon's ``_compile_count`` stays where it was);
- a daemon killed after round 1 of 2 (the ``_Kill`` stand-in) in its
  first or its second generation, revived over the same state dir and
  recovered, gives histories bit-equal to an uninterrupted daemon's (the
  bucket is rebuilt from its recorded template tenant); recovery without a
  generation record fails the tenant loudly;
- the socket round trip: ping, submit, status, list, metrics and shutdown;
- ``freeze_member`` leaves the surviving lane bit-equal to its run without
  the eviction, and the frozen lane's history stops where it was frozen.
"""

import copy
import json
import os
import threading
import time

import pytest
import torch

from murmura_tpu.config.schema import Config as JaxConfig
from murmura_tpu.serve import daemon as JD
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core import gang as gang_mod
from murmura_tpu_torch.core.gang import GangMember
from murmura_tpu_torch.serve.daemon import (
    TERMINAL_STATES,
    ServeDaemon,
    SubmissionError,
    normalize_submission,
)
from murmura_tpu_torch.serve.protocol import send_request
from murmura_tpu_torch.telemetry.metrics import parse_openmetrics
from murmura_tpu_torch.utils.factories import (
    build_gang_from_config,
    build_gang_member_programs,
)


def _tenant(seed, lr=0.05, rounds=2, rule="fedavg"):
    return {
        "experiment": {"name": f"tenant-{seed}", "seed": seed, "rounds": rounds},
        "topology": {"type": "ring", "num_nodes": 5},
        "aggregation": {"algorithm": rule},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": lr},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 40, "input_shape": [6], "num_classes": 3}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 6, "hidden_dims": [8], "num_classes": 3}},
        "backend": "simulation",
    }


def _daemon(tmp_path, name, capacity=2, checkpoint_every=1):
    raw = _tenant(0)
    raw["serve"] = {"state_dir": str(tmp_path / name), "capacity": capacity,
                    "checkpoint_every": checkpoint_every, "poll_interval_s": 0.05}
    return ServeDaemon(Config.model_validate(raw), device="cpu")


def _invalid_lr():
    raw = _tenant(1)
    raw["training"]["lr"] = "not-a-float"
    return raw


@pytest.mark.parametrize("raw", [
    {**_tenant(1), "sweep": {"members": [{"seed": 1}]}},
    {**_tenant(1), "frontier": {"rules": ["fedavg"]}},
    {**_tenant(1), "grid": {"rules": ["fedavg"]}},
    {**_tenant(1), "serve": {"state_dir": "/tmp/x"}},
    {**_tenant(1), "backend": "distributed"},
    _invalid_lr(),
    ["not", "a", "mapping"],
], ids=["sweep", "frontier", "grid", "serve", "distributed", "invalid", "not_a_mapping"])
def test_refusals_are_the_jax_packages(raw):
    with pytest.raises(JD.SubmissionError) as ref:
        JD.normalize_submission(copy.deepcopy(raw))
    with pytest.raises(SubmissionError) as got:
        normalize_submission(raw)
    assert str(got.value) == str(ref.value)


def test_admission_key_is_the_jax_packages():
    keys = [normalize_submission(_tenant(1, lr=0.05))[1],
            normalize_submission(_tenant(99, lr=0.001))[1],
            normalize_submission(_tenant(1, rule="median"))[1]]
    assert keys == [JD.normalize_submission(_tenant(1, lr=0.05))[1],
                    JD.normalize_submission(_tenant(99, lr=0.001))[1],
                    JD.normalize_submission(_tenant(1, rule="median"))[1]]
    assert keys[0] == keys[1] != keys[2]  # seed, name and lr are lanes; the rule is not
    raw = _tenant(0)
    with pytest.raises(ValueError) as ref:
        JD.ServeDaemon(JaxConfig.model_validate(copy.deepcopy(raw)))
    with pytest.raises(ValueError) as got:
        ServeDaemon(Config.model_validate(raw), device="cpu")
    assert str(got.value) == str(ref.value)


def test_eviction(tmp_path):
    d = _daemon(tmp_path, "evict")
    a, b = d.submit_config(_tenant(5))["id"], d.submit_config(_tenant(6))["id"]
    rec = d.evict(a, "user cancel")
    assert rec["state"] == "evicted" and rec["error"] == "user cancel"
    assert d.evict(a)["state"] == "evicted"  # idempotent
    with pytest.raises(KeyError, match="sub-99999"):
        d.evict("sub-99999")
    nxt = d._next_generation()
    assert nxt is not None and nxt[1] == [b]


def test_warm_bucket_second_generation_builds_nothing(tmp_path):
    d = _daemon(tmp_path, "warm", capacity=2)
    gen1 = [d.submit_config(_tenant(5))["id"], d.submit_config(_tenant(6, lr=0.02))["id"]]
    d.drain()
    built = d._compile_count()
    gen2 = [d.submit_config(_tenant(21))["id"], d.submit_config(_tenant(22, lr=0.01))["id"],
            d.submit_config(_tenant(23))["id"]]
    d.drain()  # two generations: 2 tenants, then 1 in the same 2-lane bucket
    assert d._compile_count() == built
    for sub_id in gen1 + gen2:
        rec = d._ledger[sub_id]
        assert rec["state"] == "done" and rec["final_accuracy"] is not None
        assert rec["phase_times"]["rounds"] == 2 and len(rec["history"]["round"]) == 2
    (bucket,) = d._buckets.values()
    assert bucket["gen"] == 3 and bucket["gang"].batch == 2
    assert d._counters == {"admissions": 5, "evictions": 0, "resumes": 0, "compiles": 1,
                           "generations": 3}
    manifest = json.loads((d.state_dir / "telemetry" / gen1[0] / "manifest.json").read_text())
    assert manifest["counters"] == {"compiles": 1.0, "serve_compiles": 1.0}
    assert json.loads((d.state_dir / "telemetry" / gen2[0] / "manifest.json")
                      .read_text())["counters"] == {}


class _Kill(BaseException):
    """SIGKILL stand-in: not an Exception, so no handler between the
    training loop and the test swallows it, and the ledger keeps its
    'running' states as a real kill would leave them."""


def _attacked(seed):
    raw = _tenant(seed)
    raw["attack"] = {"enabled": True, "type": "gaussian", "percentage": 0.4}
    return raw


@pytest.mark.parametrize("kill_gen", [1, 2])
def test_killed_daemon_recovers_bit_equal(tmp_path, monkeypatch, kill_gen):
    # Three attacked tenants in a 2-lane bucket: generations [5, 6] and [7].
    # The attack's placement is seeded by the bucket's template tenant (5),
    # so a kill in generation 2 holds the recovery to rebuilding the bucket
    # from the recorded template rather than from generation 2's tenant.
    seeds = (5, 6, 7)
    ref = _daemon(tmp_path, "ref")
    for seed in seeds:
        ref.submit_config(_attacked(seed))
    ref.drain()
    ref_hist = {rec["config"]["experiment"]["seed"]: rec["history"]
                for rec in ref._ledger.values()}

    victim = _daemon(tmp_path, "victim")
    for seed in seeds:
        victim.submit_config(_attacked(seed))
    real_train = gang_mod.GangNetwork.train
    calls = []

    def dying_train(self, rounds, **kwargs):
        calls.append(rounds)
        if len(calls) < kill_gen:
            return real_train(self, rounds=rounds, **kwargs)
        real_train(self, rounds=1, **kwargs)
        raise _Kill()

    monkeypatch.setattr(gang_mod.GangNetwork, "train", dying_train)
    with pytest.raises(_Kill):
        victim.drain()
    killed = ["sub-00001", "sub-00002"] if kill_gen == 1 else ["sub-00003"]
    assert [i for i, rec in victim._ledger.items() if rec["state"] == "running"] == killed
    monkeypatch.setattr(gang_mod.GangNetwork, "train", real_train)

    revived = _daemon(tmp_path, "victim")  # the same state_dir
    assert sorted(revived.recover()) == killed
    revived.drain()
    for rec in revived._ledger.values():
        assert rec["state"] == "done"
        assert rec["history"] == ref_hist[rec["config"]["experiment"]["seed"]]
    assert revived._counters["resumes"] == len(killed)
    events = [json.loads(line)["type"] for line in
              (revived.state_dir / "telemetry" / killed[0] / "events.jsonl")
              .read_text().splitlines()]
    assert events.count("run_resumed") == 1


def test_recover_without_generation_record_fails_loud(tmp_path):
    d = _daemon(tmp_path, "neg")
    sub_id = d.submit_config(_tenant(5))["id"]
    d._pending.clear()
    d._update(sub_id, state="running", gen=41, lane=0)
    revived = _daemon(tmp_path, "neg")
    assert revived.recover() == []
    rec = revived._ledger[sub_id]
    assert rec["state"] == "failed" and "generation record lost" in rec["error"]


def test_socket_round_trip(tmp_path):
    d = _daemon(tmp_path, "sock")
    thread = threading.Thread(target=d.serve_forever, daemon=True)
    thread.start()
    sp = d.socket_path
    try:
        ping = send_request(sp, {"op": "ping"})
        assert ping["ok"] and ping["pid"] == os.getpid() and ping["schema_version"] == 2
        reply = send_request(sp, {"op": "submit", "config": _tenant(5)})
        assert reply["ok"]
        sub_id = reply["id"]
        deadline = time.monotonic() + 120
        state = None
        while time.monotonic() < deadline:
            status = send_request(sp, {"op": "status", "id": sub_id})
            state = status["submission"]["state"]
            if state in TERMINAL_STATES:
                break
            time.sleep(0.05)
        assert state == "done" and status["submission"]["final_accuracy"] is not None
        bad = send_request(sp, {"op": "submit",
                                "config": {**_tenant(7), "sweep": {"members": [{"seed": 1}]}}})
        assert not bad["ok"] and "sweep" in bad["error"]
        assert [r["id"] for r in send_request(sp, {"op": "list"})["submissions"]] == [sub_id]
        assert not send_request(sp, {"op": "status", "id": "sub-nope"})["ok"]
        text = send_request(sp, {"op": "metrics"})["text"]
        assert text.endswith("# EOF\n")
        scraped = parse_openmetrics(text)
        assert scraped[("murmura_rounds_total", (("tenant", sub_id),))] == 2.0
        assert scraped[("murmura_serve_lifetime_total", (("counter", "generations"),))] == 1.0
    finally:
        try:
            send_request(sp, {"op": "shutdown"}, retries=1)
        except Exception:  # noqa: BLE001 - the daemon may be gone already
            pass
        thread.join(timeout=15)
    assert not thread.is_alive() and not os.path.exists(sp)


def test_freeze_member_leaves_the_survivor_bit_equal():
    raw = _tenant(5)
    raw["sweep"] = {"members": [{"seed": 5, "lr": 0.05}]}
    cfg = Config.model_validate(raw)
    members = [GangMember(seed=5, lr=0.05), GangMember(seed=6, lr=0.02)]
    runs = []
    for freeze in (False, True):
        gang = build_gang_from_config(cfg, device="cpu", min_batch=2)
        builds = gang.program_builds
        gang.reset_run(members, member_programs=build_gang_member_programs(
            cfg, members[:1], device="cpu") + build_gang_member_programs(
            cfg, members[1:], device="cpu"))
        gang.train(rounds=1)
        if freeze:
            gang.freeze_member(1, "evicted")
            gang.freeze_member(1, "evicted")  # idempotent
        gang.train(rounds=2)
        runs.append(gang)
        assert gang.program_builds == builds + 1 and gang.batch == 2
    whole, frozen = runs
    assert frozen.histories[0] == whole.histories[0]
    assert torch.equal(frozen.flats, whole.flats)  # the frozen lane kept computing
    assert frozen.histories[1]["round"] == [1] and whole.histories[1]["round"] == [1, 2, 3]
    assert frozen.member_active == [True, False]
    with pytest.raises(ValueError, match="out of range"):
        frozen.freeze_member(2, "no such lane")
