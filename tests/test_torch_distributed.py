"""The ZMQ backend of the port (murmura_tpu_torch/distributed/,
faults/injector.py) against the JAX package's, in-process, on the CPU:
nothing here spawns a process.

- Frames: the port's encode/decode round-trip, its MODEL_STATE and METRICS
  frames equal the JAX package's byte for byte, each package decodes the
  other's, and a bad frame count is refused.
- Endpoints: the same ipc and tcp addresses (host overrides included).
- ``LocalNode`` against the JAX ``LocalNode``: the JAX node's initial
  parameters carried over, the JAX node's own draws (each epoch's
  permutation, each step's dropout masks) injected, train and eval, then
  aggregation with a full and with a partial neighbour set for Krum, the
  median, BALANCE, Sketchguard (node state over two rounds), evidential
  trust (edge state over two rounds) and UBAR: parameters within a scaled
  1e-4 (max |port - jax| / max(1, max |jax|)), eval metrics within rtol
  1e-4, the rules' decisions (Krum's pick, the acceptance rates) equal and
  their float statistics within rtol 1e-4, the carried state within rtol
  1e-5.
- ``NodeProcess._execute_round`` of both packages on a real ipc PULL socket
  fed the same neighbour frames, the monitor push faked, the JAX node's
  draws and attack noise injected: an honest node, a compromised gaussian
  node, the past-deadline SKIPPED frame, the nan_quarantine rollback and
  the receiver's non-finite drop.  Headers and metric keys equal, the
  flags and counters equal, the sent states and the parameters within a
  scaled 1e-4, the losses and accuracies within rtol 1e-4.
- ``Monitor``: both fed the same METRICS frames (complete and partial
  rounds, a gap, an all-skipped round, out-of-range tags, unknown keys,
  counters) return equal histories, and with telemetry equal manifests
  and event streams (times and sequence numbers aside).
- ``FaultInjector``: equal ``events`` for one schedule.
- The refusals this backend shares with the JAX package, a rule with an
  unannotated carried key, and ``run-node``'s DMTT process (ROADMAP Queue
  C: the JAX package's ``run-node`` runs the plain node process there).
"""

import threading
import time
from pathlib import Path
import jax
import numpy as np
import pytest
import torch
import zmq

from murmura_tpu.aggregation import build_aggregator as jax_build_aggregator
from murmura_tpu.config import Config as JaxConfig
from murmura_tpu.distributed import endpoints as jax_endpoints
from murmura_tpu.distributed import messaging as jax_messaging
from murmura_tpu.distributed.local import LocalNode as JaxLocalNode
from murmura_tpu.distributed.monitor import Monitor as JaxMonitor
from murmura_tpu.distributed.node_process import NodeProcess as JaxNodeProcess
from murmura_tpu.faults.injector import FaultInjector as JaxFaultInjector
from murmura_tpu.faults.schedule import FaultSchedule as JaxFaultSchedule
from murmura_tpu.models.mlp import make_mlp as jax_make_mlp
from murmura_tpu.utils.factories import ConfigError as JaxConfigError
from murmura_tpu.utils.factories import build_attack as jax_build_attack
from murmura_tpu.utils.factories import build_telemetry_writer as jax_telemetry_writer
from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.aggregation.base import AggregatorDef
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.distributed import endpoints, messaging
from murmura_tpu_torch.distributed.local import LocalNode
from murmura_tpu_torch.distributed.monitor import Monitor
from murmura_tpu_torch.distributed.node_process import NodeProcess
from murmura_tpu_torch.faults.injector import FaultInjector
from murmura_tpu_torch.faults.schedule import FaultSchedule
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.utils.factories import ConfigError, build_attack, build_telemetry_writer

FEAT, HIDDEN, CLASSES = 12, 16, 4
SEED = 3


def _scaled_delta(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _jax_node_draws(rng_key, epochs, n, steps, batch, widths, keep):
    """The draws of the JAX LocalNode's next local_train (distributed/
    local.py: split(rng) -> key; split(key, epochs); split(epoch key) ->
    perm/step; fold_in(step key, t); the MLP splits a step key per layer
    and draws bernoulli(keep, [B, width]))."""
    _, key = jax.random.split(rng_key)
    perms, masks = [], []
    for ekey in jax.random.split(key, epochs):
        pkey, skey = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(pkey, n)))
        step_masks = []
        for t in range(steps):
            if widths:
                lkeys = jax.random.split(jax.random.fold_in(skey, t), len(widths))
                step_masks.append([np.asarray(jax.random.bernoulli(k, keep, (batch, w)))
                                   for k, w in zip(lkeys, widths)])
        masks.append(step_masks)
    return {"perm": perms, "dropout": masks}


# ----------------------------------------------------------------------
# frames and endpoints


def test_frames_round_trip_and_refuse_a_bad_count():
    flat = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    header, payload = messaging.encode(messaging.MsgType.MODEL_STATE, 3,
                                       messaging.pack_state(flat), 5)
    msg_type, sender, msg_round, body = messaging.decode([header, payload])
    assert (msg_type, sender, msg_round) == (messaging.MsgType.MODEL_STATE, 3, 5)
    np.testing.assert_array_equal(messaging.unpack_state(body), flat)
    metrics = {"round": 2, "accuracy": 0.93, "stats": {"a": 1.0}}
    _, body = messaging.decode(messaging.encode(messaging.MsgType.METRICS, 0,
                                                messaging.pack_obj(metrics), 2))[2:]
    assert messaging.unpack_obj(body) == metrics
    with pytest.raises(ValueError, match="Expected 2 frames"):
        messaging.decode([b"xxx"])


def test_frames_equal_the_jax_package_byte_for_byte():
    flat = np.random.default_rng(1).normal(size=777).astype(np.float32)
    metrics = {"round": 4, "node": 2, "skipped": False, "loss": 0.5, "accuracy": 0.25,
               "stats": {"selected_index": 1.0}, "compromised": True,
               "counters": {"send_retries": 0.0}}
    for mt, payload_fn, obj, tag in (
        ("MODEL_STATE", "pack_state", flat, 4),
        ("METRICS", "pack_obj", metrics, 4),
        ("TOPO_CLAIM", "pack_obj", {"neighbors": [1, 3]}, 0),
        ("COLLUDE_STATE", "pack_state", flat, 9),
    ):
        ours = messaging.encode(messaging.MsgType[mt], 2,
                                getattr(messaging, payload_fn)(obj), tag)
        theirs = jax_messaging.encode(jax_messaging.MsgType[mt], 2,
                                      getattr(jax_messaging, payload_fn)(obj), tag)
        assert ours == theirs, mt
        # Each package decodes the other's frames.
        for decode, frames in ((messaging.decode, theirs), (jax_messaging.decode, ours)):
            msg_type, sender, msg_round, _ = decode(list(frames))
            assert (int(msg_type), sender, msg_round) == (int(messaging.MsgType[mt]), 2, tag)
    np.testing.assert_array_equal(jax_messaging.unpack_state(messaging.pack_state(flat)), flat)
    assert messaging.unpack_obj(jax_messaging.pack_obj(metrics)) == metrics


def test_endpoints_match_the_jax_package(tmp_path):
    from murmura_tpu.config.schema import DistributedConfig as JaxDistributedConfig
    from murmura_tpu_torch.config.schema import DistributedConfig

    for kw in ({"transport": "ipc", "ipc_dir": str(tmp_path)},
               {"transport": "tcp", "base_port": 6000, "host": "10.0.0.1",
                "node_hosts": {1: "10.0.0.9"}, "coordinator_pull_port": 6500}):
        ours = endpoints.Endpoints(DistributedConfig(**kw), "runA")
        theirs = jax_endpoints.Endpoints(JaxDistributedConfig(**kw), "runA")
        for node in range(3):
            assert ours.node_bind(node) == theirs.node_bind(node)
            assert ours.node_bind(node, "127.0.0.2") == theirs.node_bind(node, "127.0.0.2")
            assert ours.node_connect(node) == theirs.node_connect(node)
            assert ours.node_checkpoint_path(node) == theirs.node_checkpoint_path(node)
        assert ours.monitor_bind() == theirs.monitor_bind()
        assert ours.monitor_connect() == theirs.monitor_connect()
    assert ours.node_connect(1) == "tcp://10.0.0.9:6001"


# ----------------------------------------------------------------------
# LocalNode

# (rule, params, evidential model, dropout)
NODE_RULES = [
    ("krum", {"num_compromised": 1}, False, 0.25),
    ("median", {}, False, 0.0),
    ("balance", {}, False, 0.0),
    ("sketchguard", {"sketch_size": 64}, False, 0.0),
    ("evidential_trust", {"max_eval_samples": 16}, True, 0.0),
    ("ubar", {"rho": 0.8}, False, 0.0),
]
# The rules' statistics that are decisions: equal.
DECISIONS = ("selected_index", "selected_own", "acceptance_rate", "num_accepted",
             "stage1_acceptance_rate", "stage2_acceptance_rate", "accepted_count")
MAX_NEIGHBORS = 4
# The JAX node's jitted train, eval and probe functions by (evidential,
# dropout): every rule's node holds the same data and the same model
# architecture, and only the rule function differs, so each rule reuses
# them instead of compiling its own.
_JAX_MODEL_FNS = {}


def _node_pair(rule, params, evidential, dropout):
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(40, FEAT)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=40).astype(np.int32)
    kw = dict(max_neighbors=MAX_NEIGHBORS, local_epochs=2, batch_size=8, lr=0.1,
              total_rounds=6, probe_size=16, seed=SEED)
    jmodel = jax_make_mlp(FEAT, (HIDDEN,), CLASSES, dropout_rate=dropout, evidential=evidential)
    tmodel = make_mlp(FEAT, (HIDDEN,), CLASSES, dropout_rate=dropout, evidential=evidential)
    dim = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jmodel.init(
        jax.random.PRNGKey(0))))
    jnode = JaxLocalNode(0, jmodel, jax_build_aggregator(rule, params, model_dim=dim), x, y,
                         **kw)
    fns = _JAX_MODEL_FNS.setdefault((evidential, dropout), {
        k: getattr(jnode, k) for k in ("_train_fn", "_eval_fn", "_probe_eval_fn")})
    for k, fn in fns.items():
        setattr(jnode, k, fn)
    init = jax.tree_util.tree_map(np.asarray, jnode.params)
    tnode = LocalNode(0, tmodel, build_aggregator(rule, params, model_dim=dim), x, y,
                      device="cpu", init_params=init, **kw)
    np.testing.assert_array_equal(tnode.get_flat_state(), jnode.get_flat_state())
    return jnode, tnode


def _train_pair(jnode, tnode, round_idx):
    draws = _jax_node_draws(jnode.rng, jnode.local_epochs, jnode.n_samples, jnode.steps,
                            jnode.eff_batch, tnode.model.dropout_widths,
                            1.0 - tnode.model.dropout)
    jnode.local_train(round_idx)
    tnode.local_train(round_idx, draws=draws)
    assert _scaled_delta(tnode.get_flat_state(), jnode.get_flat_state()) <= 1e-4


def _neighbours(own, ids, seed):
    """States around ``own`` at distinct spreads (so that Krum's scores are
    far apart), one far away (an attacker's)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, nid in enumerate(ids):
        scale = 0.05 * (1 + k) if k < len(ids) - 1 else 3.0
        out[nid] = (own + scale * rng.normal(size=own.shape)).astype(np.float32)
    return out


def _check_stats(t_stats, j_stats):
    assert set(t_stats) == set(j_stats)
    for k, v in j_stats.items():
        if k in DECISIONS:
            assert t_stats[k] == pytest.approx(float(v), abs=1e-6), k
        else:
            assert t_stats[k] == pytest.approx(float(v), rel=1e-4, abs=1e-6), k


@pytest.mark.parametrize("rule,params,evidential,dropout", NODE_RULES,
                         ids=[r[0] for r in NODE_RULES])
def test_local_node_matches_jax(rule, params, evidential, dropout):
    jnode, tnode = _node_pair(rule, params, evidential, dropout)
    # Two rounds: a full neighbour set, then a partial one (two of four
    # arrived, one of them a neighbour seen in round 0): node and edge
    # state carry over between the rounds.
    for round_idx, ids in ((0, [3, 5, 7, 9]), (1, [5, 11])):
        _train_pair(jnode, tnode, round_idx)
        j_eval, t_eval = jnode.evaluate(), tnode.evaluate()
        assert set(t_eval) == set(j_eval)
        for k in j_eval:
            assert t_eval[k] == pytest.approx(j_eval[k], rel=1e-4, abs=1e-6), k
        states = _neighbours(jnode.get_flat_state(), ids, SEED + round_idx)
        jnode.aggregate_with_neighbors(states, round_idx)
        tnode.aggregate_with_neighbors(states, round_idx)
        assert _scaled_delta(tnode.get_flat_state(), jnode.get_flat_state()) <= 1e-4
        _check_stats(tnode.get_aggregator_statistics(), jnode.get_aggregator_statistics())
        for k, v in jnode._node_state.items():
            np.testing.assert_allclose(tnode._node_state[k], np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for k, per in jnode._edge_state.items():
            assert set(tnode._edge_state[k]) == set(per), k
            for nid, v in per.items():
                np.testing.assert_allclose(tnode._edge_state[k][nid], np.asarray(v),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{k}[{nid}]")
        # Re-sync so that each round starts from one state in both packages.
        tnode.set_flat_state(jnode.get_flat_state())
    if rule == "krum":
        # Krum really selected a neighbour in the full round (c=1 < (5-2)/2).
        assert "selected_index" in tnode.get_aggregator_statistics()
    if rule == "sketchguard":
        assert int(tnode._node_state["window_len"]) == 2
    if rule == "evidential_trust":
        assert set(tnode._edge_state["smoothed_trust"]) == {3, 5, 7, 9, 11}


def test_local_node_refuses_an_unannotated_state_key():
    def init_state(n):
        return {"window": np.zeros((n, 3), np.float32)}

    agg = AggregatorDef(name="stateful", aggregate=lambda *a: None, init_state=init_state)
    x = np.zeros((8, FEAT), np.float32)
    y = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="without a state_kind annotation"):
        LocalNode(0, make_mlp(FEAT, (HIDDEN,), CLASSES), agg, x, y, max_neighbors=2,
                  device="cpu")
    # The two rules that carry state are annotated as in the JAX package.
    for name, params in (("sketchguard", {"model_dim": 10}), ("evidential_trust", {})):
        assert (build_aggregator(name, params).state_kind
                == jax_build_aggregator(name, params, model_dim=10).state_kind)


def test_local_node_draws_are_a_function_of_seed_and_round():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, FEAT)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=40).astype(np.int32)
    model = make_mlp(FEAT, (HIDDEN,), CLASSES, dropout_rate=0.25)

    def node():
        return LocalNode(1, model, build_aggregator("fedavg", {}), x, y, max_neighbors=2,
                         batch_size=8, seed=5, device="cpu")

    a, b = node(), node()
    np.testing.assert_array_equal(a.get_flat_state(), b.get_flat_state())
    a.local_train(0)
    a.local_train(1)
    b.local_train(0)
    b.local_train(1)
    np.testing.assert_array_equal(a.get_flat_state(), b.get_flat_state())
    d0, d1 = a.round_draws(0), a.round_draws(1)
    assert not torch.equal(d0["perm"][0], d1["perm"][0])
    assert len(d0["dropout"][0]) == a.steps and d0["dropout"][0][0][0].shape == (8, HIDDEN)


# ----------------------------------------------------------------------
# NodeProcess._execute_round

N_RING = 3


def _ring_raw(tmp_path, tag):
    return {
        "experiment": {"name": "np", "seed": SEED, "rounds": 3},
        "topology": {"type": "ring", "num_nodes": N_RING},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 0}},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.1},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 96, "input_dim": FEAT, "num_classes": CLASSES}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": FEAT, "hidden_dims": [HIDDEN],
                             "num_classes": CLASSES}},
        "backend": "distributed",
        "distributed": {"transport": "ipc", "ipc_dir": str(tmp_path / tag),
                        "round_duration_s": 60.0},
    }


def _ring_config(cls, tmp_path, tag, attack=None, faults=None):
    raw = _ring_raw(tmp_path, tag)
    if attack is not None:
        raw["attack"] = attack
    if faults is not None:
        raw["faults"] = faults
    return cls.model_validate(raw)


class _FakePush:
    def __init__(self):
        self.frames = []

    def send_multipart(self, frames, **kw):
        self.frames.append(list(frames))

    def close(self, **kw):
        pass


# The JAX node's jitted functions, kept from the first case: the cases'
# configs differ only in their attack and fault sections, which the node's
# train, eval and rule functions do not see, so each case reuses them
# instead of compiling its own.
_JAX_NODE_FNS = {}
_NODE_FN_NAMES = ("_train_fn", "_eval_fn", "_agg_fn", "_probe_eval_fn")


def _process(cls, cfg, run_id, t_start, compromised, build=True, **kw):
    proc = cls(cfg, node_id=0, run_id=run_id, t_start=t_start,
               compromised_ids=compromised, **kw)
    if build:
        proc._build_node()
        if cls is JaxNodeProcess:
            if not _JAX_NODE_FNS:
                _JAX_NODE_FNS.update({k: getattr(proc.node, k) for k in _NODE_FN_NAMES})
            for k, fn in _JAX_NODE_FNS.items():
                setattr(proc.node, k, fn)
        proc.endpoints.ensure_dirs()
        proc._setup_sockets()
        proc._monitor_push.close(linger=0)
    proc._monitor_push = _FakePush()
    return proc


def _execute_pair(tmp_path, attack=None, faults=None, neighbour_nan=False, past=False):
    """Node 0 of a 3-node ring in both packages: neighbours 1 and 2 send
    their states on a real ipc socket, node 0 runs one round.  Returns the
    (frames node 0 sent to its neighbours, monitor frames, final flat) of
    each package."""
    jcfg = _ring_config(JaxConfig, tmp_path, "jax", attack, faults)
    tcfg = _ring_config(Config, tmp_path, "torch", attack, faults)
    jattack = jax_build_attack(jcfg)
    compromised = sorted(jattack.get_compromised_nodes()) if jattack else []
    t_start = time.monotonic() - (1000.0 if past else 0.0)
    jproc = _process(JaxNodeProcess, jcfg, "jrun", t_start, compromised, build=not past)
    tproc = _process(NodeProcess, tcfg, "trun", t_start, compromised, build=not past,
                     device="cpu")
    out = {}
    ctx = zmq.Context()
    try:
        if past:
            jproc._execute_round(0)
            tproc._execute_round(0)
            return {"jax": ([], jproc._monitor_push.frames, None),
                    "torch": ([], tproc._monitor_push.frames, None)}
        tproc.node.set_flat_state(jproc.node.get_flat_state())
        own = jproc.node.get_flat_state()
        states = {1: (own + 0.05 * np.random.default_rng(1).normal(size=own.shape)),
                  2: (own + 0.10 * np.random.default_rng(2).normal(size=own.shape))}
        if neighbour_nan:
            states[2] = np.full_like(own, np.nan)
        draws = {"train": _jax_node_draws(jproc.node.rng, 1, jproc.node.n_samples,
                                          jproc.node.steps, jproc.node.eff_batch, (), 1.0)}
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED + 7919), 0), 0)
        draws["noise"] = np.asarray(jax.random.normal(key, (1, own.size), jax.numpy.float32))
        for tag, proc, kw in (("jax", jproc, {}), ("torch", tproc, {"draws": draws})):
            # Capture what node 0 pushes to its neighbours.
            sinks = {}
            for nid in (1, 2):
                sink = ctx.socket(zmq.PULL)
                sink.bind(proc.endpoints.node_bind(nid))
                sinks[nid] = sink
            feed = ctx.socket(zmq.PUSH)
            feed.connect(proc.endpoints.node_connect(0))
            for nid, st in states.items():
                feed.send_multipart(jax_messaging.encode(
                    jax_messaging.MsgType.MODEL_STATE, nid,
                    jax_messaging.pack_state(np.asarray(st, np.float32)), 0))
            # The round waits for both neighbours' frames (a 60 s window).
            proc._execute_round(0, **kw)
            # The teardown ends the node's context, which first hands every
            # queued frame over to the sinks (the sockets linger 2 s).
            proc._teardown()
            sent = []
            for nid, sink in sinks.items():
                while sink.poll(100):
                    sent.append((nid, sink.recv_multipart()))
                sink.close(linger=0)
            feed.close(linger=0)
            out[tag] = (sent, proc._monitor_push.frames, proc.node.get_flat_state())
    finally:
        ctx.term()
    return out


def _compare_execute(out):
    (j_sent, j_mon, j_flat), (t_sent, t_mon, t_flat) = out["jax"], out["torch"]
    assert [(nid, f[0]) for nid, f in t_sent] == [(nid, f[0]) for nid, f in j_sent]
    for (_, tf), (_, jf) in zip(t_sent, j_sent):
        assert _scaled_delta(jax_messaging.unpack_state(tf[1]),
                             jax_messaging.unpack_state(jf[1])) <= 1e-4
    assert [f[0] for f in t_mon] == [f[0] for f in j_mon]
    for tf, jf in zip(t_mon, j_mon):
        tm, jm = messaging.unpack_obj(tf[1]), jax_messaging.unpack_obj(jf[1])
        assert set(tm) == set(jm)
        for k, v in jm.items():
            if k in ("loss", "accuracy"):
                assert tm[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
            elif k == "stats":
                _check_stats(tm[k], v)
            elif k == "counters":
                assert {c: x for c, x in tm[k].items() if c != "checkpoint_s"} == {
                    c: x for c, x in v.items() if c != "checkpoint_s"}
            else:
                assert tm[k] == v, k
    if j_flat is not None:
        assert _scaled_delta(t_flat, j_flat) <= 1e-4
    return j_sent, j_mon


def test_execute_round_honest_node(tmp_path):
    sent, mon = _compare_execute(_execute_pair(tmp_path))
    assert sorted(nid for nid, _ in sent) == [1, 2]
    metrics = jax_messaging.unpack_obj(mon[0][1])
    assert metrics["skipped"] is False and metrics["compromised"] is False
    assert "selected_index" in metrics["stats"]


def test_execute_round_compromised_gaussian_node(tmp_path):
    attack = {"enabled": True, "type": "gaussian", "percentage": 0.34,
              "params": {"noise_std": 2.0, "seed": 1}}
    from murmura_tpu_torch.attacks.base import select_compromised

    assert select_compromised(N_RING, 0.34, 1)[0]
    sent, mon = _compare_execute(_execute_pair(tmp_path, attack=attack))
    assert jax_messaging.unpack_obj(mon[0][1])["compromised"] is True
    assert len(sent) == 2


def test_execute_round_past_deadline_sends_skipped(tmp_path):
    out = _execute_pair(tmp_path, past=True)
    _compare_execute(out)
    metrics = messaging.unpack_obj(out["torch"][1][0][1])
    assert metrics["skipped"] is True and metrics["counters"]["rounds_skipped"] == 1.0


def test_execute_round_nan_quarantine_rolls_back(tmp_path):
    faults = {"enabled": True, "nan_quarantine": True, "nan_inject_nodes": [0]}
    out = _execute_pair(tmp_path, faults=faults)
    sent, mon = _compare_execute(out)
    assert sent == []  # the quarantined node skips the exchange
    assert len(mon) == 1 and jax_messaging.unpack_obj(mon[0][1])["skipped"] is False


def test_execute_round_drops_a_nonfinite_neighbour(tmp_path):
    faults = {"enabled": True, "nan_quarantine": True}
    out = _execute_pair(tmp_path, faults=faults, neighbour_nan=True)
    sent, mon = _compare_execute(out)
    metrics = messaging.unpack_obj(out["torch"][1][0][1])
    assert metrics["counters"]["nonfinite_drops"] == 1.0
    assert np.isfinite(out["torch"][2]).all()


# ----------------------------------------------------------------------
# Monitor

MON_NODES, MON_ROUNDS = 3, 5


def _monitor_config(cls, tmp_path, telemetry):
    raw = _ring_raw(tmp_path, "ipc")
    raw.update({"experiment": {"name": "mon", "seed": 1, "rounds": MON_ROUNDS},
                "attack": {"enabled": True, "type": "gaussian", "percentage": 0.34}})
    if telemetry is not None:
        raw["telemetry"] = {"enabled": True, "dir": str(telemetry)}
    return cls.model_validate(raw)


def _metric_frames():
    """Round 0 complete; round 1 with one node skipped and an unknown key;
    round 2 never reported (a gap); round 3 all skipped; round 4 partial;
    tags out of range; counters on every frame."""
    frames = []

    def frame(r, n, skipped=False, **extra):
        m = {"round": r, "node": n, "skipped": skipped, "compromised": n == 2,
             "counters": {"send_retries": float(r), "rounds_skipped": float(skipped),
                          "flag": True}}
        if not skipped:
            m.update(loss=1.0 / (1 + r + n), accuracy=0.1 * (r + n), stats={
                "selected_index": float(n), "krum_score": 0.5 * r})
        m.update(extra)
        frames.append(jax_messaging.encode(jax_messaging.MsgType.METRICS, n,
                                           jax_messaging.pack_obj(m), r))

    for n in range(MON_NODES):
        frame(0, n)
    frame(1, 0)
    frame(1, 1, probe_ms=3.5)
    frame(1, 2, skipped=True)
    for n in range(MON_NODES):
        frame(3, n, skipped=True)
    frame(4, 1, probe_ms=1.0)
    frame(99, 0)
    frame(-1, 1)
    return frames


def _feed(monitor, frames, decode, unpack):
    """Monitor.run's loop body over ``frames``, then its hard-deadline
    flush and the telemetry finalisation."""
    for f in frames:
        msg_type, _, _, payload = decode(list(f))
        monitor._ingest(unpack(payload))
        monitor._flush_complete()
    monitor._flush_partial()
    monitor._finalize_telemetry()
    return monitor.history


def test_monitor_matches_jax(tmp_path):
    import json

    histories, manifests, events = {}, {}, {}
    for tag, cls, mon_cls, writer, dec, unp in (
        ("jax", JaxConfig, JaxMonitor, jax_telemetry_writer, jax_messaging.decode,
         jax_messaging.unpack_obj),
        ("torch", Config, Monitor, build_telemetry_writer, messaging.decode,
         messaging.unpack_obj),
    ):
        cfg = _monitor_config(cls, tmp_path, tmp_path / f"tel_{tag}")
        mon = mon_cls(cfg, "run1", time.monotonic(), compromised_ids={2})
        mon._telemetry = writer(cfg, run_id="run1")
        histories[tag] = _feed(mon, _metric_frames(), dec, unp)
        manifests[tag] = json.loads((tmp_path / f"tel_{tag}" / "manifest.json").read_text())
        events[tag] = [json.loads(line) for line in
                       (tmp_path / f"tel_{tag}" / "events.jsonl").read_text().splitlines()]
    h, jh = histories["torch"], histories["jax"]
    assert list(h) == list(jh)
    for k, v in jh.items():
        assert [x is None for x in h[k]] == [x is None for x in v], k
        np.testing.assert_array_equal(np.array([np.nan if x is None else x for x in h[k]]),
                                      np.array([np.nan if x is None else x for x in v]),
                                      err_msg=k)
    assert h["round"] == [1, 2, 3, 4, 5] and h["reporting_nodes"] == [3, 3, 0, 3, 1]
    assert h["skipped_nodes"] == [0, 1, 0, 3, 0] and np.isnan(h["mean_accuracy"][3])
    # From the first round the key appears, None where nobody reported it.
    assert h["extra.probe_ms"] == [3.5, None, None, 1.0]
    volatile = ("created_unix", "finalized_unix", "config")
    tm = {k: v for k, v in manifests["torch"].items() if k not in volatile}
    jm = {k: v for k, v in manifests["jax"].items() if k not in volatile}
    assert json.dumps(tm, sort_keys=True) == json.dumps(jm, sort_keys=True)
    # Each node's last in-range frame wins: rounds 3, 4 and 3.
    assert manifests["torch"]["counters"]["send_retries"] == 10.0
    strip = [{k: v for k, v in e.items() if k not in ("t", "seq")} for e in events["torch"]]
    assert strip == [{k: v for k, v in e.items() if k not in ("t", "seq")}
                     for e in events["jax"]]


def test_monitor_run_over_a_socket(tmp_path):
    """The port's Monitor.run: binds, reads frames until every round is
    complete, and returns without waiting out the hard deadline."""
    cfg = _monitor_config(Config, tmp_path, None)
    cfg.experiment.rounds = 2
    mon = Monitor(cfg, "sock", time.monotonic(), compromised_ids={2})
    mon.endpoints.ensure_dirs()
    result = {}
    thread = threading.Thread(target=lambda: result.update(h=mon.run()))
    thread.start()
    ctx = zmq.Context()
    push = ctx.socket(zmq.PUSH)
    push.connect(mon.endpoints.monitor_connect())
    for r in range(2):
        for n in range(MON_NODES):
            m = {"round": r, "node": n, "skipped": False, "compromised": n == 2,
                 "loss": 1.0, "accuracy": 0.5}
            push.send_multipart(messaging.encode(messaging.MsgType.METRICS, n,
                                                 messaging.pack_obj(m), r))
    thread.join(timeout=20)
    push.close(linger=0)
    ctx.term()
    assert not thread.is_alive()
    assert result["h"]["round"] == [1, 2] and result["h"]["reporting_nodes"] == [3, 3]


# ----------------------------------------------------------------------
# FaultInjector


def test_fault_injector_events_match_jax():
    kw = dict(crash_prob=0.3, recovery_prob=0.5, min_down_rounds=1, seed=4)
    rounds, duration = 8, 0.05
    events = {}
    for tag, sched_cls, inj_cls in (("jax", JaxFaultSchedule, JaxFaultInjector),
                                    ("torch", FaultSchedule, FaultInjector)):
        calls = []
        inj = inj_cls(sched_cls(6, **kw), rounds=rounds, round_duration=duration,
                      t_start=time.monotonic() + 0.05,
                      kill=lambda i, c=calls: c.append(("kill", i)),
                      respawn=lambda i, c=calls: c.append(("respawn", i)))
        inj.start()
        inj._thread.join(timeout=30)
        inj.stop()
        events[tag] = (inj.events, calls)
    assert events["torch"] == events["jax"]
    kinds = {e[1] for e in events["torch"][0]}
    assert kinds == {"kill", "respawn"}


# ----------------------------------------------------------------------
# refusals, run-node


@pytest.mark.parametrize("attack,dmtt", [
    ({"enabled": True, "type": "label_flip", "percentage": 0.25}, False),
    ({"enabled": True, "type": "alie", "percentage": 0.1}, False),
    ({"enabled": True, "type": "ipm", "percentage": 0.25}, True),
])
def test_distributed_attack_refusals_match_jax(attack, dmtt):
    raw = _ring_raw(Path("/nonexistent"), "x")
    raw.update(topology={"type": "fully", "num_nodes": 8}, attack=attack)
    if dmtt:
        raw["dmtt"] = {"allow_static": True}
    with pytest.raises(JaxConfigError) as jerr:
        jax_build_attack(JaxConfig.model_validate(raw))
    with pytest.raises(ConfigError) as terr:
        build_attack(Config.model_validate(raw))
    assert str(terr.value) == str(jerr.value)


def test_cli_refusals_and_run_node(tmp_path):
    import yaml

    from murmura_tpu_torch import cli

    cfg = _ring_config(Config, tmp_path, "cli")
    path = tmp_path / "dist.yaml"
    path.write_text(yaml.safe_dump(cfg.model_dump(mode="json")))
    for extra in (["--profile"], ["--checkpoint-dir", str(tmp_path / "ck")]):
        with pytest.raises(SystemExit) as e:
            cli.main(["run", str(path), "--device", "cpu"] + extra)
        assert e.value.code == 2
    with pytest.raises(ValueError, match="out of range"):
        cli.main(["run-node", str(path), "--node-id", "7", "--t-start", "0", "--run-id", "x",
                  "--device", "cpu"])
    assert "distributed" in cli.component_rows()["backends"]


def test_run_node_runs_the_dmtt_process(monkeypatch, tmp_path):
    """ROADMAP Queue C: the JAX package's run_single_node builds the plain
    NodeProcess for a dmtt: config (its runner builds DMTTNodeProcess); the
    port's run-node builds the DMTT process, as its runner does."""
    from murmura_tpu.distributed import node_process as jax_np
    from murmura_tpu_torch.distributed import node_process as t_np
    from murmura_tpu_torch.dmtt.node_process import DMTTNodeProcess

    seen = []
    monkeypatch.setattr(jax_np.NodeProcess, "run", lambda self: seen.append(type(self).__name__))
    monkeypatch.setattr(t_np.NodeProcess, "run", lambda self: seen.append(type(self).__name__))
    raw = _ring_raw(tmp_path, "x")
    raw.update(topology={"type": "fully", "num_nodes": 4}, mobility={}, dmtt={})
    jax_np.run_single_node(JaxConfig.model_validate(raw), 1, 0.0, "r")
    t_np.run_single_node(Config.model_validate(raw), 1, 0.0, "r", device="cpu")
    assert seen == ["NodeProcess", "DMTTNodeProcess"]
    assert issubclass(DMTTNodeProcess, t_np.NodeProcess)
