"""Spawned runs of the port's ZMQ backend on the CPU that wait long on the
wall clock, marked slow as their JAX twins are
(tests/test_distributed.py's colluder runs, tests/test_faults_distributed.py,
tests/test_dmtt_distributed.py's full stack):

- ALIE and IPM colluders exchange benign states in the coalition
  (COLLUDE_STATE) and broadcast the estimated vector: every round
  completes with finite honest metrics;
- the FaultInjector SIGKILLs a scheduled node mid-run and respawns it
  from its per-node checkpoint at its scheduled recovery: the history's
  reporting count drops for the dead rounds and comes back;
- a DMTT run under mobility with topology liars completes with the
  agg_dmtt_* columns.
"""

import numpy as np
import pytest

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.distributed.runner import DistributedRunner
from murmura_tpu_torch.faults.schedule import FaultSchedule

pytestmark = pytest.mark.slow


def _cfg(tmp_path, nodes, rounds, duration, grace, **extra):
    raw = {
        "experiment": {"name": "dist-slow", "seed": 42, "rounds": rounds},
        "topology": {"type": "ring", "num_nodes": nodes},
        "aggregation": {"algorithm": "fedavg"},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 80 * nodes, "input_dim": 16, "num_classes": 4}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "num_classes": 4, "hidden_dims": [16]}},
        "backend": "distributed",
        "distributed": {"transport": "ipc", "ipc_dir": str(tmp_path),
                        "round_duration_s": duration, "startup_grace_s": grace},
    }
    raw.update(extra)
    return Config.model_validate(raw)


@pytest.mark.parametrize("attack_type", ["alie", "ipm"])
def test_colluders_run_with_coalition_statistics(tmp_path, attack_type):
    cfg = _cfg(tmp_path, 4, 2, 8.0, 30.0,
               aggregation={"algorithm": "krum", "params": {"num_compromised": 1}},
               attack={"enabled": True, "type": attack_type, "percentage": 0.5})
    history = DistributedRunner(cfg, device="cpu").run()
    assert history["round"] == [1, 2], history
    assert np.isfinite(history["honest_accuracy"]).all(), history
    assert np.isfinite(history["mean_loss"]).all(), history


NODES, ROUNDS = 4, 5
CHURN = dict(crash_prob=0.12, recovery_prob=0.8, min_down_rounds=2)


def _find_seed():
    """A seed whose schedule kills exactly one node for rounds 1-2 and
    recovers it for rounds 3-4, every other node up the whole run."""
    for seed in range(5000):
        s = FaultSchedule(NODES, seed=seed, **CHURN)
        alive = np.stack([s.alive_at(r) for r in range(ROUNDS)]) > 0
        victims = np.flatnonzero(~alive.all(axis=0))
        if len(victims) != 1:
            continue
        v = victims[0]
        if alive[0, v] and not alive[1, v] and not alive[2, v] and alive[3, v] and alive[4, v]:
            return seed, int(v)
    raise AssertionError("no seed produced the wanted churn pattern")


def test_sigkill_and_checkpoint_recovery(tmp_path):
    seed, victim = _find_seed()
    cfg = _cfg(tmp_path, NODES, ROUNDS, 15.0, 30.0,
               topology={"type": "fully", "num_nodes": NODES},
               faults={"enabled": True, "seed": seed, **CHURN})
    runner = DistributedRunner(cfg, device="cpu")
    runner.start()
    assert runner.injector is not None
    history = runner.wait()
    kinds = {(kind, node) for _, kind, node in runner.injector.events}
    assert ("kill", victim) in kinds and ("respawn", victim) in kinds, runner.injector.events
    assert history["round"] == list(range(1, ROUNDS + 1)), history
    assert history["reporting_nodes"] == [NODES, NODES - 1, NODES - 1, NODES, NODES], history
    assert any((d / f"node_{victim}.ckpt.npz").exists()
               for d in tmp_path.iterdir() if d.is_dir())
    accs = np.asarray(history["mean_accuracy"], dtype=np.float64)
    assert np.isfinite(accs[-1]) and accs[-1] > 0.3, history


def test_dmtt_run_with_liars(tmp_path):
    cfg = _cfg(tmp_path, 4, 2, 8.0, 30.0,
               topology={"type": "fully", "num_nodes": 4},
               mobility={"area_size": 100.0, "comm_range": 60.0, "seed": 42},
               dmtt={"budget_B": 2},
               attack={"enabled": True, "type": "topology_liar", "percentage": 0.25,
                       "params": {"model_attack_type": "gaussian", "noise_std": 1.0}})
    history = DistributedRunner(cfg, device="cpu").run()
    assert history["round"] == [1, 2], history
    assert np.isfinite(history["mean_accuracy"][-1]), history
    assert len(history["agg_dmtt_collab_count"]) == 2, history
