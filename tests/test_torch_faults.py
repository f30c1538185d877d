"""The port's operational fault model against the JAX package's, on the CPU.

- The seeded schedule (churn chain, link drops, stragglers) is the JAX
  package's bit for bit: ``alive_at``, ``link_mask_at``, ``straggler_at``,
  ``masked_adjacency``, ``masked_edge_mask``, ``alive_stack`` and the
  transition views, over 30 rounds for several seeds and parameter sets;
  so are the schedule and spec the config wiring builds.
- One faulted round of the 16-32-4 MLP (8 nodes, fully connected, Krum
  allgather, c = 1) through both round programs from the same spread
  initial parameters, with the JAX round's own shuffle fed to the port: a
  dead node, a node whose every neighbour is dead, a NaN-injected node and
  an IPM attacker whose broadcast overflows to inf.  ``agg_quarantined``,
  ``agg_attack_scrubbed`` and ``agg_alive`` are equal, Krum's selection is
  equal, and the parameters agree to a scaled delta of 1e-4 (max |port -
  jax| / max(1, max |jax|)); the dead and the quarantined nodes sit at
  their pre-round rows and the isolated node at its own trained row, bit
  for bit in the port.
- With ``nan_quarantine: false`` a NaN-injecting node poisons the fleet,
  and the port's history turns non-finite in the same rounds as the JAX
  package's (fedavg on a ring, and Krum on the fully-connected graph).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.attacks.ipm import make_ipm_attack as jax_ipm
from murmura_tpu.config import Config as JaxConfig
from murmura_tpu.core.network import effective_adjacency as jax_effective_adjacency
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.faults.schedule import FaultSchedule as JaxSchedule
from murmura_tpu.faults.schedule import FaultSpec as JaxSpec
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu.utils import factories as jax_factories
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.attacks.ipm import make_ipm_attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.network import Network, effective_adjacency
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.faults.schedule import FaultSchedule, FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils import factories

N = 8
SEED = 3  # selects node 3 as the one compromised node of 8 at 12.5%
DEAD, ISOLATED, NAN_NODE, ATTACKER = 5, 6, 2, 3
DATA = {"num_samples": 640, "input_dim": 16, "num_classes": 4}
HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)

SCHEDULES = [
    dict(crash_prob=0.2, recovery_prob=0.5, min_down_rounds=1, link_drop_prob=0.05,
         straggler_prob=0.1),
    dict(crash_prob=0.4, recovery_prob=0.3, min_down_rounds=3, link_drop_prob=0.3,
         straggler_prob=0.0),
    dict(crash_prob=0.0, recovery_prob=0.0, link_drop_prob=0.0, straggler_prob=0.5),
]


def _scaled_delta(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


@pytest.mark.parametrize("seed", [0, 777, 12345])
@pytest.mark.parametrize("which", range(len(SCHEDULES)))
def test_schedule_is_the_jax_packages(seed, which):
    kw = dict(SCHEDULES[which], seed=seed)
    n = 10
    ref, got = JaxSchedule(n, **kw), FaultSchedule(n, **kw)
    adj = jax_topology("k-regular", n, k=4).mask()
    edge_mask = np.ones((4, n), np.float32)
    offsets = [1, 2, 8, 9]
    for r in range(30):
        for name in ("alive_at", "link_mask_at", "straggler_at", "delivering_at",
                     "died_at", "recovered_at"):
            a, b = getattr(ref, name)(r), getattr(got, name)(r)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, r)
        assert np.array_equal(ref.masked_adjacency(adj, r), got.masked_adjacency(adj, r))
        assert np.array_equal(ref.masked_edge_mask(edge_mask, offsets, r),
                              got.masked_edge_mask(edge_mask, offsets, r))
    assert np.array_equal(ref.alive_stack(3, 20), got.alive_stack(3, 20))


def _chaos_config(cls, **faults):
    raw = {
        "experiment": {"name": "faults", "seed": SEED, "rounds": 6},
        "topology": {"type": "ring", "num_nodes": N},
        "aggregation": {"algorithm": "fedavg"},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic", "params": dict(DATA)},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "hidden_dims": [16], "num_classes": 4}},
        "faults": {"enabled": True, "seed": 5, "crash_prob": 0.2, "recovery_prob": 0.5,
                   "link_drop_prob": 0.1, "straggler_prob": 0.1,
                   "nan_inject_nodes": [NAN_NODE], **faults},
        "backend": "simulation",
    }
    return cls.model_validate(raw)


def test_config_wiring_builds_the_jax_schedule_and_spec():
    cfg, jcfg = _chaos_config(Config), _chaos_config(JaxConfig)
    got, ref = factories.build_fault_schedule(cfg), jax_factories.build_fault_schedule(jcfg)
    topo = create_topology("ring", N)
    for r in range(30):
        assert np.array_equal(got.alive_at(r), ref.alive_at(r))
        assert np.array_equal(effective_adjacency(topo, None, got, r),
                              jax_effective_adjacency(jax_topology("ring", N), None, ref, r))
    spec, jspec = factories.build_fault_spec(cfg), jax_factories.build_fault_spec(jcfg)
    assert (spec.nan_quarantine, spec.nan_inject_nodes, spec.nan_inject_from_round) == (
        jspec.nan_quarantine, jspec.nan_inject_nodes, jspec.nan_inject_from_round)
    cfg.faults.enabled = False
    assert factories.build_fault_schedule(cfg) is None and factories.build_fault_spec(cfg) is None


def test_schedule_with_unfaulted_program_refused():
    data = jax_data("synthetic", DATA, num_nodes=N, seed=SEED)
    prog = build_round_program(make_mlp(16, [32], 4), make_krum(num_compromised=1), data,
                               device="cpu", **HP)
    with pytest.raises(ValueError, match="built without faults"):
        Network(prog, create_topology("fully", N), fault_schedule=FaultSchedule(N, seed=1))


@pytest.fixture(scope="module")
def faulted_round():
    """The same faulted round through both packages (see the module
    docstring): (initial flat, JAX flat and metrics, port flat and metrics,
    the port's trained rows of the same round without faults)."""
    data = jax_data("synthetic", DATA, num_nodes=N, seed=SEED)
    spec = dict(nan_quarantine=True, nan_inject_nodes=(NAN_NODE,), nan_inject_from_round=0)
    jattack = jax_ipm(N, 0.125, epsilon=1e39, seed=SEED)
    assert np.flatnonzero(jattack.compromised).tolist() == [ATTACKER]
    jprog = jax_build_round(jax_mlp(16, [32], 4), jax_make_krum(num_compromised=1), data,
                            attack=jattack, faults=JaxSpec(**spec), **HP)
    rng = np.random.default_rng(SEED)
    scale = 0.05 * (1.0 + np.arange(N) / N)
    init = jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((N,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)

    adj = jax_topology("fully", N).mask()
    adj[ISOLATED, :] = adj[:, ISOLATED] = 0.0
    adj[ISOLATED, DEAD] = adj[DEAD, ISOLATED] = 1.0  # its one neighbour is dead
    alive = np.ones(N, np.float32)
    alive[DEAD] = 0.0
    comp = jattack.compromised.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    j_params, _, j_metrics = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state, key,
        jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(alive),
        jnp.asarray(0.0, jnp.float32),
        {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()},
    )
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
    train_key, _ = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))

    prog = build_round_program(make_mlp(16, [32], 4), make_krum(num_compromised=1), data,
                               attack=make_ipm_attack(N, 0.125, epsilon=1e39, seed=SEED),
                               faults=FaultSpec(**spec), init_params=init, device="cpu", **HP)
    assert prog.faulted
    flat, _, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.from_numpy(comp),
        0.0, draws={"u": [u]}, alive=torch.from_numpy(alive),
    )
    # The isolated node's own trained row: the same round without the NaN,
    # the attack and the quarantine changes nothing for it.
    plain = build_round_program(make_mlp(16, [32], 4), make_krum(num_compromised=1), data,
                                init_params=init, device="cpu", **HP)
    own, _, _ = plain.train_step(plain.init_flat, plain.init_agg_state,
                                 torch.zeros((N, N)), torch.zeros(N), 0.0, draws={"u": [u]})
    return prog.init_flat, j_flat, j_metrics, flat, metrics, own


def test_faulted_round_matches_jax(faulted_round):
    init_flat, j_flat, j_metrics, flat, metrics, own = faulted_round
    for k in ("agg_quarantined", "agg_attack_scrubbed", "agg_alive"):
        assert float(metrics[k]) == float(j_metrics[k]), k
    assert float(metrics["agg_quarantined"]) == 1.0
    assert float(metrics["agg_attack_scrubbed"]) == 1.0
    assert float(metrics["agg_alive"]) == N - 1.0
    assert np.array_equal(metrics["agg_selected_index"].numpy(),
                          np.asarray(j_metrics["agg_selected_index"]))
    # Krum selected somewhere (c = 1 < (m - 2) / 2 where m = 5).
    assert not bool(metrics["agg_selected_own"].all())
    assert np.isfinite(j_flat).all() and bool(torch.isfinite(flat).all())
    assert _scaled_delta(flat.numpy(), j_flat) <= 1e-4


def test_faulted_round_freezes_rolls_back_and_keeps_own(faulted_round):
    init_flat, j_flat, _, flat, metrics, own = faulted_round
    # Dead: frozen at the pre-round value.  Quarantined: rolled back.
    assert torch.equal(flat[DEAD], init_flat[DEAD])
    assert torch.equal(flat[NAN_NODE], init_flat[NAN_NODE])
    # No alive neighbour: the node keeps its own trained state.
    assert torch.equal(flat[ISOLATED], own[ISOLATED])
    assert not torch.equal(flat[ISOLATED], init_flat[ISOLATED])
    # The attacker's own state trains on (only its broadcast was scrubbed).
    assert bool(torch.isfinite(flat[ATTACKER]).all())
    for node in (DEAD, NAN_NODE, ISOLATED):
        assert _scaled_delta(flat[node].numpy(), j_flat[node]) <= 1e-4


@pytest.mark.parametrize("rule,topology", [("fedavg", "ring"), ("krum", "fully")])
def test_sentinel_off_turns_nonfinite_in_the_same_rounds(rule, topology):
    def config(cls):
        cfg = _chaos_config(cls, nan_quarantine=False, nan_inject_from_round=2,
                            crash_prob=0.0, link_drop_prob=0.0, straggler_prob=0.0)
        cfg.topology.type = topology
        cfg.aggregation.algorithm = rule
        if rule == "krum":
            cfg.aggregation.params = {"num_compromised": 1}
        return cfg

    got = factories.build_network_from_config(config(Config), device="cpu").train(rounds=5)
    ref = jax_factories.build_network_from_config(config(JaxConfig)).train(rounds=5)
    assert set(got) == set(ref)
    for k in ("mean_loss", "mean_accuracy"):
        finite = np.isfinite(got[k]).tolist()
        assert finite == np.isfinite(ref[k]).tolist(), (k, got[k], ref[k])
    # Rounds 1 and 2 precede the injection; the poison then reaches the fleet.
    assert np.isfinite(got["mean_loss"][:2]).all()
    assert not np.isfinite(got["mean_loss"][-1])
    assert got["agg_alive"] == ref["agg_alive"] == [float(N)] * 5
    assert "agg_quarantined" not in got
