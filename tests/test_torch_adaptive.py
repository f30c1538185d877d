"""Closed-loop adaptive attacks in the port (attacks/adaptive.py, the
adaptive block of core/rounds.py, the factories' twins, the snapshot
registry and the gang's stage reset), against the JAX package on the CPU.

- The state machines on the same [N] inputs, bit-equal: the bisection's
  growth, bisection and a rejection at the cap that pins the bracket;
  unobserved rows frozen and honest rows never moving; adaptive ALIE's z
  and adaptive IPM's epsilon walking and clamped; ``acceptance_feedback``
  with and without taps, scrub and quarantine as rejections, dead rows not
  observed.  ``apply_adaptive`` within rtol 1e-6 in float32 (the two
  frameworks reduce the colluders' statistics in other orders, as in
  tests/test_torch_attacks.py) and bit-equal in bfloat16; scale 0 gives
  back the honest broadcast.
- The factories and the schema: every attack type with
  ``adaptive.enabled`` builds the JAX package's twin (name, state keys,
  compromised set), and the refusals carry its messages.
- Adaptive rounds against the JAX round program, three chained rounds
  through the ``draws`` seam (the JAX rounds' own shuffle keys and attack
  noise): Krum dense, circulant and on the sparse exponential graph,
  BALANCE dense and the median (no taps: the attacker escalates blind).
  Picks equal, ``agg_atk_*``, ``agg_tap_*`` and the carried ``atk_*``
  state equal (rtol 1e-6 on the acceptance EMA, whose multiply-adds XLA
  may fuse), parameters within a scaled 1e-4.  One round under int8 error
  feedback, and one under the fault model (a scrubbed attack row counts as
  a rejection, a dead compromised node's state stays frozen).
- A bisection run resumed at every round boundary of 6 is bit-equal to the
  uninterrupted one; the snapshot registry names ``ATTACK_STATE_KEYS``.
- The gang: adaptive members adapt independently, each bit-equal to its
  single run; ``reset_run`` then ``train`` is bit-equal to a fresh gang of
  those members and builds no program; ``reset_run``'s refusals.
- An adaptive attack under cohort streaming (population:), which the JAX
  package composes: the state carried across the swaps.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pydantic
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.attacks import adaptive as JA
from murmura_tpu.attacks.directed import make_directed_deviation_attack as jax_directed
from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.attacks.ipm import make_ipm_attack as jax_ipm
from murmura_tpu.config.schema import Config as JaxConfig
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.faults.schedule import FaultSpec as JaxFaultSpec
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.ops.compress import CompressionSpec as JaxCompressionSpec
from murmura_tpu.utils.factories import build_attack as jax_build_attack
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.attacks import adaptive as TA
from murmura_tpu_torch.attacks.directed import make_directed_deviation_attack
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.attacks.ipm import make_ipm_attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.gang import GangMember
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.durability import snapshot as S
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops.compress import CompressionSpec
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils.factories import (
    build_attack,
    build_gang_from_config,
    build_network_from_config,
    build_program,
    build_topology,
)

N = 12
SEED = 7


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _jax(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def _torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _assert_state_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


# ---------------------------------------------------------------------------
# the state machines


def _step_both(jatk, tatk, j_state, t_state, accept, observed, comp):
    j_state = jatk.update_attack_state(_jax(j_state), jnp.asarray(accept), jnp.asarray(observed),
                                       jnp.asarray(comp))
    t_state = tatk.update_attack_state(_torch(t_state), torch.from_numpy(accept),
                                       torch.from_numpy(observed), torch.from_numpy(comp))
    j_state, t_state = _np(j_state), {k: v.numpy() for k, v in t_state.items()}
    _assert_state_equal(t_state, j_state)
    return j_state, t_state


def test_bisection_state_machine_matches_jax():
    # Rows: 0 always accepted (grows to the cap and stays), 1 accepted three
    # times then rejected at the cap (the bracket pins at [4, 8]), 2 random,
    # 3 honest, 4 compromised but never observed, 5 alternating.
    comp = np.array([1, 1, 1, 0, 1, 1], np.float32)
    jatk = JA.make_bisection_attack(jax_gaussian(6, 0.5, noise_std=1.0))
    tatk = TA.make_bisection_attack(make_gaussian_attack(6, 0.5, noise_std=1.0))
    init = jatk.init_attack_state(6)
    _assert_state_equal(tatk.init_attack_state(6), init)
    j_state, t_state = init, init
    rng = np.random.default_rng(0)
    for t in range(12):
        accept = np.array([1.0, 1.0 if t < 3 else 0.0, rng.choice([0.0, 0.25, 1.0]),
                           1.0, 1.0, float(t % 2)], np.float32)
        observed = np.array([1, 1, 1, 1, 0, 1], np.float32)
        j_state, t_state = _step_both(jatk, tatk, j_state, t_state, accept, observed, comp)
        if t == 3:
            # The rejection at the cap (scale 8) pinned the bracket [4, 8].
            assert (t_state["atk_lo"][1], t_state["atk_hi"][1]) == (4.0, 8.0)
    assert t_state["atk_scale"][0] == 8.0 and t_state["atk_hi"][0] == 16.0
    for k in tatk.state_keys:
        assert t_state[k][3] == init[k][3] and t_state[k][4] == init[k][4], k


@pytest.mark.parametrize("kind", ["alie", "ipm"])
def test_walks_match_jax_and_clamp(kind):
    comp = np.array([1, 1, 0, 1, 1, 0, 1, 0], np.float32)
    if kind == "alie":
        jatk, tatk, key = (JA.make_adaptive_alie_attack(8, 0.5, seed=3),
                           TA.make_adaptive_alie_attack(8, 0.5, seed=3), "atk_z")
        lo = 0.05
    else:
        jatk, tatk, key = (JA.make_adaptive_ipm_attack(8, 0.5, seed=3),
                           TA.make_adaptive_ipm_attack(8, 0.5, seed=3), "atk_eps")
        lo = 0.05
    assert tatk.name == jatk.name and tatk.state_keys == jatk.state_keys
    init = jatk.init_attack_state(8)
    _assert_state_equal(tatk.init_attack_state(8), init)
    j_state = t_state = init
    for t in range(30):
        # Row 0 always accepted (climbs to the cap), row 1 always rejected
        # (falls to the floor), row 3 unobserved, row 4 fractional.
        accept = np.array([1.0, 0.0, 1.0, 1.0, 0.5 if t % 3 else 0.0, 1.0, 0.0, 1.0],
                          np.float32)
        observed = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
        j_state, t_state = _step_both(jatk, tatk, j_state, t_state, accept, observed, comp)
    cap = max(4.0 * abs(float(init[key][0])), 4.0)
    assert t_state[key][0] == np.float32(cap) and t_state[key][1] == np.float32(lo)
    assert t_state[key][3] == init[key][3] and t_state[key][2] == init[key][2]


def test_acceptance_feedback_matches_jax():
    rng = np.random.default_rng(1)
    n = 10
    sel = rng.integers(0, 4, n).astype(np.float32)
    cons = rng.integers(0, 5, n).astype(np.float32)
    cons[2] = 0.0  # considered by nobody: not observed
    in_deg = np.full(n, 4.0, np.float32)
    scrub = np.zeros(n, np.float32)
    scrub[[2, 5]] = 1.0
    quar = np.zeros(n, np.float32)
    quar[7] = 1.0
    alive = np.ones(n, np.float32)
    alive[[5, 8]] = 0.0
    for agg_stats in ({"tap_selected_by": sel, "tap_considered_by": cons},
                      {"tap_selected_by": sel}, {}):
        for fault_stats in ({}, {"tap_attack_scrubbed": scrub, "tap_quarantined": quar}):
            for a in (None, alive):
                ref = JA.acceptance_feedback(_jax(agg_stats), _jax(fault_stats),
                                             jnp.asarray(in_deg),
                                             None if a is None else jnp.asarray(a))
                got = TA.acceptance_feedback(_torch(agg_stats), _torch(fault_stats),
                                             torch.from_numpy(in_deg),
                                             None if a is None else torch.from_numpy(a))
                for g, r in zip(got, ref):
                    assert np.array_equal(g.numpy(), np.asarray(r))
                accept, observed = (g.numpy() for g in got)
                if fault_stats:
                    # A scrubbed or quarantined row is an observed rejection.
                    assert accept[2] == accept[7] == 0.0 and observed[7] == 1.0
                if a is not None:
                    assert observed[5] == observed[8] == 0.0


def _attacks_for_apply():
    return {
        "alie": (JA.make_adaptive_alie_attack(N, 0.4, seed=SEED),
                 TA.make_adaptive_alie_attack(N, 0.4, seed=SEED)),
        "alie_coalition": (JA.make_adaptive_alie_attack(N, 0.4, seed=SEED, estimator="coalition"),
                           TA.make_adaptive_alie_attack(N, 0.4, seed=SEED, estimator="coalition")),
        "ipm": (JA.make_adaptive_ipm_attack(N, 0.4, seed=SEED),
                TA.make_adaptive_ipm_attack(N, 0.4, seed=SEED)),
        # Around directed deviation, whose bfloat16 rows are the JAX
        # package's bits (the gaussian draws its bfloat16 noise in JAX's
        # own arithmetic; the rounds below hold it in float32).
        "bisection": (JA.make_bisection_attack(jax_directed(N, 0.4, seed=SEED)),
                      TA.make_bisection_attack(make_directed_deviation_attack(N, 0.4,
                                                                              seed=SEED))),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["alie", "alie_coalition", "ipm", "bisection"])
def test_apply_adaptive_matches_jax(name, dtype):
    jatk, tatk = _attacks_for_apply()[name]
    assert np.array_equal(tatk.compromised, jatk.compromised)
    rng = np.random.default_rng(2)
    flat = rng.normal(size=(N, 300)).astype(np.float32)
    comp = jatk.compromised.astype(np.float32)
    state = {k: v * rng.uniform(0.2, 2.0, N).astype(np.float32)
             for k, v in jatk.init_attack_state(N).items()}
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (int(comp.sum()), 300), jnp.float32))
    jflat = jnp.asarray(flat).astype(dtype)
    tflat = torch.from_numpy(flat).to(getattr(torch, dtype))
    ref = np.asarray(jatk.apply_adaptive(jflat, jnp.asarray(comp), key, 0, _jax(state))
                     .astype(jnp.float32))
    got = tatk.apply_adaptive(tflat, torch.from_numpy(comp), None, _torch(state),
                              noise=torch.from_numpy(noise)).to(torch.float32).numpy()
    if dtype == "bfloat16":
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    honest = ~jatk.compromised
    assert np.array_equal(got[honest], np.asarray(jflat.astype(jnp.float32))[honest])
    if name == "bisection":
        # Scale 0 gives back the honest broadcast.
        zero = {**state, "atk_scale": np.zeros(N, np.float32)}
        out = tatk.apply_adaptive(tflat, torch.from_numpy(comp), None, _torch(zero),
                                  noise=torch.from_numpy(noise))
        assert torch.equal(out, tflat)


# ---------------------------------------------------------------------------
# the factories and the schema


def _raw(**over):
    raw = {
        "experiment": {"name": "adaptive-test", "seed": SEED, "rounds": 6, "verbose": False},
        "topology": {"type": "k-regular", "num_nodes": N, "k": 4},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.4,
                   "params": {"noise_std": 10.0}, "adaptive": {"enabled": True}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 240, "input_shape": [8], "num_classes": 4}},
        "model": {"factory": "mlp", "params": {"input_dim": 8, "hidden_dims": [16],
                                               "num_classes": 4}},
        "backend": "simulation",
    }
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v} if isinstance(v, dict) else v
    return raw


@pytest.mark.parametrize("kind, params", [
    ("gaussian", {"noise_std": 3.0}), ("directed_deviation", {"lambda_param": -2.0}),
    ("alie", {}), ("alie", {"estimator": "coalition", "z": 0.8}), ("ipm", {"epsilon": 0.7}),
])
def test_factories_build_the_jax_twins(kind, params):
    raw = _raw(attack={"type": kind, "params": {**params, "seed": 3},
                       "adaptive": {"enabled": True, "scale_max": 4.0, "eta": 0.1}})
    ref = jax_build_attack(JaxConfig.model_validate(copy.deepcopy(raw)))
    got = build_attack(Config.model_validate(copy.deepcopy(raw)))
    assert isinstance(got, TA.AdaptiveAttack)
    assert (got.name, got.state_keys, got.trains_locally) == (
        ref.name, ref.state_keys, ref.trains_locally)
    assert np.array_equal(got.compromised, ref.compromised)
    _assert_state_equal(got.init_attack_state(N), ref.init_attack_state(N))


@pytest.mark.parametrize("over", [
    {"attack": {"type": "label_flip"}},
    {"attack": {"type": "topology_liar"}},
    {"exchange": {"pipeline": True}},
    {"dmtt": {"allow_static": True}},
    {"backend": "distributed"},
], ids=["label_flip", "topology_liar", "pipeline", "dmtt", "distributed"])
def test_refusals_are_the_jax_packages(over):
    raw = _raw(**over)
    with pytest.raises(pydantic.ValidationError) as ref:
        JaxConfig.model_validate(copy.deepcopy(raw))
    with pytest.raises(pydantic.ValidationError) as got:
        Config.model_validate(copy.deepcopy(raw))
    assert [e["msg"] for e in got.value.errors()] == [e["msg"] for e in ref.value.errors()]


def test_round_program_refusals():
    cfg = Config.model_validate(_raw())
    topology = build_topology(cfg)
    attack = build_attack(cfg)
    with pytest.raises(ValueError, match="exchange.pipeline does not compose with attack.adaptive"):
        build_program(cfg.model_copy(update={"exchange": cfg.exchange.model_copy(
            update={"pipeline": True})}), topology, attack, SEED, "cpu")
    # A bisection around a data-poisoning attack has nothing to scale.
    from murmura_tpu_torch.attacks.label_flip import make_label_flip

    with pytest.raises(ValueError, match="poisons data"):
        TA.make_bisection_attack(make_label_flip(N, 0.4))


def test_registry_names_the_attack_state():
    assert S.RESERVED_AGG_STATE_KEY_GROUPS["ATTACK_STATE_KEYS"] == (
        "murmura_tpu_torch.attacks.adaptive")
    assert TA.ATTACK_STATE_KEYS == JA.ATTACK_STATE_KEYS
    covered = set()
    for name, build in TA.ADAPTIVE_ATTACKS.items():
        keys = build().state_keys
        assert set(keys) <= set(TA.ATTACK_STATE_KEYS) and keys == JA.ADAPTIVE_ATTACKS[name]().state_keys
        covered |= set(keys)
    assert covered == set(TA.ATTACK_STATE_KEYS)


# ---------------------------------------------------------------------------
# adaptive rounds against the JAX round program

HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)
DATA = {"num_samples": 240, "input_shape": [8], "num_classes": 4}
KREG_OFFSETS = (1, 2, 10, 11)
EXP_OFFSETS = (1, 2, 4, 8)


def _spread(jprog, n, seed):
    """Node 0's initial parameters for every node plus offsets of distinct
    scales, so that no Krum score sits on a float32 tie."""
    rng = np.random.default_rng(seed)
    scale = 0.05 * (1.0 + np.arange(n) / n)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((n,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)


def _jax_draws(key, data, n_comp, model_dim):
    """The JAX round's draws (its core/rounds.py key splits)."""
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))
    noise = np.array(jax.random.normal(attack_key, (n_comp, model_dim)))
    return {"u": [u], "noise": noise}


def _attack_pair(kind, noise_std=1.0):
    if kind == "bisection":
        return (JA.make_bisection_attack(jax_gaussian(N, 0.4, noise_std=noise_std, seed=SEED)),
                TA.make_bisection_attack(make_gaussian_attack(N, 0.4, noise_std=noise_std,
                                                              seed=SEED)))
    if kind == "bisection_ipm_overflow":
        return (JA.make_bisection_attack(jax_ipm(N, 0.4, epsilon=1e39, seed=SEED)),
                TA.make_bisection_attack(make_ipm_attack(N, 0.4, epsilon=1e39, seed=SEED)))
    return (JA.make_adaptive_alie_attack(N, 0.4, seed=SEED),
            TA.make_adaptive_alie_attack(N, 0.4, seed=SEED))


# case: (rule, params, attack, sparse offsets or None, rounds, build options).
# The bisection's gaussian std: 0.02 under Krum, where the first round's
# probe is taken by some receivers and the next rejected (0.05 and up is
# rejected at once), 1.0 under BALANCE.
ROUND_CASES = {
    "krum_dense": ("krum", {"num_compromised": 1}, "bisection", None, 3, {"std": 0.02}),
    "krum_circulant": ("krum", {"num_compromised": 1, "exchange_offsets": list(KREG_OFFSETS)},
                       "bisection", None, 3, {"std": 0.02}),
    "krum_sparse": ("krum", {"num_compromised": 1, "exchange_offsets": list(EXP_OFFSETS),
                             "sparse_exchange": True}, "bisection", EXP_OFFSETS, 3,
                    {"std": 0.02}),
    "balance_dense": ("balance", {}, "bisection", None, 3, {"std": 1.0}),
    "median_dense": ("median", {}, "alie", None, 3, {}),
    "krum_dense_int8": ("krum", {"num_compromised": 1}, "bisection", None, 1,
                        {"compression": "int8", "std": 0.02}),
    "krum_dense_faulted": ("krum", {"num_compromised": 1}, "bisection_ipm_overflow", None, 1,
                           {"faults": True}),
}
# The acceptance EMA: (1 - beta) * ema + beta * accept, which XLA may fuse.
EMA_KEYS = ("atk_accept_ema", "agg_atk_accept_ema")


def _close(got, ref, key):
    got, ref = np.asarray(got), np.asarray(ref)
    if key in EMA_KEYS:
        np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=key)
    else:
        assert np.array_equal(got, ref), key


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_adaptive_rounds_match_jax(case):
    rule, params, kind, offsets, rounds, opts = ROUND_CASES[case]
    jattack, attack = _attack_pair(kind, opts.get("std", 1.0))
    data = jax_data("synthetic", DATA, num_nodes=N, seed=SEED)
    jkw, tkw = {}, {}
    if offsets is not None:
        jkw["sparse_offsets"] = tkw["sparse_offsets"] = offsets
    if opts.get("compression"):
        jkw["compression"] = JaxCompressionSpec("int8", error_feedback=True)
        tkw["compression"] = CompressionSpec("int8", error_feedback=True)
    alive = None
    if opts.get("faults"):
        jkw["faults"], tkw["faults"] = JaxFaultSpec(), FaultSpec()
        alive = np.ones(N, np.float32)
        dead = int(np.flatnonzero(jattack.compromised)[0])
        alive[dead] = 0.0
    jprog = jax_build_round(jax_mlp(8, [16], 4), JAX_AGGREGATORS[rule](**params), data,
                            attack=jattack, **jkw, **HP)
    init = _spread(jprog, N, SEED)
    prog = build_round_program(make_mlp(8, [16], 4), AGGREGATORS[rule](**params), data,
                               attack=attack, init_params=init, device="cpu", **tkw, **HP)
    assert set(attack.state_keys) <= set(prog.init_agg_state)
    if offsets is not None:
        adj = np.ones((len(offsets), N), np.float32)
    else:
        adj = create_topology("k-regular", N, k=4).mask().astype(np.float32)
    if alive is not None:
        adj = adj * alive[:, None] * alive[None, :]
    comp = jattack.compromised.astype(np.float32)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    step = jax.jit(jprog.train_step)
    j_params, j_state = jax.tree_util.tree_map(jnp.asarray, init), jprog.init_agg_state
    t_flat, t_state = prog.init_flat, prog.init_agg_state
    pre_dead = None if alive is None else {k: t_state[k][dead].item() for k in attack.state_keys}
    seen = set()
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), r)
        jargs = [jnp.asarray(adj), jnp.asarray(comp)]
        if alive is not None:
            jargs.append(jnp.asarray(alive))
        j_params, j_state, j_m = step(j_params, j_state, key, *jargs,
                                      jnp.asarray(float(r), jnp.float32), d)
        draws = _jax_draws(key, data, int(comp.sum()), prog.model_dim)
        t_flat, t_state, t_m = prog.train_step(
            t_flat, t_state, torch.from_numpy(adj), torch.from_numpy(comp), float(r),
            draws=draws, alive=None if alive is None else torch.from_numpy(alive))
        j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
        scale = max(1.0, float(np.abs(j_flat).max()))
        assert float(np.abs(t_flat.numpy() - j_flat).max()) / scale <= 1e-4, r
        keys = {k for k in j_m if k.startswith(("agg_atk_", "agg_tap_"))}
        assert keys == {k for k in t_m if k.startswith(("agg_atk_", "agg_tap_"))}
        assert "agg_atk_accept" in keys
        for k in keys | ({"agg_selected_index"} & set(j_m)):
            _close(t_m[k].numpy(), j_m[k], k)
        for k in attack.state_keys:
            _close(t_state[k].numpy(), j_state[k], k)
        seen |= set(np.unique(t_m["agg_atk_accept"].numpy()[comp > 0]).tolist())
    if rounds > 1 and rule != "median":
        assert {0.0} < seen, seen  # the rule both rejected and took compromised rows
    if case == "median_dense":
        assert np.all(t_state["atk_z"].numpy()[comp > 0] > jattack.init_attack_state(N)["atk_z"][0])
    if alive is not None:
        # The overflowing broadcasts were scrubbed (observed rejections); the
        # dead compromised node was not observed, its state frozen.
        assert float(t_m["agg_attack_scrubbed"]) == comp.sum()
        live_comp = (comp > 0) & (alive > 0)
        assert np.all(t_state["atk_hi"].numpy()[live_comp] == 1.0)
        assert {k: t_state[k][dead].item() for k in attack.state_keys} == pre_dead


# ---------------------------------------------------------------------------
# durability and the gang


def test_resumed_bisection_run_is_bit_equal(tmp_path):
    cfg = Config.model_validate(_raw(attack={"params": {"noise_std": 0.02}}))
    ref = build_network_from_config(cfg, device="cpu")
    ref.train(6)
    assert "atk_lo" in ref.agg_state and any(ref.history["agg_atk_lo"])
    for stop in range(1, 6):
        ckpt = tmp_path / f"stop{stop}"
        first = build_network_from_config(cfg, device="cpu")
        first.train(stop, checkpoint_dir=str(ckpt))
        resumed = build_network_from_config(cfg, device="cpu")
        assert resumed.restore_checkpoint(str(ckpt)) == stop
        resumed.train(6 - stop)
        assert resumed.history == ref.history
        assert torch.equal(resumed.flat, ref.flat)
        for k, v in ref.agg_state.items():
            assert torch.equal(resumed.agg_state[k], v), (stop, k)


def _gang_raw(members, **over):
    return _raw(sweep={"members": members}, attack={"params": {"noise_std": 0.02, "seed": SEED}},
                **over)


def test_adaptive_members_are_their_single_runs():
    members = [{"seed": 7, "attack_scale": 1.0}, {"seed": 11, "attack_scale": 0.25}]
    cfg = Config.model_validate(_gang_raw(members))
    gang = build_gang_from_config(cfg, device="cpu")
    histories = gang.train(4, rounds_per_dispatch=2)
    topology, attack = build_topology(cfg), build_attack(cfg)
    states = []
    for s, m in enumerate(members):
        single_cfg = cfg.model_copy(deep=True)
        single_cfg.experiment.seed = m["seed"]
        prog, _ = build_program(single_cfg, topology, attack, m["seed"], "cpu",
                                attack_scale=m["attack_scale"])
        net = Network(prog, topology, attack=attack, seed=m["seed"])
        net.train(4)
        assert histories[s] == net.history, m
        assert torch.equal(gang.flats[s], net.flat)
        for k, v in net.agg_state.items():
            assert torch.equal(gang.agg_states[s][k], v), (m, k)
        states.append(net.agg_state["atk_scale"])
    assert not torch.equal(states[0], states[1])  # each member's attacker its own


def test_stage_reset_equals_a_fresh_gang():
    first = [{"seed": 7, "attack_scale": 0.0}, {"seed": 7, "attack_scale": 1.0},
             {"seed": 11, "attack_scale": 0.0}, {"seed": 11, "attack_scale": 1.0}]
    second = [{**m, "attack_scale": g} for m, g in zip(first, (0.0, 3.0, 0.0, 3.0))]
    gang = build_gang_from_config(Config.model_validate(_gang_raw(first)), device="cpu",
                                  retain_init=True)
    gang.train(3, eval_every=3, rounds_per_dispatch=3)
    gang.reset_run([GangMember(**m) for m in second])
    assert gang.current_round == 0 and gang.round_times == []
    got = gang.train(3, eval_every=3, rounds_per_dispatch=3)
    assert gang.program_builds == 1  # the stage ran on the chunk program already built
    fresh = build_gang_from_config(Config.model_validate(_gang_raw(second)), device="cpu")
    ref = fresh.train(3, eval_every=3, rounds_per_dispatch=3)
    assert got == ref
    assert torch.equal(gang.flats, fresh.flats)
    for s in range(4):
        for k, v in fresh.agg_states[s].items():
            assert torch.equal(gang.agg_states[s][k], v), (s, k)


def test_reset_run_refusals():
    members = [{"seed": 7, "attack_scale": 0.0}, {"seed": 7, "attack_scale": 1.0},
               {"seed": 11, "attack_scale": 1.0}]
    cfg = Config.model_validate(_gang_raw(members))
    plain = build_gang_from_config(cfg, device="cpu")
    same = [GangMember(**m) for m in members]
    with pytest.raises(ValueError, match="retain_init=True"):
        plain.reset_run(same)
    gang = build_gang_from_config(cfg, device="cpu", retain_init=True)
    with pytest.raises(ValueError, match="changes seed 11 -> 12"):
        gang.reset_run(same[:2] + [GangMember(seed=12, attack_scale=1.0)])
    with pytest.raises(ValueError, match="got 1 members for a gang of 3"):
        gang.reset_run(same[:1])
    with pytest.raises(ValueError, match="not distinct"):
        gang.reset_run([same[1], same[1], same[2]])
    with pytest.raises(ValueError, match="only meaningful on the re-tenanting path"):
        gang.reset_run(same, telemetry_writers=[])
    # Re-tenanting (the grid's and the serve daemon's admission) takes up to
    # the gang's batch, next_bucket(3) = 4, as in the JAX package.
    with pytest.raises(ValueError, match="cannot admit 5 members into a bucket of batch 4"):
        gang.reset_run(same + same[:2], member_programs=[gang.program] * 5)


def test_adaptive_attack_runs_under_population():
    # The JAX package composes the two (population/engine.py's manifest):
    # the attack state rides agg_state per slot across cohort swaps.
    import yaml

    raw = yaml.safe_load((Path(__file__).resolve().parents[1] / "examples" / "configs"
                          / "population_1m.yaml").read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    raw["population"]["virtual_size"] = 1000
    raw["attack"] = {"enabled": True, "type": "gaussian", "percentage": 0.2,
                     "params": {"noise_std": 1.0}, "adaptive": {"enabled": True}}
    net = build_network_from_config(Config.model_validate(raw), device="cpu")
    try:
        history = net.train(2)
    finally:
        net.bank.close()
    assert net.cohorts_seen == 2 and "atk_scale" in net.agg_state
    assert history["agg_atk_scale"][1] < history["agg_atk_scale"][0]
