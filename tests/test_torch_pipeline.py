"""Pipelined rounds in the port (core/pipeline.py) and the tpu: section's
runtime guards, on the CPU.  Eight nodes, k-regular(4), the 16-16-4 MLP of
pipelined_rounds.yaml on synthetic data, a few rounds.

- ``init_pipeline_state`` equals the JAX package's (float32 and bfloat16,
  with and without staleness).
- A pipelined run is bit-equal to the port's ``run_delayed_reference``
  (the serialized program driven through the explicit one-round-delayed
  recursion) over 6 rounds: plain Krum, faulted fedavg, the int8 median
  under a gaussian attack, and the stale composition (whose broadcast
  buffer is the stale cache); ``agg_pipe_valid`` is [0, 1, 1, ...].
- Three chained pipelined rounds through the port and through the JAX
  package's pipelined program, from the same spread initial parameters,
  each round fed the JAX round's own shuffle and attack noise, dense and
  circulant: Krum's picks and ``agg_pipe_valid`` equal every round, the
  parameters and the buffered rows within a scaled 1e-4 (max |port - jax|
  / max(1, max |jax|): each package trains its own rows in float32).
- Fused dispatch is bit-equal to per-round dispatch, with ``eval_every``
  cutting across chunks, and across ``train`` calls split at a
  buffer-populated boundary.
- ``phase_times`` carry ``overlap: "pipelined"`` only on a pipelined run,
  and the report renders the critical path only then.
- The serialized program is unchanged by the split of its round into
  production and aggregation: four serialized runs' histories equal the
  values the port gave before the split (pinned below; decisions and
  accuracies exactly, the float statistics within rtol 1e-6, so the pin
  holds on another CPU's float rounding too).
- The guards: ``recompile_guard`` raises on a fused program rebuilt for a
  key that has run and on a kernel build forced after a key's first chunk
  (through ``ops._build.build_all`` with a stand-in compiler), and not on
  a ragged last chunk; ``pipelined_rounds.yaml`` runs as committed with
  the guard on; ``transfer_guard`` changes nothing on the CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.attacks.gaussian import make_gaussian_attack as jax_gaussian
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.core import pipeline as JP
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.config import Config, load_config
from murmura_tpu_torch.core import network as net_mod
from murmura_tpu_torch.core import pipeline as P
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops import _build
from murmura_tpu_torch.telemetry.report import build_report
from murmura_tpu_torch.telemetry.writer import events_of_type
from murmura_tpu_torch.utils.factories import build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
N = 8
SEED = 3
OFFSETS = [1, 2, 6, 7]  # k-regular(4) on 8 nodes
DATA = {"num_samples": 320, "input_dim": 16, "num_classes": 4}
HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=SEED)
FAULTS = {"enabled": True, "straggler_prob": 0.4, "link_drop_prob": 0.2, "seed": 11}
ATTACK = {"enabled": True, "type": "gaussian", "percentage": 0.25,
          "params": {"noise_std": 5.0}}


def _raw(**over):
    raw = {
        "experiment": {"name": "pipe", "seed": SEED, "rounds": 8},
        "topology": {"type": "k-regular", "num_nodes": N, "k": 4},
        "aggregation": {"algorithm": "krum"},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic", "params": dict(DATA)},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "hidden_dims": [16], "num_classes": 4}},
        "backend": "simulation",
    }
    raw.update(over)
    return raw


def _net(**over):
    return build_network_from_config(Config.model_validate(_raw(**over)), device="cpu")


def _pipelined(over):
    exchange = {**over.get("exchange", {}), "pipeline": True}
    return _net(**{**over, "exchange": exchange})


def _scaled_delta(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# the buffer


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_pipeline_state_equals_jax(stale, dtype):
    ref = JP.init_pipeline_state(6, 10, jnp.dtype(dtype), stale=stale)
    got = P.init_pipeline_state(6, 10, getattr(torch, dtype), stale=stale)
    assert set(got) == set(ref) == set(P.pipeline_state_keys(stale))
    assert P.PIPELINE_STATE_KEYS == JP.PIPELINE_STATE_KEYS
    for k in ref:
        assert str(got[k].dtype).replace("torch.", "") == str(np.asarray(ref[k]).dtype), k
        assert np.array_equal(got[k].to(torch.float32).numpy(),
                              np.asarray(ref[k], np.float32)), k


# ---------------------------------------------------------------------------
# the pipelined program against the explicit delayed recursion


PARITY = {
    "plain_krum": {},
    "faulted_fedavg": {"faults": FAULTS, "aggregation": {"algorithm": "fedavg"}},
    "int8_median_attack": {
        "compression": {"algorithm": "int8", "error_feedback": True, "block": 32},
        "attack": ATTACK, "aggregation": {"algorithm": "median"}},
    "stale_composition": {"exchange": {"max_staleness": 2, "staleness_discount": 0.5},
                          "faults": FAULTS},
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_pipelined_equals_delayed_reference(case):
    over = PARITY[case]
    net = _pipelined(over)
    history = net.train(6)
    ref_flat, ref_history = P.run_delayed_reference(_net(**over), 6)
    assert torch.equal(net.flat, ref_flat)
    assert history["mean_accuracy"] == ref_history["mean_accuracy"]
    assert history["mean_loss"] == ref_history["mean_loss"]
    assert history["agg_pipe_valid"] == [0.0] + [1.0] * 5
    if case == "stale_composition":
        # The stale cache is the broadcast buffer: no duplicate is carried.
        assert P.BCAST_KEY not in net.agg_state and P.OWN_KEY in net.agg_state
        assert any(v > 0 for v in history["agg_stale_used"])


def test_delayed_reference_refuses_a_pipelined_network():
    with pytest.raises(ValueError, match="SERIALIZED"):
        P.run_delayed_reference(_pipelined({}), 1)


# ---------------------------------------------------------------------------
# three chained pipelined rounds against the JAX package's


@pytest.mark.parametrize("exchange", ["allgather", "ppermute"])
def test_chained_pipelined_rounds_match_jax(exchange):
    kw = {"num_compromised": 1, "max_candidates": 5}
    if exchange == "ppermute":
        kw["exchange_offsets"] = OFFSETS
    data = jax_data("synthetic", DATA, num_nodes=N, seed=SEED)
    jattack = jax_gaussian(N, 0.25, noise_std=10.0, seed=SEED)
    jprog = jax_build_round(jax_mlp(16, [16], 4), jax_make_krum(**kw), data, attack=jattack,
                            pipeline=True, **HP)
    rng = np.random.default_rng(SEED)
    scale = 0.05 * (1.0 + np.arange(N) / N)
    init = jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((N,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)
    prog = build_round_program(make_mlp(16, [16], 4), make_krum(**kw), data,
                               attack=make_gaussian_attack(N, 0.25, noise_std=10.0, seed=SEED),
                               init_params=init, pipeline=True, device="cpu", **HP)
    assert prog.pipelined and set(prog.init_agg_state) == set(jprog.init_agg_state)
    step = jax.jit(jprog.train_step)
    j_params = jax.tree_util.tree_map(jnp.asarray, init)
    j_state = jprog.init_agg_state
    t_flat, t_state = prog.init_flat, prog.init_agg_state
    adj = jax_topology("k-regular", N, k=4).mask().astype(np.float32)
    comp = jattack.compromised.astype(np.float32)
    d = {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()}
    for r in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), r)
        j_params, j_state, j_m = step(j_params, j_state, key, jnp.asarray(adj),
                                      jnp.asarray(comp), jnp.asarray(float(r), jnp.float32), d)
        # The JAX round's draws (its core/rounds.py key splits).
        train_key, attack_key = jax.random.split(key)
        perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
        u = np.array(jax.random.uniform(perm_key, data.mask.shape))
        noise = np.array(jax.random.normal(attack_key, (int(comp.sum()), prog.model_dim)))
        t_flat, t_state, t_m = prog.train_step(
            t_flat, t_state, torch.from_numpy(adj), torch.from_numpy(comp), float(r),
            draws={"u": [u], "noise": noise})
        j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
        assert _scaled_delta(t_flat.numpy(), j_flat) <= 1e-4, r
        for k in (P.OWN_KEY, P.BCAST_KEY):
            assert _scaled_delta(t_state[k].numpy(), j_state[k]) <= 1e-4, (r, k)
        assert np.array_equal(t_state[P.ADJ_KEY].numpy(), np.asarray(j_state[P.ADJ_KEY]))
        assert float(t_m["agg_pipe_valid"]) == float(j_m["agg_pipe_valid"]) == min(r, 1)
        assert np.array_equal(t_m["agg_selected_index"].numpy(),
                              np.asarray(j_m["agg_selected_index"])), r
    # Round 2 aggregated a real buffer: some node took another's model.
    assert not bool(t_m["agg_selected_own"].all())


# ---------------------------------------------------------------------------
# chunk boundaries and telemetry


def test_fused_equals_per_round_dispatch():
    per_round = _pipelined({"faults": FAULTS})
    h1 = per_round.train(8, eval_every=3)
    fused = _pipelined({"faults": FAULTS})
    h2 = fused.train(8, eval_every=3, rounds_per_dispatch=4)
    assert h1 == h2 and torch.equal(per_round.flat, fused.flat)
    for k, v in per_round.agg_state.items():
        assert torch.equal(v, fused.agg_state[k]), k
    split = _pipelined({"faults": FAULTS})
    split.train(3, eval_every=3, rounds_per_dispatch=2)
    split.train(5, eval_every=3, rounds_per_dispatch=2)
    assert split.history == h1 and torch.equal(split.flat, per_round.flat)


@pytest.mark.parametrize("pipeline", [False, True])
def test_phase_times_overlap_marker_only_when_pipelined(tmp_path, pipeline):
    run_dir = tmp_path / "run"
    over = {"telemetry": {"enabled": True, "dir": str(run_dir)}}
    net = _pipelined(over) if pipeline else _net(**over)
    net.train(2)
    net.train(2, rounds_per_dispatch=2)
    net.telemetry.close()
    phases = events_of_type(run_dir, "phase_times")
    assert len(phases) == 4
    if pipeline:
        assert all(e["overlap"] == "pipelined" for e in phases)
        assert build_report(run_dir)["time"]["critical_path"]["rounds"] == 4
    else:
        assert not any("overlap" in e for e in phases)
        assert "critical_path" not in build_report(run_dir)["time"]


# The port's serialized histories before its round was split into
# production and aggregation (3 rounds of each case).
SERIALIZED_PIN = {
    "plain_krum": {
        "mean_accuracy": [0.328125, 0.5625, 0.671875],
        "mean_loss": [1.3320356607437134, 1.1450536251068115, 1.0687077045440674],
        "agg_selected_index": [3.625, 1.75, 4.125],
        "agg_krum_score": [10.875841498374939, 7.610021710395813, 3.6355560198426247],
        "agg_selected_own": [0.0, 0.125, 0.125]},
    "faulted_fedavg": {
        "mean_accuracy": [0.59375, 0.78125, 0.78125],
        "mean_loss": [1.2256808280944824, 1.1300151348114014, 1.0379090309143066],
        "agg_num_neighbors": [1.625, 1.625, 2.125], "agg_alive": [8.0, 8.0, 8.0]},
    "int8_median_attack": {
        "mean_accuracy": [0.328125, 0.5, 0.828125],
        "mean_loss": [1.364364743232727, 1.2255265712738037, 1.0239083766937256],
        "agg_num_candidates": [5.0, 5.0, 5.0],
        "agg_compress_error": [0.13862639339640737, 0.137165168649517, 0.1323026284808293]},
    "stale_composition": {
        "mean_accuracy": [0.484375, 0.484375, 0.546875],
        "mean_loss": [1.2000709772109985, 1.2079209089279175, 1.1108624935150146],
        "agg_selected_index": [3.125, 3.0, 3.625],
        "agg_krum_score": [4.130966156721115, 3.6782026551663876, 2.821639242582023],
        "agg_stale_used": [0.0, 8.0, 8.0], "agg_stale_expired": [16.0, 8.0, 4.0]},
}
# Counts and decisions: equal; float statistics: within rtol 1e-6.
EXACT = {"mean_accuracy", "agg_selected_index", "agg_selected_own", "agg_num_neighbors",
         "agg_alive", "agg_num_candidates", "agg_stale_used", "agg_stale_expired"}


@pytest.mark.parametrize("case", sorted(SERIALIZED_PIN))
def test_serialized_histories_unchanged_by_the_split(case):
    history = _net(**PARITY[case]).train(3)
    assert "agg_pipe_valid" not in history
    for k, want in SERIALIZED_PIN[case].items():
        if k in EXACT:
            assert history[k] == want, k
        else:
            assert history[k] == pytest.approx(want, rel=1e-6), k


# ---------------------------------------------------------------------------
# the guards


def test_pipelined_rounds_yaml_runs_with_the_recompile_guard(tmp_path):
    config = load_config(ROOT / "examples" / "configs" / "pipelined_rounds.yaml")
    config.experiment.verbose = False
    config.telemetry.dir = str(tmp_path / "run")
    assert config.tpu.recompile_guard and config.exchange.pipeline
    net = build_network_from_config(config, device="cpu")
    assert net.recompile_guard and net.program.pipelined
    history = net.train(config.experiment.rounds)
    net.telemetry.close()
    assert history["agg_pipe_valid"] == [0.0] + [1.0] * 11
    assert all(np.isfinite(history["mean_loss"]))


def test_recompile_guard_raises_on_a_rebuilt_program():
    net = _pipelined({"tpu": {"recompile_guard": True}})
    net.train(3, rounds_per_dispatch=2)  # keys (2, 1) and the ragged (1, 1): allowed
    net._fused.clear()
    with pytest.raises(net_mod.RecompileError, match="recompile_guard"):
        net.train(2, rounds_per_dispatch=2)
    unguarded = _pipelined({})
    unguarded.train(2)
    unguarded._fused.clear()
    unguarded.train(2)


FAKE_NVCC = """#!{python}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").close()
"""


@pytest.mark.parametrize("guarded", [False, True])
def test_recompile_guard_raises_on_a_kernel_build_after_the_first_chunk(
    tmp_path, monkeypatch, guarded
):
    # A stand-in compiler makes build_all's build real on the CPU: it starts
    # one process per missing source, as nvcc would be started.
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    net = _pipelined({"tpu": {"recompile_guard": guarded}})
    step = net.program.train_step

    def step_that_builds(*args, **kwargs):
        if args[4] == 2.0:  # round 2, inside the second chunk of (1, 1)
            _build.build_all(("agg_distances",))
        return step(*args, **kwargs)

    net.program.train_step = step_that_builds
    net.train(2)
    if guarded:
        with pytest.raises(net_mod.RecompileError, match="agg_distances"):
            net.train(1)
        # The raise left the counter and the history at the chunk's end.
        assert net.current_round == 3 and net.history["round"] == [1, 2, 3]
    else:
        net.train(1)
    assert _build.STARTED[-1] == "agg_distances"


def test_transfer_guard_changes_nothing_on_the_cpu():
    ref = _pipelined({"faults": FAULTS})
    ref.train(4, rounds_per_dispatch=2)
    got = _pipelined({"faults": FAULTS, "tpu": {"transfer_guard": True}})
    assert got.transfer_guard
    got.train(4, rounds_per_dispatch=2)
    assert got.history == ref.history and torch.equal(got.flat, ref.flat)
    assert json.dumps(got.history)  # plain floats
