"""Cohort streaming of the PyTorch port (murmura_tpu_torch/population/)
against the JAX package's, on the CPU.

- the samplers (``uniform``, ``stratified``) bit-equal to the JAX
  package's for 50 draws each: the same numpy code, ``SeedSequence([seed,
  draw])``;
- the bank bit-equal to the JAX package's under the same gathers and
  scatters, in RAM and memory-mapped; a bank file of another size is
  refused before anything is truncated, one of the right size reattached;
- a ``PopulationNetwork`` (8 nodes on the exponential graph, Krum c = 0,
  the 16-16-4 MLP, users bound to their shards) against the JAX package's
  from the same spread initial rows and on the JAX rounds' own draws (the
  shuffle keys through the round's ``draws`` seam), 6 rounds: at
  ``virtual_size`` 64 (uniform, so that consecutive cohorts overlap and
  the freshness patch runs, asserted) and 1,000,000 (stratified, a
  memory-mapped bank).  The cohorts and Krum's picks equal, the bank's
  activation equal, its rows and the history within a scaled 1e-4 (the
  tolerance of tests/test_torch_sparse.py's chained rounds);
- a run resumed at each swap boundary bit-equal to the uninterrupted run
  (history, ``flat``, the bank) in both bank modes (``embedded`` and
  ``external``), and a ``run`` subprocess SIGKILLed after a snapshot and
  started again bit-equal (history and final snapshot);
- the engine's options: ``inherit`` (teleport, slot_init),
  ``data_binding: slot``, ``rounds_per_cohort``, ``rounds_per_dispatch``
  (warned, run per round), a bfloat16 resident state (the bank's float32
  round trip exact), the ``cohort`` telemetry events, and
  ``population_1m.yaml`` as committed through the factories (the circulant
  kernel's plain version twice a round on the CPU).
"""

import dataclasses
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
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.population import PopulationBank as JaxBank
from murmura_tpu.population import PopulationNetwork as JaxPopulationNetwork
from murmura_tpu.population import PopulationSpec as JaxSpec
from murmura_tpu.population import sampler as JS
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops import agg_kernels
from murmura_tpu_torch.population import PopulationBank, PopulationNetwork, PopulationSpec
from murmura_tpu_torch.population import sampler as TS
from murmura_tpu_torch.telemetry.writer import events_of_type
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils.checkpoint import restore_checkpoint
from murmura_tpu_torch.utils.factories import ConfigError, build_network_from_config

ROOT = Path(__file__).resolve().parents[1]
N = 8
OFFSETS = (1, 2, 4)
HP = dict(local_epochs=1, batch_size=16, lr=0.05, seed=3)
DATA = {"num_samples": 320, "input_dim": 16, "num_classes": 4}


def _scaled_delta(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# population/sampler.py and population/bank.py


@pytest.mark.parametrize("sampler", ["uniform", "stratified"])
@pytest.mark.parametrize("virtual_size, cohort", [(8, 8), (64, 8), (1000, 17),
                                                  (1_000_000, 256)])
def test_samplers_bit_equal_to_jax(sampler, virtual_size, cohort):
    for draw in range(50):
        got = TS.draw_cohort(sampler, virtual_size, cohort, draw, 1234)
        ref = JS.draw_cohort(sampler, virtual_size, cohort, draw, 1234)
        assert got.dtype == ref.dtype == np.int64
        assert np.array_equal(got, ref), draw


def test_sampler_refusals_match_jax():
    for args in (("zipf", 10, 2, 0, 1), ("uniform", 4, 5, 0, 1), ("uniform", 4, 0, 0, 1)):
        with pytest.raises(ValueError) as ref:
            JS.draw_cohort(*args)
        with pytest.raises(ValueError) as got:
            TS.draw_cohort(*args)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("memmap", [False, True])
def test_bank_bit_equal_to_jax_under_gather_and_scatter(tmp_path, memmap):
    users, dim = (1_000_000, 64) if memmap else (500, 33)
    dirs = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")} if memmap else {}
    ref = JaxBank(users, dim, directory=dirs.get("jax"))
    got = PopulationBank(users, dim, directory=dirs.get("torch"))
    assert (got.path is None) == (ref.path is None) == (not memmap)
    rng = np.random.default_rng(1)
    defaults = rng.normal(size=(12, dim)).astype(np.float32)
    for _ in range(20):
        ids = rng.choice(users, size=12, replace=False)
        a, b = got.gather(ids, defaults), ref.gather(ids, defaults)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(got.has_rows(ids), ref.has_rows(ids))
        rows = (a + rng.normal(size=a.shape)).astype(np.float32)
        got.scatter(ids, rows)
        ref.scatter(ids, rows)
    assert got.activated == ref.activated
    assert np.array_equal(got.activated_users, ref.activated_users)
    assert np.array_equal(got.rows_of(got.activated_users), ref.rows_of(ref.activated_users))
    with pytest.raises(IndexError, match="out of range"):
        got.gather(np.array([users]), defaults[:1])
    got.close()
    ref.close()


def test_bank_refuses_to_truncate_and_reattaches(tmp_path):
    bank = PopulationBank(1_000_000, 80, directory=str(tmp_path))
    bank.scatter(np.array([3, 999_999]), np.full((2, 80), 7.0, np.float32))
    bank.flush()
    size = os.path.getsize(bank.path)
    with pytest.raises(ValueError, match="refusing to truncate"):
        PopulationBank(1_000_000, 81, directory=str(tmp_path))
    assert os.path.getsize(bank.path) == size
    again = PopulationBank(1_000_000, 80, directory=str(tmp_path))
    assert again.reattached and again.activated == 0  # the mask is the snapshot's
    again.restore_activation(bank._has_row)
    assert np.array_equal(again.rows_of(np.array([3, 999_999])), np.full((2, 80), 7.0))
    with pytest.raises(ValueError, match="activation mask shape"):
        again.restore_activation(np.zeros(5, bool))


# ---------------------------------------------------------------------------
# PopulationNetwork against the JAX package's


def _spread(jprog, seed):
    """Every node near node 0's weights at distinct scales, so that no Krum
    pick sits on a float32 tie."""
    rng = np.random.default_rng(seed)
    scale = 0.05 * (1.0 + np.arange(N) / N)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((N,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)


def _jax_u(seed, r, mask_shape):
    """The JAX round's epoch shuffle key (its core/rounds.py key splits)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
    train_key, _ = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    return np.array(jax.random.uniform(perm_key, mask_shape))


def _record_swaps(net, log):
    swap = net._swap_to

    def recorded(draw_idx, round_idx):
        swap(draw_idx, round_idx)
        log.append((draw_idx, np.array(net.cohort)))

    net._swap_to = recorded


def _pair(virtual_size, sampler, rounds_per_cohort=1, inherit="teleport"):
    kw = {"num_compromised": 0, "exchange_offsets": list(OFFSETS), "sparse_exchange": True}
    data = jax_data("synthetic", DATA, num_nodes=N, seed=3)
    jprog = jax_build_round(jax_mlp(16, [16], 4), jax_make_krum(**kw), data,
                            sparse_offsets=OFFSETS, **HP)
    init = _spread(jprog, 3)
    jprog = dataclasses.replace(jprog, init_params=init)
    spec = dict(virtual_size=virtual_size, sampler=sampler, seed=9,
                rounds_per_cohort=rounds_per_cohort, inherit=inherit)
    jnet = JaxPopulationNetwork(jprog, jax_topology("exponential", N), seed=3,
                                population=JaxSpec(**spec))
    prog = build_round_program(make_mlp(16, [16], 4), make_krum(**kw), data, init_params=init,
                               sparse_offsets=OFFSETS, device="cpu", **HP)
    net = PopulationNetwork(prog, create_topology("exponential", N), seed=3,
                            population=PopulationSpec(**spec))
    mask_shape = tuple(prog.data["mask"].shape)
    train_step = prog.train_step

    def with_jax_draws(*args, **kwargs):
        r = int(args[4])
        return train_step(*args, **kwargs, draws={"u": [_jax_u(3, r, mask_shape)]})

    net.program = dataclasses.replace(prog, train_step=with_jax_draws)
    return jnet, net


@pytest.mark.parametrize("virtual_size, sampler", [(64, "uniform"), (1_000_000, "stratified")])
def test_population_network_matches_jax(virtual_size, sampler):
    rounds = 6
    jnet, net = _pair(virtual_size, sampler)
    jlog, log = [], []
    _record_swaps(jnet, jlog)
    _record_swaps(net, log)
    ref = jnet.train(rounds=rounds)
    got = net.train(rounds=rounds)
    assert [d for d, _ in log] == [d for d, _ in jlog] == list(range(rounds))
    for (_, a), (_, b) in zip(log, jlog):
        assert np.array_equal(a, b)
    overlaps = sum(bool(np.intersect1d(a, b).size) for (_, a), (_, b) in zip(log, log[1:]))
    if virtual_size == 64:
        assert overlaps >= 2  # the freshness patch ran
    else:
        assert net.bank.path is not None and jnet.bank.path is not None
    assert set(got) == set(ref)
    for k in ("round", "agg_selected_index", "agg_selected_own"):
        assert got[k] == ref[k], k
    assert not all(v == 1.0 for v in got["agg_selected_own"])  # Krum selects
    for k, v in ref.items():
        assert _scaled_delta(got[k], v) <= 1e-4, k
    assert np.array_equal(net.bank._has_row, jnet.bank._has_row)
    ids = net.bank.activated_users
    assert _scaled_delta(net.bank.rows_of(ids), jnet.bank.rows_of(ids)) <= 1e-4
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(jnet.params))
    assert _scaled_delta(net.flat.numpy(), j_flat) <= 1e-4
    assert net.cohorts_seen == jnet.cohorts_seen == rounds


# ---------------------------------------------------------------------------
# the engine's options


def _raw(**over):
    raw = {
        "experiment": {"name": "pop", "seed": 3, "rounds": 6, "verbose": False},
        "topology": {"type": "exponential", "num_nodes": N},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 0}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic", "params": dict(DATA)},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "hidden_dims": [16], "num_classes": 4}},
        "backend": "simulation",
        "population": {"enabled": True, "virtual_size": 24, "sampler": "uniform",
                       "seed": 9},
    }
    for k, v in over.items():
        raw[k] = {**raw[k], **v} if isinstance(raw.get(k), dict) else v
    return raw


def _net(**over):
    return build_network_from_config(Config.model_validate(_raw(**over)), device="cpu")


def test_slot_binding_keeps_the_programs_data_and_user_binding_rebinds():
    slot = _net(population={"data_binding": "slot"})
    slot.train(2)
    assert slot._data is slot.program.data
    user = _net()
    before = {k: v.clone() for k, v in user.program.data.items()}
    user.train(2)
    # The program's own arrays are never changed; the slots read their
    # users' shards.
    assert all(torch.equal(before[k], v) for k, v in user.program.data.items())
    shard = torch.from_numpy(user.cohort % N)
    assert torch.equal(user._data["x"], user.program.data["x"][shard])
    assert torch.equal(user._data["probe_x"], user.program.data["probe_x"][shard])


@pytest.mark.parametrize("inherit", ["teleport", "slot_init"])
def test_a_swap_resumes_banked_users_and_seeds_fresh_ones(inherit):
    net = _net(population={"inherit": inherit})
    net.train(1)  # the first cohort trained and written back
    outgoing = net.flat.numpy().copy()
    incoming = net._draw(1)
    known = net.bank.has_rows(incoming)[:, None]
    rows = net.bank.gather(incoming, net._slot_init)
    assert known.any() and not known.all()
    net._swap_to(1, 1)
    fresh = outgoing if inherit == "teleport" else net._slot_init
    assert np.array_equal(net.flat.numpy(), np.where(known, rows, fresh))


def test_rounds_per_cohort_swaps_every_k_rounds_and_dispatch_warns():
    net = _net(population={"rounds_per_cohort": 2})
    log = []
    _record_swaps(net, log)
    with pytest.warns(UserWarning, match="dispatches per round"):
        history = net.train(6, rounds_per_dispatch=3)
    assert [d for d, _ in log] == [0, 1, 2] and net.cohorts_seen == 3
    assert history["round"] == list(range(1, 7)) and len(net.swap_times) == 3
    # The final write-back: every drawn user has a row.
    drawn = np.unique(np.concatenate([c for _, c in log]))
    assert np.array_equal(net.bank.activated_users, drawn)


def test_bfloat16_resident_state_round_trips_the_bank_exactly():
    net = _net(backend="tpu", tpu={"param_dtype": "bfloat16"})
    assert net.flat.dtype == torch.bfloat16
    assert np.array_equal(net._slot_init, net.program.init_flat.to(torch.float32).numpy())
    net.train(3)
    rows = net.bank.rows_of(net.cohort)
    assert np.array_equal(rows, net.flat.to(torch.float32).numpy())
    assert torch.equal(torch.from_numpy(rows).to(torch.bfloat16), net.flat)


def test_cohort_events_and_phase_times(tmp_path):
    net = _net(telemetry={"enabled": True, "dir": str(tmp_path / "run")})
    net.train(3)
    net.telemetry.close()
    cohorts = events_of_type(tmp_path / "run", "cohort")
    assert [e["draw"] for e in cohorts] == [0, 1, 2]
    assert [e["swapped_out"] for e in cohorts] == [0, N, N]
    assert cohorts[-1]["virtual_size"] == 24 and cohorts[-1]["activated_users"] > 0
    phases = events_of_type(tmp_path / "run", "phase_times")
    assert [(e["mode"], e["cohort_draw"]) for e in phases] == [("population", r)
                                                               for r in range(3)]
    assert len(events_of_type(tmp_path / "run", "round")) == 3


def test_population_1m_as_committed_runs_through_the_factories():
    config = load_config(ROOT / "examples" / "configs" / "population_1m.yaml")
    config.experiment.rounds = 2
    config.experiment.verbose = False
    net = build_network_from_config(config, device="cpu")
    assert isinstance(net, PopulationNetwork) and net.bank.path is not None
    assert net.program.sparse_offsets == tuple(2 ** i for i in range(8))
    agg_kernels.reset_counts()
    history = net.train(2)
    # Krum's two circulant passes a round, the plain version on the CPU.
    assert agg_kernels.PLAIN_CALLS["circulant_sq_distances"] == 4
    assert history["round"] == [1, 2]
    assert all(np.isfinite(v).all() for v in history.values())
    assert net.bank.activated == 2 * 256
    net.bank.close()


def test_population_refused_with_a_gang_and_by_the_plain_network(tmp_path):
    raw = _raw()
    path = tmp_path / "pop.yaml"
    path.write_text(yaml.safe_dump(raw))
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    with pytest.raises(ConfigError, match="population does not compose with sweep"):
        build_gang_from_config(load_config(path), seeds=[1, 2], device="cpu")
    net = _net()
    net.train(2, checkpoint_dir=str(tmp_path / "ckpt"))
    plain = build_network_from_config(
        Config.model_validate({k: v for k, v in raw.items() if k != "population"}),
        device="cpu")
    with pytest.raises(ValueError, match="population"):
        plain.restore_checkpoint(str(tmp_path / "ckpt"))
    other = _net(population={"seed": 10})
    with pytest.raises(ValueError, match="population snapshot/config mismatch"):
        other.restore_checkpoint(str(tmp_path / "ckpt"))
    assert other.current_round == 0 and other.cohort is None


# ---------------------------------------------------------------------------
# durability


def _same_run(a, b):
    assert a.history == b.history
    assert torch.equal(a.flat, b.flat)
    assert a.current_round == b.current_round
    assert np.array_equal(a.cohort, b.cohort) and a.cohorts_seen == b.cohorts_seen
    assert np.array_equal(a.bank._has_row, b.bank._has_row)
    ids = a.bank.activated_users
    assert np.array_equal(a.bank.rows_of(ids), b.bank.rows_of(ids))


@pytest.mark.parametrize("mode", ["embedded", "external"])
def test_resume_at_each_swap_boundary_is_bit_equal(tmp_path, mode):
    rounds = 6
    over = lambda tag: {"population": {"rounds_per_cohort": 2, **(
        {"bank_dir": str(tmp_path / f"bank_{tag}")} if mode == "external" else {})}}
    ref = _net(**over("ref"))
    ref.train(rounds)
    for stop in (2, 4):
        ckpt = tmp_path / f"stop{stop}"
        first = _net(**over(stop))
        first.train(stop, checkpoint_dir=str(ckpt), checkpoint_every=2)
        del first
        resumed = _net(**over(stop))
        assert resumed.bank.reattached == (mode == "external")
        assert resumed.restore_checkpoint(str(ckpt)) == stop
        resumed.train(rounds - stop, checkpoint_dir=str(ckpt), checkpoint_every=2)
        _same_run(ref, resumed)
    meta = json.loads((tmp_path / "stop4" / "meta.json").read_text())["extra_meta"]
    assert meta["population"]["bank_mode"] == mode


def test_external_bank_of_another_directory_is_refused(tmp_path):
    net = _net(population={"bank_dir": str(tmp_path / "a")})
    net.train(2, checkpoint_dir=str(tmp_path / "ckpt"))
    moved = _net(population={"bank_dir": str(tmp_path / "b")})
    with pytest.raises(ValueError, match="different bank file"):
        moved.restore_checkpoint(str(tmp_path / "ckpt"))
    # The snapshot's own instance restores in place.
    assert net.restore_checkpoint(str(tmp_path / "ckpt")) == 2


def _cli(path, out):
    return subprocess.Popen(
        [sys.executable, "-m", "murmura_tpu_torch", "run", str(path), "--device", "cpu",
         "-o", str(out)],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_sigkill_after_a_snapshot_then_resume_is_bit_equal(tmp_path):
    # 40 rounds of a 24-user population, a snapshot every 2 rounds, the
    # bank embedded in the snapshot (it lives in RAM and dies with the
    # process).
    paths = {}
    for tag in ("ref", "got"):
        raw = _raw(experiment={"rounds": 40},
                   durability={"checkpoint_dir": str(tmp_path / f"ckpt_{tag}"),
                               "checkpoint_every": 2, "resume": True})
        paths[tag] = tmp_path / f"{tag}.yaml"
        paths[tag].write_text(yaml.safe_dump(raw))
    ref = _cli(paths["ref"], tmp_path / "ref.json")
    proc = _cli(paths["got"], tmp_path / "got.json")
    meta = tmp_path / "ckpt_got" / "meta.json"
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            if json.loads(meta.read_text())["round"] >= 4:
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.002)
    killed = proc.poll() is None
    proc.send_signal(signal.SIGKILL)
    proc.communicate(timeout=60)
    assert killed, "the run ended before it could be killed"
    stopped_at = json.loads(meta.read_text())["round"]
    assert 4 <= stopped_at < 40 and not (tmp_path / "got.json").exists()
    resumed = _cli(paths["got"], tmp_path / "got.json")
    out, err = resumed.communicate(timeout=600)
    assert resumed.returncode == 0, err[-3000:]
    assert f"Resumed from round {stopped_at}" in out
    assert "population=24 virtual users / uniform cohorts" in out
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == json.loads((tmp_path / "ref.json").read_text())
    assert got["round"] == list(range(1, 41))
    a, b = restore_checkpoint(tmp_path / "ckpt_got"), restore_checkpoint(tmp_path / "ckpt_ref")
    assert torch.equal(a[0], b[0])
    assert a[6].keys() == b[6].keys() and all(torch.equal(a[6][k], b[6][k]) for k in a[6])
    assert a[7]["population"] == b[7]["population"]
