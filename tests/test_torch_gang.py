"""Gang-batched seed sweeps of the PyTorch port (core/gang.py,
``build_gang_from_config``, the CLI's ``sweep`` and ``run --seeds``).

- Each member's history and final parameters are bit-equal to the port's
  single run with that seed (``attack.params.seed`` pinned, so the
  placement is shared): ``sweep_seeds.yaml`` as committed (fused 5-round
  chunks, cut to 5 rounds), the tiny FEMNIST CNN, the evidential wearable
  MLP with dropout (each member's masks from its own generators), a
  faulted gang, a sparse (exponential) gang and a pipelined stale one.
  The folded training (S members x N nodes as S*N rows of one vmapped
  gradient) measured bit-equal on this sandbox's CPU in every case, so no
  tolerance is taken.
- Each member against the JAX package's ``GangNetwork`` member on the same
  initial parameters and the same draws (the JAX member's own shuffle keys
  and attack noise fed through the gang's ``draws`` seam),
  ``sweep_seeds.yaml`` over 3 rounds: every round's Krum picks equal, the
  parameters and the history within a scaled 1e-4, the decisions in the
  history equal.
- Fused against per-round dispatch: bit-equal.  An ``lr`` member and an
  ``attack_scale = 0`` member (the JAX package's TestParity cases).
- The member sources and labels are the JAX package's; duplicates and
  ragged members are refused.
- The gang's snapshot: resumed at a chunk boundary bit-equal; a snapshot
  of other members, a single run's, and the JAX package's refused before
  anything is assigned; a gang's refused by a single run.
- The CLI: ``sweep`` writes one history a member keyed by label, each
  equal to ``run`` of that seed; ``run --seeds 2`` equals ``sweep --seeds
  s,s+1``; the refusals (``--seeds`` below 1, with ``--profile``, no sweep
  block, population, a sparse gang on backend: tpu, the distributed
  backend); the JAX package's ``murmura sweep`` writes the same labels and
  keys.  With telemetry, one run dir a member that ``report`` reads.
"""

import copy
import json
import os
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

from murmura_tpu.config.schema import Config as JaxConfig
from murmura_tpu.core.gang import resolve_members as jax_resolve_members
from murmura_tpu.utils.factories import build_gang_from_config as jax_build_gang
from murmura_tpu_torch import cli
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.gang import (
    GangNetwork,
    gang_hp_inputs,
    resolve_members,
)
from murmura_tpu_torch.telemetry.report import build_report
from murmura_tpu_torch.telemetry.writer import events_of_type
from murmura_tpu_torch.utils.factories import (
    ConfigError,
    build_gang_from_config,
    build_network_from_config,
)

ROOT = Path(__file__).resolve().parents[1]
SWEEP = ROOT / "examples" / "configs" / "sweep_seeds.yaml"


def _sweep_raw(rounds=5):
    raw = yaml.safe_load(SWEEP.read_text())
    raw["experiment"]["rounds"] = rounds
    return raw


def _raw(seed=1, **over):
    raw = {
        "experiment": {"name": "gang-test", "seed": seed, "rounds": 4},
        "topology": {"type": "ring", "num_nodes": 6},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2,
                   "params": {"noise_std": 3.0, "seed": 1}},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 120, "input_dim": 10, "num_classes": 3}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 10, "hidden_dims": [16], "num_classes": 3}},
        "backend": "simulation",
    }
    raw.update(over)
    return raw


def _cfg(raw):
    return Config.model_validate(copy.deepcopy(raw))


def _single(raw, seed, rounds, dispatch=1):
    raw = copy.deepcopy(raw)
    raw.pop("sweep", None)
    raw["experiment"]["seed"] = seed
    net = build_network_from_config(_cfg(raw), device="cpu")
    net.train(rounds, rounds_per_dispatch=dispatch)
    return net


CASES = {
    "sweep_seeds": (_sweep_raw(), 5),
    # The LEAF and wearables shards (and their held-out splits) vary in
    # size with the seed, which a gang refuses: these two take the
    # synthetic adapter's equal shards at the models' input widths.
    "cnn": (_raw(topology={"type": "k-regular", "num_nodes": 8, "k": 4},
                 data={"adapter": "synthetic",
                       "params": {"num_samples": 160, "input_shape": [28, 28, 1],
                                  "num_classes": 62}},
                 model={"factory": "leaf.femnist.tiny", "params": {}},
                 sweep={"seeds": [3, 4]}), 1),
    "wearable_dropout": (_raw(topology={"type": "fully", "num_nodes": 6},
                              data={"adapter": "synthetic",
                                    "params": {"num_samples": 120, "input_dim": 561,
                                               "num_classes": 6}},
                              model={"factory": "wearables.uci_har",
                                     "params": {"dropout": 0.3}},
                              aggregation={"algorithm": "evidential_trust", "params": {}},
                              sweep={"seeds": [1, 2]}), 1),
    "faulted": (_raw(faults={"enabled": True, "seed": 9, "crash_prob": 0.2,
                             "recovery_prob": 0.5, "link_drop_prob": 0.1,
                             "nan_inject_nodes": [2]},
                     sweep={"seeds": [1, 2, 3]}), 1),
    "sparse": (_raw(topology={"type": "exponential", "num_nodes": 8},
                    sweep={"seeds": [1, 2]}), 2),
    "pipelined_stale": (_raw(topology={"type": "k-regular", "num_nodes": 6, "k": 4},
                             faults={"enabled": True, "seed": 4, "straggler_prob": 0.3},
                             exchange={"max_staleness": 2, "pipeline": True},
                             sweep={"seeds": [5, 6]}), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_members_are_bit_equal_to_single_runs(case):
    raw, dispatch = CASES[case]
    rounds = raw["experiment"]["rounds"]
    gang = build_gang_from_config(_cfg(raw), device="cpu")
    histories = gang.train(rounds, rounds_per_dispatch=dispatch)
    assert len(histories) == gang.gang_size == len(resolve_members(_cfg(raw)))
    for s, member in enumerate(gang.members):
        single = _single(raw, member.seed, rounds, dispatch)
        assert histories[s] == single.history, member.label
        assert torch.equal(gang.flats[s], single.flat), member.label
        for k, v in single.agg_state.items():
            assert torch.equal(gang.agg_states[s][k], v), (member.label, k)
    if case == "faulted":
        assert "agg_alive" in histories[0] and any(histories[0]["agg_quarantined"])


def test_fused_gang_equals_per_round_gang():
    raw = _raw(sweep={"seeds": [1, 2]})
    a = build_gang_from_config(_cfg(raw), device="cpu")
    b = build_gang_from_config(_cfg(raw), device="cpu")
    assert a.train(4, eval_every=2) == b.train(4, eval_every=2, rounds_per_dispatch=4)
    assert torch.equal(a.flats, b.flats)


def test_lr_override_member_matches_single_run():
    raw = _raw(sweep={"members": [{"seed": 1}, {"seed": 2, "lr": 0.1}]})
    gang = build_gang_from_config(_cfg(raw), device="cpu")
    assert gang_hp_inputs(gang.members) == ("lr",)
    histories = gang.train(3)
    base = _single(raw, 1, 3).history
    hot_raw = copy.deepcopy(raw)
    hot_raw["training"]["lr"] = 0.1
    hot = _single(hot_raw, 2, 3).history
    assert histories[0] == base
    assert histories[1] == hot
    assert base["mean_accuracy"] != hot["mean_accuracy"]


def test_attack_scale_zero_member_tracks_a_zero_noise_run():
    # fedavg lets the perturbation land, so scale 0 against 1 must diverge;
    # the zero member tracks a noise_std 0 single run (its scaled
    # broadcast is own + 0 * (bcast - own), the zero run's own + 0 * noise).
    agg = {"algorithm": "fedavg", "params": {}}
    raw = _raw(sweep={"members": [{"seed": 1}, {"seed": 1, "attack_scale": 0.0}]},
               aggregation=agg)
    gang = build_gang_from_config(_cfg(raw), device="cpu")
    histories = gang.train(3)
    zero_raw = copy.deepcopy(raw)
    zero_raw["attack"]["params"]["noise_std"] = 0.0
    zero = _single(zero_raw, 1, 3).history
    for key, v in zero.items():
        if v:
            np.testing.assert_allclose(histories[1][key], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"history[{key}]")
    assert histories[0]["mean_accuracy"] != histories[1]["mean_accuracy"]


# ---------------------------------------------------------------------------
# against the JAX package's GangNetwork


def _jax_member_draws(seed, r, data_mask, n_comp, model_dim):
    """One JAX gang member's draws of round r (its fold_in(PRNGKey(seed), r)
    split as murmura_tpu/core/rounds.py splits it)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    return {"u": [np.array(jax.random.uniform(perm_key, data_mask.shape))],
            "noise": np.array(jax.random.normal(attack_key, (n_comp, model_dim)))}


def test_members_match_the_jax_gang():
    rounds = 3
    raw = _sweep_raw(rounds)
    raw["tpu"] = {}
    jgang = jax_build_gang(JaxConfig.model_validate(copy.deepcopy(raw)))
    gang = build_gang_from_config(_cfg(raw), device="cpu")
    s_count, n, p = gang.flats.shape
    # One spread initial state for both: every node near node 0's weights
    # with distinct scales, so that no Krum pick sits on a float32 tie.
    rng = np.random.default_rng(0)
    scale = (0.05 * (1.0 + np.arange(n) / n)).astype(np.float32)
    init = np.stack([np.asarray(gang.flats[s][:1]) + scale[:, None]
                     * rng.normal(size=(n, p)).astype(np.float32) for s in range(s_count)])
    unravel = jax.vmap(jax.vmap(ravel_pytree(jax.tree_util.tree_map(
        lambda a: a[0, 0], jgang.params))[1]))
    jgang.params = jax.tree_util.tree_map(
        lambda j, t: jnp.concatenate([t, j[s_count:]]).astype(j.dtype),
        jgang.params, unravel(jnp.asarray(init)))
    gang.flats = torch.from_numpy(init)
    comp = int(gang.compromised.sum())
    masks = [np.asarray(prog.data["mask"]) for prog in gang.programs]
    adj = torch.from_numpy(gang.topology.mask())
    for r in range(rounds):
        jgang.train(rounds=1)
        draws = [_jax_member_draws(m.seed, r, masks[s], comp, p)
                 for s, m in enumerate(gang.members)]
        gang.flats, gang.agg_states, metrics = gang._step(gang.flats, gang.agg_states, adj, r,
                                                          draws=draws)
        ev = gang.program.eval_step(gang.flats.reshape(s_count * n, p), data=gang._data)
        gang._record_all(r + 1, [
            {**{k: v[s * n:(s + 1) * n].numpy() for k, v in ev.items()},
             **{k: v.numpy() for k, v in metrics[s].items()}} for s in range(s_count)],
            verbose=False)
        j_flat = np.asarray(jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))(jgang.params))
        for s in range(s_count):
            scale_ = max(1.0, float(np.abs(j_flat[s]).max()))
            delta = float(np.abs(gang.flats[s].numpy() - j_flat[s]).max()) / scale_
            assert delta <= 1e-4, (r, s, delta)
            assert np.array_equal(gang._last_stats[s]["selected_index"],
                                  jgang._last_stats[s]["selected_index"]), (r, s)
    assert not all(gang._last_stats[s]["selected_own"].all() for s in range(s_count))
    for got, ref in zip(gang.histories, jgang.histories):
        assert set(got) == set(ref)
        for k in ("round", "agg_selected_index", "agg_selected_own"):
            assert got[k] == ref[k], k
        for k, v in ref.items():
            if v:
                d = np.abs(np.asarray(got[k]) - np.asarray(v)).max() / max(
                    1.0, np.abs(np.asarray(v)).max())
                # The dense Krum scores go through the Gram identity, whose
                # float32 cancellation leaves each about 1e-4 relative off
                # in either package: 1e-3, as in tests/test_torch_round.py.
                assert d <= (1e-3 if k == "agg_krum_score" else 1e-4), k


@pytest.mark.parametrize("sweep", [{"seeds": [7, 9]}, {"num_seeds": 3},
                                   {"members": [{"seed": 1}, {"seed": 2, "lr": 0.1},
                                                {"seed": 2, "noise_std": 6.0}]}])
def test_members_and_labels_are_the_jax_packages(sweep):
    raw = _raw(seed=5, sweep=sweep)
    ref = jax_resolve_members(JaxConfig.model_validate(copy.deepcopy(raw)))
    got = resolve_members(_cfg(raw))
    assert [(m.seed, m.lr, m.attack_scale, m.label) for m in got] == \
        [(m.seed, m.lr, m.attack_scale, m.label) for m in ref]
    assert resolve_members(_cfg(raw), seeds=[4, 2])[1].label == "seed_2"


def test_duplicate_and_ragged_members_refused():
    with pytest.raises(ConfigError, match="not distinct"):
        build_gang_from_config(_cfg(_raw(sweep={"members": [{"seed": 1}, {"seed": 1}]})),
                               device="cpu")
    with pytest.raises(ValueError, match="not distinct"):
        resolve_members(_cfg(_raw()), seeds=[3, 3])
    a = build_network_from_config(_cfg(_raw()), device="cpu")
    b_raw = _raw()
    b_raw["model"]["params"]["hidden_dims"] = [8]
    b = build_network_from_config(_cfg(b_raw), device="cpu")
    members = resolve_members(_cfg(_raw()), seeds=[1, 2])
    with pytest.raises(ValueError, match="model_dim"):
        GangNetwork([a.program, b.program], members, a.topology, attack=a.attack)


# ---------------------------------------------------------------------------
# the snapshot


def test_resumed_gang_is_bit_equal(tmp_path):
    raw = _raw(sweep={"seeds": [1, 2]}, compression={"algorithm": "int8", "block": 32,
                                                     "error_feedback": True})
    whole = build_gang_from_config(_cfg(raw), device="cpu")
    whole.train(4, rounds_per_dispatch=2)
    first = build_gang_from_config(_cfg(raw), device="cpu")
    first.train(2, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    resumed = build_gang_from_config(_cfg(raw), device="cpu")
    assert resumed.restore_checkpoint(str(tmp_path)) == 2
    resumed.train(2, rounds_per_dispatch=2)
    assert resumed.histories == whole.histories
    assert torch.equal(resumed.flats, whole.flats)
    for s in range(2):
        for k, v in whole.agg_states[s].items():
            assert torch.equal(resumed.agg_states[s][k], v), k
    assert [c["action"] for c in resumed.checkpoints] == ["restore"]


def test_snapshot_refusals(tmp_path):
    raw = _raw(sweep={"seeds": [1, 2]})
    gang = build_gang_from_config(_cfg(raw), device="cpu")
    gang.train(1, checkpoint_dir=str(tmp_path / "gang"))
    other = build_gang_from_config(_cfg(_raw(sweep={"seeds": [1, 3]})), device="cpu")
    before = other.flats.clone()
    with pytest.raises(ValueError, match="members"):
        other.restore_checkpoint(str(tmp_path / "gang"))
    assert torch.equal(other.flats, before) and other.current_round == 0
    single = build_network_from_config(_cfg(_raw()), device="cpu")
    with pytest.raises(ValueError, match="gang"):
        single.restore_checkpoint(str(tmp_path / "gang"))
    single.train(1, checkpoint_dir=str(tmp_path / "single"))
    with pytest.raises(ValueError, match="single run"):
        other.restore_checkpoint(str(tmp_path / "single"))
    jgang = jax_build_gang(JaxConfig.model_validate(raw))
    jgang.train(rounds=1, checkpoint_dir=str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="JAX package"):
        other.restore_checkpoint(str(tmp_path / "jax"))
    assert torch.equal(other.flats, before)


# ---------------------------------------------------------------------------
# the CLI


def _write(tmp_path, raw, name="cfg.yaml"):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def test_sweep_cli_writes_the_single_runs(tmp_path, capsys):
    raw = _sweep_raw(rounds=3)
    cfg = _write(tmp_path, raw)
    cli.main(["sweep", str(cfg), "--device", "cpu", "-o", str(tmp_path / "sweep.json")])
    out = capsys.readouterr().out
    assert "Sweep results (final round)" in out and "seed_45" in out
    combined = json.loads((tmp_path / "sweep.json").read_text())
    assert list(combined) == ["seed_42", "seed_43", "seed_44", "seed_45"]
    for seed in (42, 45):
        single_raw = copy.deepcopy(raw)
        single_raw.pop("sweep")
        single_raw["experiment"]["seed"] = seed
        path = _write(tmp_path, single_raw, f"single_{seed}.yaml")
        cli.main(["run", str(path), "--device", "cpu", "-o", str(tmp_path / f"{seed}.json")])
        assert combined[f"seed_{seed}"] == json.loads((tmp_path / f"{seed}.json").read_text())
    # run --seeds N: the seeds experiment.seed .. +N-1.
    plain = copy.deepcopy(raw)
    plain.pop("sweep")
    path = _write(tmp_path, plain, "plain.yaml")
    cli.main(["run", str(path), "--device", "cpu", "--seeds", "2",
              "-o", str(tmp_path / "seeds.json")])
    cli.main(["sweep", str(path), "--device", "cpu", "--seeds", "42,43",
              "-o", str(tmp_path / "list.json")])
    by_seeds = json.loads((tmp_path / "seeds.json").read_text())
    assert by_seeds == json.loads((tmp_path / "list.json").read_text())
    assert by_seeds["seed_42"] == combined["seed_42"]


@pytest.mark.parametrize("argv, code, match", [
    (["run", "{plain}", "--seeds", "0"], 2, "--seeds must be >= 1"),
    (["run", "{plain}", "--seeds", "2", "--profile"], 2, "does not combine with --profile"),
    (["sweep", "{plain}"], 2, "no sweep block"),
    (["sweep", "{plain}", "--seeds", "3,3"], 1, "not distinct"),
    (["sweep", "{plain}", "--seeds", "a,b"], 2, "comma-separated"),
    (["sweep", "{sparse_tpu}", "--seeds", "1,2"], 1, "not gang-batchable on backend: tpu"),
    (["run", "{population}", "--seeds", "2"], 1, "population does not compose with sweep"),
    (["run", "{distributed}", "--seeds", "2"], 1, "distributed"),
])
def test_cli_refusals(tmp_path, capsys, argv, code, match):
    plain = _raw()
    paths = {
        "plain": _write(tmp_path, plain, "plain.yaml"),
        "sparse_tpu": _write(tmp_path, _raw(topology={"type": "exponential", "num_nodes": 8},
                                            backend="tpu"), "sparse.yaml"),
        "population": ROOT / "examples" / "configs" / "population_1m.yaml",
        "distributed": _write(tmp_path, _raw(backend="distributed"), "dist.yaml"),
    }
    argv = [a.format(**{k: str(v) for k, v in paths.items()}) for a in argv]
    with pytest.raises(SystemExit) as err:
        cli.main(argv + ["--device", "cpu"])
    assert err.value.code == code
    assert match in capsys.readouterr().err


def test_jax_sweep_cli_writes_the_same_labels_and_keys(tmp_path):
    raw = _sweep_raw(rounds=2)
    cfg = _write(tmp_path, raw)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    outs = {}
    for module in ("murmura_tpu", "murmura_tpu_torch"):
        out = tmp_path / f"{module}.json"
        extra = ["--device", "cpu"]
        proc = subprocess.run([sys.executable, "-m", module, "sweep", str(cfg), "-o", str(out),
                               *extra], cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        outs[module] = json.loads(out.read_text())
    ref, got = outs["murmura_tpu"], outs["murmura_tpu_torch"]
    assert list(got) == list(ref)
    for label in ref:
        assert set(got[label]) == set(ref[label])
        assert got[label]["round"] == ref[label]["round"] == [1, 2]


def test_gang_telemetry_one_run_dir_a_member(tmp_path):
    raw = _raw(sweep={"seeds": [1, 2]},
               telemetry={"enabled": True, "dir": str(tmp_path / "runs"), "audit_taps": True})
    gang = build_gang_from_config(_cfg(raw), device="cpu")
    gang.train(3, rounds_per_dispatch=3)
    for t in gang.telemetry:
        t.close()
    for s, member in enumerate(gang.members):
        run_dir = tmp_path / "runs" / member.label
        phases = events_of_type(run_dir, "phase_times")
        assert [e["round"] for e in phases] == [0, 1, 2]
        assert all(e["gang"] == 2 and e["mode"] == "gang_fused" for e in phases)
        rounds = events_of_type(run_dir, "round")
        assert [e["round"] for e in rounds] == [1, 2, 3]
        assert rounds[0]["in_degree"] == [2.0] * 6
        report = build_report(run_dir)
        assert report["manifest"]["history"] == gang.histories[s]
    stats = gang.get_node_statistics(1)
    assert set(stats) == set(range(6)) and "selected_index" in stats[0]
