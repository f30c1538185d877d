"""The gang under mobility and DMTT (core/gang.py, ``build_gang_from_config``,
``run --seeds``) of the PyTorch port, on the CPU.

``dmtt_mobility.yaml`` shrunk to 8 nodes, 3 rounds and 960 samples, with
``training.max_samples`` pinned (24): its dirichlet shards differ in size
between seeds, which a gang refuses in both packages (held below on the
config as committed), and ``attack.params.seed`` pinned to the base seed
(the gang's one placement).

- Each member of a gang of 3 seeds is bit-equal to ``run`` of its seed:
  history, parameters and every carried-state key, the DMTT trust state
  among them; per round and fused.  One mobility model serves the gang:
  every round's staged graph is G^t.
- Against the JAX package's ``GangNetwork`` member (a gang of 2) on the
  same spread initial parameters and the same draws (each JAX member's own shuffle
  keys and attack noise through the gang's ``draws`` seam), three rounds:
  the TopB collaborator masks, ``dmtt_selected`` and the per-node
  collaborator and received counts equal, ``dmtt_c_hat``, ``dmtt_alpha``,
  ``dmtt_beta`` and the mean topology trust within rtol 1e-6 (PERF.md
  section 2's DMTT tolerance against JAX), the parameters within a scaled
  1e-4.
- The gang snapshot carries each member's DMTT keys: a gang resumed at a
  round boundary is bit-equal to the uninterrupted one.
- The CLI: ``run --seeds 3`` writes one history a member, each equal to
  ``run`` of that seed; ``sweep`` the same; the config as committed is
  refused with the message of the JAX package's member check ("data arrays
  differ"; its ``murmura run dmtt_mobility.yaml --seeds 3`` stops there
  too).
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.flatten_util import ravel_pytree

from murmura_tpu.config.schema import Config as JaxConfig
from murmura_tpu.utils.factories import build_gang_from_config as jax_build_gang
from murmura_tpu_torch import cli
from murmura_tpu_torch.attacks.base import select_compromised
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.network import effective_adjacency
from murmura_tpu_torch.core.rounds import DMTT_STATE_KEYS
from murmura_tpu_torch.utils.factories import (
    ConfigError,
    build_gang_from_config,
    build_network_from_config,
)

ROOT = Path(__file__).resolve().parents[1]
DMTT_MOBILITY = ROOT / "examples" / "configs" / "dmtt_mobility.yaml"
SEEDS = [42, 43, 44]


def _raw(rounds=3):
    raw = yaml.safe_load(DMTT_MOBILITY.read_text())
    raw["experiment"].update(rounds=rounds, verbose=False)
    raw["topology"]["num_nodes"] = 8
    raw["data"]["params"]["num_samples"] = 960
    raw["training"]["max_samples"] = 24
    raw["attack"]["params"]["seed"] = raw["experiment"]["seed"]
    return raw


def _cfg(raw):
    return Config.model_validate(copy.deepcopy(raw))


def _single(raw, seed, rounds):
    raw = copy.deepcopy(raw)
    raw["experiment"]["seed"] = seed
    net = build_network_from_config(_cfg(raw), device="cpu")
    net.train(rounds)
    return net


@pytest.fixture(scope="module")
def singles():
    """Each member's single run, per round (fused dispatch is bit-equal to
    it on the CPU: tests/test_torch_dmtt.py)."""
    return {seed: _single(_raw(), seed, 3) for seed in SEEDS}


@pytest.mark.parametrize("dispatch", [1, 3])
def test_members_are_bit_equal_to_single_runs(singles, dispatch):
    raw = _raw()
    gang = build_gang_from_config(_cfg(raw), seeds=SEEDS, device="cpu")
    assert gang.mobility is not None and gang._static_adj is None
    assert all(prog.dmtt is not None for prog in gang.programs)
    assert np.array_equal(gang.compromised, select_compromised(8, 0.2, 42).astype(np.float32))
    staged = []
    step = gang._step

    def recording(flats, states, adj, round_idx, alive=None, draws=None):
        staged.append((round_idx, adj.clone()))
        return step(flats, states, adj, round_idx, alive, draws)

    gang._step = recording
    histories = gang.train(3, rounds_per_dispatch=dispatch)
    for r, adj in staged:
        assert np.array_equal(adj.numpy(),
                              effective_adjacency(gang.topology, gang.mobility, None, r))
    for s, member in enumerate(gang.members):
        single = singles[member.seed]
        assert histories[s] == single.history, member.label
        assert torch.equal(gang.flats[s], single.flat), member.label
        assert set(gang.agg_states[s]) == set(single.agg_state) >= set(DMTT_STATE_KEYS)
        for k, v in single.agg_state.items():
            assert torch.equal(gang.agg_states[s][k], v), (member.label, k)
    # Distinct members (their data and models differ), each bit-equal to
    # its own single run above: nothing of one member's round reached
    # another's.
    assert len({tuple(h["mean_accuracy"]) for h in histories}) == len(SEEDS)


def _jax_member_draws(seed, r, data_mask, n_comp, model_dim):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
    train_key, attack_key = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    return {"u": [np.array(jax.random.uniform(perm_key, data_mask.shape))],
            "noise": np.array(jax.random.normal(attack_key, (n_comp, model_dim)))}


def test_members_match_the_jax_gang():
    raw = _raw()
    # Two members: a power of two, so the JAX gang compiles no padding lane.
    jgang = jax_build_gang(JaxConfig.model_validate(copy.deepcopy(raw)), seeds=SEEDS[:2])
    gang = build_gang_from_config(_cfg(raw), seeds=SEEDS[:2], device="cpu")
    s_count, n, p = gang.flats.shape
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
    for r in range(3):
        jgang.train(rounds=1)
        adj = torch.from_numpy(effective_adjacency(gang.topology, gang.mobility, None, r))
        draws = [_jax_member_draws(m.seed, r, masks[s], comp, p)
                 for s, m in enumerate(gang.members)]
        gang.flats, gang.agg_states, metrics = gang._step(gang.flats, gang.agg_states, adj, r,
                                                          draws=draws)
        j_flat = np.asarray(jax.vmap(jax.vmap(lambda t: ravel_pytree(t)[0]))(jgang.params))
        for s in range(s_count):
            ref = j_flat[s]
            delta = float(np.abs(gang.flats[s].numpy() - ref).max()) / max(
                1.0, float(np.abs(ref).max()))
            assert delta <= 1e-4, (r, s, delta)
            got, want = gang.agg_states[s], {k: np.asarray(v[s])
                                             for k, v in jgang.agg_state.items()}
            for k in ("dmtt_collab", "dmtt_selected"):
                assert np.array_equal(got[k].numpy(), want[k]), (r, s, k)
            for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
                np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                           err_msg=f"{k} round {r} member {s}")
            for k in ("agg_dmtt_collab_count", "agg_dmtt_received_count"):
                assert np.array_equal(metrics[s][k].numpy(),
                                      np.asarray(jgang._last_stats[s][k[4:]])), (r, s, k)
            np.testing.assert_allclose(
                metrics[s]["agg_dmtt_mean_topo_trust"].numpy(),
                np.asarray(jgang._last_stats[s]["dmtt_mean_topo_trust"]), rtol=1e-6)


def test_resumed_gang_is_bit_equal(tmp_path):
    raw = _raw(rounds=4)
    whole = build_gang_from_config(_cfg(raw), seeds=SEEDS[:2], device="cpu")
    whole.train(4)
    first = build_gang_from_config(_cfg(raw), seeds=SEEDS[:2], device="cpu")
    first.train(2, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    resumed = build_gang_from_config(_cfg(raw), seeds=SEEDS[:2], device="cpu")
    assert resumed.restore_checkpoint(str(tmp_path)) == 2
    for k in DMTT_STATE_KEYS:
        for s in range(2):
            assert torch.equal(resumed.agg_states[s][k], first.agg_states[s][k]), k
    resumed.train(2)
    assert resumed.histories == whole.histories
    assert torch.equal(resumed.flats, whole.flats)
    for s in range(2):
        for k, v in whole.agg_states[s].items():
            assert torch.equal(resumed.agg_states[s][k], v), k


def test_run_seeds_and_sweep_cli(singles, tmp_path, capsys):
    raw = _raw()
    cfg = tmp_path / "dmtt.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    out = tmp_path / "seeds.json"
    cli.main(["run", str(cfg), "--seeds", "3", "--device", "cpu", "--quiet", "-o", str(out)])
    histories = json.loads(out.read_text())
    assert list(histories) == [f"seed_{s}" for s in SEEDS]
    for seed in SEEDS:
        assert histories[f"seed_{seed}"] == json.loads(json.dumps(singles[seed].history)), seed
    swept = tmp_path / "sweep.json"
    cli.main(["sweep", str(cfg), "--seeds", "42,43,44", "--device", "cpu", "--quiet",
              "-o", str(swept)])
    assert json.loads(swept.read_text()) == histories
    capsys.readouterr()
    # As committed, the dirichlet shards differ between seeds: refused, as
    # the JAX package refuses it.
    with pytest.raises(SystemExit) as e:
        cli.main(["run", str(DMTT_MOBILITY), "--seeds", "3", "--device", "cpu"])
    assert e.value.code == 1
    assert "data arrays differ" in capsys.readouterr().err
    with pytest.raises(ConfigError, match="data arrays differ"):
        build_gang_from_config(Config.model_validate(yaml.safe_load(DMTT_MOBILITY.read_text())),
                               seeds=SEEDS, device="cpu")
