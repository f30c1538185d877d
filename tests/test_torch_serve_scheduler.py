"""The port's grid scheduler (serve/scheduler.py, the CLI's ``grid`` and
``report --grid``) against the JAX package's, on the CPU.

- ``structural_fingerprint`` equals the JAX package's string for
  serve_grid.yaml and for every class config of its grid (the two schemas'
  ``model_dump`` are equal, which the test shows first); ``expand_cells``
  equals the JAX package's.
- The bucket plan of serve_grid.yaml equals the JAX ``plan_grid``'s (which
  traces each class's program on the CPU): the same cells in the same
  buckets in the same order, and the same bucket configs.  Every cell's
  own program, built through the factories from its own config, is
  admissible into its bucket's lanes (the port's analogue of the JAX
  package's MUR1600, which traces that program; the fingerprint key itself
  is equal across a class by construction).
- A grid cell's member history is bit-equal to that cell's single run (the
  cell's class config, its seed and ``attack_scale``).
- With both packages' gang replaced by one scripted function of (rule,
  strength, seed), the two manifests are equal key for key apart from the
  bucket keys (a fingerprint in the port, a skeleton hash in JAX; each
  cell's ``bucket`` is compared as its bucket's index), ``compiles``,
  ``wall_s`` (and each cell's ``bucket_wall_s``), ``skeleton_eqns`` (JAX
  only) and ``mean_round_s``.
- A tiny grid through the port's CLI: 1 compile a bucket, ``report
  --grid`` and ``--json``, ``--plan-only``; serve_grid.yaml's ``run`` is its
  base experiment.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import murmura_tpu.utils.factories as jax_factories
import murmura_tpu_torch.utils.factories as factories
from murmura_tpu.config.schema import Config as JaxConfig
from murmura_tpu.serve import scheduler as JS
from murmura_tpu_torch import cli
from murmura_tpu_torch.config import load_config
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.gang import check_member_compatible, resolve_members
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.serve import scheduler as TS

ROOT = Path(__file__).resolve().parents[1]
SERVE_GRID = ROOT / "examples" / "configs" / "serve_grid.yaml"


def _raw(**grid):
    raw = yaml.safe_load(SERVE_GRID.read_text())
    raw["grid"].update(grid)
    return raw


def _both(raw):
    return JaxConfig.model_validate(copy.deepcopy(raw)), Config.model_validate(raw)


def test_fingerprints_equal_jax():
    jcfg, cfg = _both(_raw())
    # The two schemas dump the same dict, so the hashes can agree.
    assert cfg.model_dump() == jcfg.model_dump()
    assert TS.structural_fingerprint(cfg) == JS.structural_fingerprint(jcfg)
    cells = TS.expand_cells(cfg, cfg.grid)
    for rule, attack, topology in dict.fromkeys(c.class_key for c in cells):
        for members in (None, TS._cell_members(cells[:3], attack)):
            got = TS.class_config(cfg, cfg.grid, rule, attack, topology, members)
            ref = JS.class_config(jcfg, jcfg.grid, rule, attack, topology, members)
            assert got.model_dump() == ref.model_dump(), (rule, members)
            assert TS.structural_fingerprint(got) == JS.structural_fingerprint(ref)


@pytest.mark.parametrize("grid", [
    {},
    {"rules": ["krum", "median"], "attacks": ["gaussian", "none", "alie"],
     "topologies": ["dense", "sparse"], "strengths": [0.0, 2.0], "seeds": None},
])
def test_expand_cells_equal_jax(grid):
    jcfg, cfg = _both(_raw(**grid))
    got, ref = TS.expand_cells(cfg, cfg.grid), JS.expand_cells(jcfg, jcfg.grid)
    assert [(c.cell_id, c.class_key) for c in got] == [(c.cell_id, c.class_key) for c in ref]
    assert [TS._cell_members(got, a) for a in ("none", "gaussian")] == [
        JS._cell_members(ref, a) for a in ("none", "gaussian")]


def test_plan_equals_jax_and_cell_keys_equal_bucket_keys():
    jcfg, cfg = _both(_raw())
    ref, got = JS.plan_grid(jcfg), TS.plan_grid(cfg)
    assert [(b.rule, b.attack, b.topology, [c.cell_id for c in b.cells]) for b in got] == [
        (b.rule, b.attack, b.topology, [c.cell_id for c in b.cells]) for b in ref]
    assert [b.config.model_dump() for b in got] == [b.config.model_dump() for b in ref]
    assert len(got) == 5 and {len(b.cells) for b in got} == {10}
    assert len({b.key for b in got}) == 5
    for b in got:
        assert TS.structural_fingerprint(b.config) == b.key
        # Each cell's own program, built through the factories from its own
        # config, can take its bucket's lanes beside the bucket's first.
        progs = [TS.cell_program(cfg, cfg.grid, c, device="cpu") for c in b.cells]
        check_member_compatible(progs, resolve_members(b.config))


def test_grid_member_is_bit_equal_to_its_single_run():
    raw = _raw(rules=["krum"], strengths=[0.0, 2.0], seeds=[7, 11], rounds=2)
    cfg = Config.model_validate(raw)
    (bucket,) = TS.plan_grid(cfg)
    gang = factories.build_gang_from_config(bucket.config, device="cpu")
    histories = gang.train(rounds=2, eval_every=2, rounds_per_dispatch=2)
    assert gang.batch == 4 and gang.gang_size == 4 and gang.program_builds == 1
    single_cfg = TS.class_config(cfg, cfg.grid, "krum", "gaussian", "dense")
    topology = factories.build_topology(single_cfg)
    attack = factories.build_attack(single_cfg)
    for i, cell in enumerate(bucket.cells):
        if cell.strength == 0.0 and cell.seed == 7:
            continue  # the 2.0 cells and the other seed carry the check
        program, _ = factories.build_program(single_cfg, topology, attack, cell.seed,
                                             torch.device("cpu"), attack_scale=cell.strength)
        net = Network(program, topology, attack=attack, seed=cell.seed)
        net.train(2, eval_every=2, rounds_per_dispatch=2)
        assert histories[i] == net.history, cell.cell_id
        assert torch.equal(gang.flats[i], net.flat), cell.cell_id
    assert histories[1] != histories[3]  # strength 0 against 2 at seed 11


class _ScriptedGang:
    """A stand-in gang whose accuracy is a fixed function of each member's
    (rule, attack scale, seed): what run_grid reads of a gang."""

    program_builds = 1
    device = torch.device("cpu")

    def __init__(self, cfg, **_):
        self.rule = cfg.aggregation.algorithm
        self.members = [(m.attack_scale, m.seed) for m in cfg.sweep.members]
        self.gang_size = len(self.members)
        self.batch = 1 << (self.gang_size - 1).bit_length()
        self.round_times = [0.01, 0.02]

    def train(self, rounds, eval_every, rounds_per_dispatch):
        assert eval_every == rounds_per_dispatch == rounds
        cliff = {"fedavg": 0.3, "krum": 5.0, "median": 1.2}[self.rule]
        out = []
        for g, seed in self.members:
            g = g or 0.0
            acc = 0.8 - 0.01 * (seed % 3) if g < cliff else 0.25
            out.append({"mean_accuracy": [0.1, acc], "honest_accuracy": [0.1, acc + 0.05]})
        return out


def test_scripted_manifest_equals_jax(monkeypatch):
    raw = _raw(rules=["fedavg", "krum", "median"], attacks=["gaussian", "none"],
               strengths=[0.0, 1.0, 8.0], rounds=2)
    monkeypatch.setattr(jax_factories, "build_gang_from_config", _ScriptedGang)
    monkeypatch.setattr(factories, "build_gang_from_config", _ScriptedGang)
    jcfg, cfg = _both(raw)
    ref, got = JS.run_grid(jcfg), TS.run_grid(cfg, device="cpu")

    def canonical(art):
        art = copy.deepcopy(art)
        index = {b["key"]: i for i, b in enumerate(art["buckets"])}
        for b in art["buckets"]:
            for k in ("key", "compiles", "wall_s", "skeleton_eqns"):
                b.pop(k, None)
        for c in art["cells"]:
            c["bucket"] = index[c["bucket"]]
            for k in ("bucket_wall_s", "mean_round_s"):
                c["phase_times"].pop(k)
        art.pop("total_compiles")
        return json.dumps(art, sort_keys=True)

    assert canonical(got) == canonical(ref)
    assert got["total_cells"] == 24 and len(got["buckets"]) == 6
    assert got["total_compiles"] == 6 and {b["compiles"] for b in got["buckets"]} == {1}
    assert {c["honest_accuracy"] < 0.5 for c in got["cells"]} == {True, False}


@pytest.mark.parametrize("grid, match", [
    ({"rules": ["krum", "nope"]}, "unregistered aggregation rule"),
])
def test_refusals_are_the_jax_packages(grid, match):
    jcfg, cfg = _both(_raw(**grid))
    with pytest.raises(ValueError, match=match) as ref:
        JS.plan_grid(jcfg)
    with pytest.raises(factories.ConfigError, match=match) as got:
        TS.plan_grid(cfg)
    assert str(got.value) == str(ref.value)


def test_manifest_roundtrip_and_junk_refused(tmp_path):
    art = {"schema_version": TS.GRID_SCHEMA_VERSION, "experiment": "x", "grid": {},
           "buckets": [], "cells": [], "total_cells": 0, "total_compiles": 0}
    path = TS.write_grid(art, tmp_path / "grid.json")
    assert TS.load_grid(path) == art == JS.load_grid(path)
    junk = tmp_path / "junk.json"
    junk.write_text(json.dumps({"hello": 1}))
    with pytest.raises(ValueError, match="not a grid manifest"):
        TS.load_grid(junk)


def test_tiny_grid_through_the_cli(tmp_path, capsys):
    raw = _raw(rules=["krum", "median"], strengths=[0.0, 4.0], seeds=[7], rounds=2)
    cfg = tmp_path / "tiny_grid.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    cli.main(["grid", str(cfg), "--device", "cpu", "--plan-only"])
    assert "4 cells in 2 buckets" in capsys.readouterr().out
    out = tmp_path / "grid.json"
    cli.main(["grid", str(cfg), "-o", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "(4 cells, 2 compiles)" in printed and "krum/gaussian/dense/g4/s7" in printed
    art = TS.load_grid(out)
    assert [(b["rule"], b["gang_size"], b["batch"], b["compiles"]) for b in art["buckets"]] == [
        ("krum", 2, 2, 1), ("median", 2, 2, 1)]
    assert all(np.isfinite(c["final_accuracy"]) for c in art["cells"])
    cli.main(["report", "--grid", str(out), "--json"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["total_compiles"] == 2 and summary["buckets"] == art["buckets"]
    with pytest.raises(SystemExit) as exit_:
        cli.main(["report", "--grid", str(cfg)])  # not a manifest
    assert exit_.value.code == 1


def test_serve_grid_run_is_its_base_experiment():
    config = load_config(SERVE_GRID)
    network = factories.build_network_from_config(config, device="cpu")
    history = network.train(rounds=2)
    assert network.program.num_nodes == 12 and history["round"] == [1, 2]
    assert all(np.isfinite(history["honest_accuracy"]))
