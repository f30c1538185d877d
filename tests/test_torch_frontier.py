"""The port's robustness frontier (frontier.py, the CLI's ``frontier`` and
``report --frontier``, telemetry/report.render_frontier) against the JAX
package's, on the CPU.

- The pure helpers equal the JAX package's: ``_geom_grid``,
  ``_locate_break``, ``_members_for``, ``declared_influence`` (every rule at
  degrees 4 and 11) and ``AGG_CASES``; ``_cell_config(...).model_dump()``
  for every cell of frontier_krum.yaml and for a ``percentages`` axis.
- A scripted gang: both packages' ``build_gang_from_config`` replaced by a
  fake whose honest accuracy is a fixed function of (strength, seed), so
  that the two ``run_frontier`` artifacts must be equal key for key apart
  from ``compiles`` (the successive halving and the stage grids exactly;
  the real runs cannot show that, since the two frameworks draw different
  random numbers).  The refusals (an unknown rule, a dmtt block,
  backend: distributed) carry the JAX package's messages.
- A tiny real frontier through the port's CLI (krum x gaussian x dense and
  sparse, 2 rounds, 2 points, one seed, 2 stages): ``compiles`` 1 a cell,
  the artifact with the JAX schema's keys, then ``report --frontier`` and
  ``--json``.  The committed frontier.json (the JAX package's artifact) is
  never written: every run takes ``-o`` under the test's tmp_path.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

import murmura_tpu.utils.factories as jax_factories
import murmura_tpu_torch.utils.factories as factories
from murmura_tpu import frontier as JF
from murmura_tpu.analysis.ir import AGG_CASES as JAX_AGG_CASES
from murmura_tpu.attacks.base import select_compromised
from murmura_tpu.config.schema import Config as JaxConfig
from murmura_tpu_torch import cli
from murmura_tpu_torch import frontier as TF
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.topology.generators import create_topology

ROOT = Path(__file__).resolve().parents[1]
FRONTIER_KRUM = ROOT / "examples" / "configs" / "frontier_krum.yaml"


def _raw():
    return yaml.safe_load(FRONTIER_KRUM.read_text())


def test_helpers_match_jax():
    assert TF.AGG_CASES == JAX_AGG_CASES
    assert TF.FRONTIER_SCHEMA_VERSION == JF.FRONTIER_SCHEMA_VERSION
    for lo, hi, points in ((0.25, 4.0, 3), (1e-5, 1e-4, 4), (2.0, 2.0, 2), (0.5, 0.1, 5)):
        assert TF._geom_grid(lo, hi, points) == JF._geom_grid(lo, hi, points)
    assert TF._members_for([0.0, 0.5], [7, 11]) == JF._members_for([0.0, 0.5], [7, 11])
    curves = [
        {0.0: {"mean": 0.8}, 0.5: {"mean": 0.7}, 2.0: {"mean": 0.3}, 8.0: {"mean": 0.1}},
        {0.0: {"mean": 0.8}, 0.5: {"mean": 0.2}},
        {0.0: {"mean": 0.8}, 0.5: {"mean": 0.8}, 4.0: {"mean": 0.5}},
        {0.0: {"mean": 0.8}, 1.0: {"mean": 0.1}, 2.0: {"mean": 0.7}},
    ]
    for curve in curves:
        for frac in (0.5, 0.9):
            assert TF._locate_break(curve, 0.8, frac) == JF._locate_break(curve, 0.8, frac)
    for rule in JAX_AGG_CASES:
        for degree in (4, 11):
            assert TF.declared_influence(rule, degree) == JF.declared_influence(rule, degree), rule


@pytest.mark.parametrize("percentage", [None, 0.25])
def test_cell_configs_match_jax(percentage):
    raw = _raw()
    jcfg, cfg = JaxConfig.model_validate(copy.deepcopy(raw)), Config.model_validate(raw)
    members = TF._members_for([0.0, 0.25, 1.0], [7, 11])
    for rule in cfg.frontier.rules:
        for attack in cfg.frontier.attacks:
            for topology in cfg.frontier.topologies:
                got = TF._cell_config(cfg, cfg.frontier, rule, attack, topology, members,
                                      percentage)
                ref = JF._cell_config(jcfg, jcfg.frontier, rule, attack, topology, members,
                                      percentage)
                assert got.model_dump() == ref.model_dump(), (rule, attack, topology)


class _ScriptedGang:
    """A stand-in gang whose honest accuracy is a fixed function of each
    member's (attack scale, seed), with the attack state of a converged
    bisection: what run_cell reads of a gang, and nothing else."""

    program_builds = 1

    def __init__(self, cfg, **_):
        n = cfg.topology.num_nodes
        self.topology = create_topology(cfg.topology.type, n, k=cfg.topology.k)
        self.compromised = select_compromised(n, cfg.attack.percentage,
                                              int(cfg.attack.params["seed"])).astype(np.float32)
        self.members = [(m.attack_scale, m.seed) for m in cfg.sweep.members]
        self.rule = cfg.aggregation.algorithm
        self.sparse = cfg.topology.type == "exponential"
        self.agg_state = {}

    def reset_run(self, members):
        self.members = [(m.attack_scale, m.seed) for m in members]

    def _accuracy(self, g, seed):
        cliff = {"fedavg": 0.3, "krum": 5.0, "median": 1.2, "trimmed_mean": 0.9,
                 "balance": 50.0}[self.rule] * (1.5 if self.sparse else 1.0)
        return 0.8 - 0.01 * (seed % 3) if g < cliff * (1.0 + 0.1 * (seed % 2)) else 0.2

    def train(self, rounds, eval_every, rounds_per_dispatch):
        n = len(self.compromised)
        self.agg_state = {
            "atk_lo": np.array([[g * 0.5 + 0.001 * s] * n for g, s in self.members], np.float32),
            "atk_accept_ema": np.array([[1.0 / (1.0 + g)] * n for g, s in self.members],
                                       np.float32),
        }
        return [{"honest_accuracy": [0.1, self._accuracy(g, s)]} for g, s in self.members]


def test_scripted_frontier_artifact_equals_jax(monkeypatch):
    raw = _raw()
    raw["frontier"]["stages"] = 3
    monkeypatch.setattr(jax_factories, "build_gang_from_config", _ScriptedGang)
    monkeypatch.setattr(factories, "build_gang_from_config", _ScriptedGang)
    ref = JF.run_frontier(JaxConfig.model_validate(copy.deepcopy(raw)))
    got = TF.run_frontier(Config.model_validate(raw), device="cpu")
    for art in (got, ref):
        for cell in art["cells"]:
            cell.pop("compiles")
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert len(got["cells"]) == 20 and any(c["stages"] == 3 for c in got["cells"])
    assert {c["breaking_point"]["first_broken"] is None for c in got["cells"]} == {True, False}


@pytest.mark.parametrize("over, match", [
    ({"frontier": {"rules": ["krum", "nope"]}}, "unregistered aggregation rule"),
    ({"backend": "distributed", "attack": {"enabled": False}}, "backend: simulation or tpu"),
    ({"dmtt": {"allow_static": True}, "attack": {"enabled": False}}, "dmtt"),
])
def test_refusals_are_the_jax_packages(over, match):
    raw = _raw()
    for k, v in over.items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) and k in raw else v
    with pytest.raises(ValueError, match=match) as ref:
        JF.run_frontier(JaxConfig.model_validate(copy.deepcopy(raw)))
    with pytest.raises(factories.ConfigError, match=match) as got:
        TF.run_frontier(Config.model_validate(raw), device="cpu")
    assert str(got.value) == str(ref.value)


def test_tiny_frontier_through_the_cli(tmp_path, capsys):
    raw = _raw()
    raw["frontier"].update(rules=["krum"], attacks=["gaussian"], points=2, seeds=[7],
                           stages=2, rounds=2)
    cfg = tmp_path / "tiny_frontier.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out = tmp_path / "frontier.json"
    cli.main(["frontier", str(cfg), "-o", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "cell krum x gaussian x dense" in printed and "Breaking point" in printed
    art = TF.load_frontier(out)
    # The committed artifact predates the percentage axis, which the JAX
    # package's run_frontier now writes too (the scripted test above).
    ref = json.loads((ROOT / "frontier.json").read_text())
    assert set(art) == set(ref) and set(art["grid"]) == set(ref["grid"]) | {"percentages"}
    assert set(art["cells"][0]) == set(ref["cells"][0]) | {"percentage"}
    assert [(c["topology"], c["degree"], c["compiles"]) for c in art["cells"]] == [
        ("dense", 4, 1), ("sparse", 4, 1)]
    for cell in art["cells"]:
        assert cell["stages"] >= 1 and cell["curve"][0]["strength"] == 0.0
        assert all(np.isfinite(row["mean"]) for row in cell["curve"])
        assert set(cell["curve"][1]["adaptive"]["7"]) == {"atk_accept_ema", "atk_hi", "atk_lo",
                                                          "atk_scale"}
    cli.main(["report", "--frontier", str(out)])
    text = capsys.readouterr().out
    assert "krum x gaussian x sparse — honest accuracy vs strength" in text
    cli.main(["report", "--frontier", str(out), "--json"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["grid"] == art["grid"]
    assert [r["declared_bound"] for r in summary["summary"]] == [1, 1]
    with pytest.raises(SystemExit) as exit_:
        cli.main(["report", "--frontier", str(cfg)])  # not an artifact
    assert exit_.value.code == 1
