"""The port's static contracts (murmura_tpu_torch/analysis/contracts.py and
the static halves of adaptive.py, staleness.py, pipeline.py and
composition.py), on the CPU, against the JAX package where both name the
same things.

- (c) The registries and the schema literals name the JAX package's sets:
  AGGREGATORS, ATTACKS, TOPOLOGY_TYPES, the sparse families, the samplers.
- (d) On ``_TOPOLOGY_CASES`` the port's generators give JAX's adjacency
  bit for bit (and the sparse families its offsets).
- (e) The discovered ``*_STATE_KEYS`` groups and their keys are JAX's.
- (f) The refusal census is JAX's ``refusal_reason`` over every lever
  pair: the same outright refusals and messages, the same compatible
  pairs, the constrained refusals JAX's less its int8_block row (the port
  refuses that block in its round program, in the JAX round program's
  words: tests/test_torch_sharding.py).
- The static contracts hold on the tree, and each rule fires on a planted
  defect: a registry name missing from the schema (MUR101, MUR102), a
  self-loop generator (MUR103), a fault mask adding edges (MUR301), bad
  sparse offsets (MUR602), a missing migration note (MUR401), a snapshot
  that drops a key or an unregistered group (MUR900), an import failure
  (MUR100, MUR300), an attack whose state escapes the reservation
  (MUR1000), an initialiser dropping a stale key (MUR1100), a pipeline
  keeping its broadcast buffer under staleness (MUR1200), a doctored guard
  source, a bad table row, a census entry whose guard never fires
  (MUR1400), and overlapping state groups (MUR1402).
"""

import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.attacks import ATTACKS as JAX_ATTACKS
from murmura_tpu.config import schema as jax_schema
from murmura_tpu.durability import snapshot as jax_snapshot
from murmura_tpu.levers import compatible_pairs as jax_compatible_pairs
from murmura_tpu.levers import declared_refusals as jax_declared_refusals
from murmura_tpu.levers import refusal_reason as jax_refusal_reason
from murmura_tpu.population.sampler import SAMPLERS as JAX_SAMPLERS
from murmura_tpu.topology import generators as jax_generators
from murmura_tpu_torch import levers
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.analysis import adaptive as A
from murmura_tpu_torch.analysis import composition as C
from murmura_tpu_torch.analysis import contracts as K
from murmura_tpu_torch.analysis import pipeline as P
from murmura_tpu_torch.analysis import staleness as S
from murmura_tpu_torch.attacks import ATTACKS
from murmura_tpu_torch.config import schema
from murmura_tpu_torch.durability import snapshot
from murmura_tpu_torch.population.sampler import SAMPLERS
from murmura_tpu_torch.topology import generators

ROOT = Path(__file__).resolve().parent.parent


def _rules(findings):
    return sorted({f.rule for f in findings})


# -- parity with the JAX package ---------------------------------------------


@pytest.mark.parametrize("kind,ours,theirs", [
    ("aggregators", set(AGGREGATORS), set(JAX_AGGREGATORS)),
    ("attacks", set(ATTACKS), set(JAX_ATTACKS)),
    ("topologies", set(generators.TOPOLOGY_TYPES), set(jax_generators.TOPOLOGY_TYPES)),
    ("sparse", set(generators.SPARSE_TOPOLOGY_TYPES),
     set(jax_generators.SPARSE_TOPOLOGY_TYPES)),
    ("samplers", set(SAMPLERS), set(JAX_SAMPLERS)),
])
def test_registries_name_the_jax_packages_sets(kind, ours, theirs):
    assert ours == theirs


@pytest.mark.parametrize("field,model", [
    ("algorithm", "AggregationConfig"), ("type", "AttackConfig"),
    ("type", "TopologyConfig"), ("sampler", "PopulationConfig"),
])
def test_schema_literals_name_the_jax_packages_sets(field, model):
    assert (K._schema_enum(field, getattr(schema, model))
            == K._schema_enum(field, getattr(jax_schema, model)))


@pytest.mark.parametrize("topo_type", sorted(K._TOPOLOGY_CASES))
def test_generators_give_the_jax_packages_adjacency(topo_type):
    for kwargs in K._TOPOLOGY_CASES[topo_type]:
        ours = generators.create_topology(topo_type, **kwargs)
        theirs = jax_generators.create_topology(topo_type, **kwargs)
        assert np.array_equal(np.asarray(ours.adjacency), np.asarray(theirs.adjacency)), kwargs
        assert np.asarray(ours.adjacency).dtype == np.asarray(theirs.adjacency).dtype
        if hasattr(theirs, "offsets"):
            assert list(ours.offsets) == list(theirs.offsets), kwargs


def test_state_key_groups_are_the_jax_packages():
    ours = snapshot.discover_state_key_groups(ROOT / "murmura_tpu_torch")
    theirs = jax_snapshot.discover_state_key_groups(ROOT / "murmura_tpu")
    assert {k: v.replace("murmura_tpu_torch.", "") for k, v in ours.items()} == {
        k: v.replace("murmura_tpu.", "") for k, v in theirs.items()}
    assert (snapshot.resolve_reserved_agg_state_keys()
            == jax_snapshot.resolve_reserved_agg_state_keys())


def test_refusal_census_is_the_jax_packages():
    ours, theirs = levers.declared_refusals(), jax_declared_refusals()
    assert [k for k in theirs if k not in ours] == [("compression", "sharding", "int8_block")]
    assert ours == [k for k in theirs if k in ours]
    for a, b, tag in ours:
        assert levers.refusal_reason(a, b, tag) == jax_refusal_reason(a, b, tag)
    names = sorted(levers.LEVERS)
    outright = {(a, b) for a, b, t in theirs if t is None}
    for i, b in enumerate(names):
        for a in names[:i]:
            if (a, b) in outright:
                assert levers.refusal_reason(a, b) == jax_refusal_reason(a, b)
            else:
                with pytest.raises(KeyError):
                    levers.refusal_reason(a, b)
    assert levers.compatible_pairs() == jax_compatible_pairs()
    assert set(C.REFUSAL_CONFIGS) == set(ours)


# -- the static contracts hold -------------------------------------------------


def test_static_contracts_hold():
    assert K.check_contracts() == []


@pytest.mark.parametrize("fn", [
    A.check_attack_state_registry, S.check_stale_state_registry,
    P.check_pipeline_state_registry, C.check_manifest_bijection, C.check_composed_state,
])
def test_static_family_holds(fn):
    assert fn() == []


def test_refusal_guards_and_census_hold():
    assert C.refusal_guard_findings() == []
    assert C.census_findings(C.REFUSAL_CONFIGS, device="cpu") == []


# -- each rule fires on a planted defect --------------------------------------


def test_mur101_mur102_fire_on_a_name_missing_from_the_schema(monkeypatch):
    name = "planted" + "_rule"  # built here so that no test file names it
    monkeypatch.setitem(AGGREGATORS, name, AGGREGATORS["fedavg"])
    found = K.check_contracts()
    assert _rules(found) == ["MUR101", "MUR102"]
    assert all(name in f.message for f in found)


def test_mur102_scans_only_the_ports_tests(tmp_path):
    (tmp_path / "test_jax_side.py").write_text('"krum"\n')
    (tmp_path / "test_torch_side.py").write_text('"fedavg"\n')
    src = K.port_tests_source(tmp_path)
    assert '"fedavg"' in src and '"krum"' not in src


def _fake_generators(adjacency, offsets=None, sparse=()):
    topo = types.SimpleNamespace(adjacency=adjacency, offsets=offsets)
    return types.SimpleNamespace(
        TOPOLOGY_TYPES=("ring",) + tuple(sparse), SPARSE_TOPOLOGY_TYPES=tuple(sparse),
        create_topology=lambda *a, **k: topo)


def test_mur103_fires_on_a_self_loop_generator():
    loop = _fake_generators(np.ones((4, 4), bool))
    found = K.topology_findings(loop, "generators.py", cases={"ring": [{"num_nodes": 4}]})
    assert _rules(found) == ["MUR103"] and "self-edges" in found[0].message
    missing = K.topology_findings(loop, "generators.py", cases={})
    assert "no _TOPOLOGY_CASES entry" in missing[0].message


def test_mur103_holds_on_the_real_generators():
    assert K.topology_findings(generators, "generators.py") == []


def test_mur301_fires_on_a_mask_that_adds_edges():
    class Adding:
        def masked_adjacency(self, adj, r):
            return np.asarray(adj, np.float32) + np.eye(len(adj), dtype=np.float32)

    ring = generators.create_topology("ring", num_nodes=6).mask()
    found = K.fault_mask_findings(Adding(), [("ring", ring)], "schedule.py")
    assert _rules(found) == ["MUR301"] and len(found) == 6


def test_mur301_holds_on_the_fault_schedule():
    from murmura_tpu_torch.faults.schedule import FaultSchedule

    sched = FaultSchedule(6, crash_prob=0.35, recovery_prob=0.3, link_drop_prob=0.3, seed=0)
    ring = generators.create_topology("ring", num_nodes=6).mask()
    assert K.fault_mask_findings(sched, [("ring", ring)], "schedule.py") == []


def test_mur602_fires_on_bad_sparse_offsets():
    from murmura_tpu_torch.topology.sparse import SparseTopology

    topo = SparseTopology.__new__(SparseTopology)
    object.__setattr__(topo, "offsets", (0, 1, 1))
    fake = types.SimpleNamespace(TOPOLOGY_TYPES=("ring",), SPARSE_TOPOLOGY_TYPES=("bad",),
                                 create_topology=lambda *a, **k: topo)
    found = K.sparse_population_findings(fake, schema, "schema.py", "generators.py")
    assert _rules(found) == ["MUR602"]
    assert any("not in TOPOLOGY_TYPES" in f.message for f in found)
    assert any("invalid offsets" in f.message for f in found)
    assert K.sparse_population_findings(generators, schema, "schema.py", "generators.py") == []


def test_mur401_fires_without_the_migration_note():
    assert _rules(K.migration_note_findings(3, "### v2\n", "schema.py")) == ["MUR401"]
    assert K.migration_note_findings(2, "### v2\n", "schema.py") == []


def test_mur900_fires_on_a_snapshot_that_drops_a_key():
    def dropping(directory, payload):
        missing, corrupted = snapshot.snapshot_roundtrip_missing_sections(directory, {
            **payload, "agg_state": {k: v for k, v in payload["agg_state"].items()
                                     if k != "atk_z"}})
        return missing, corrupted + ["atk_z"]

    found = K.mur900_roundtrip_findings("snapshot.py", roundtrip=dropping)
    assert _rules(found) == ["MUR900"] and "atk_z" in found[0].message
    assert K.mur900_roundtrip_findings("snapshot.py") == []


def test_mur900_fires_on_an_unregistered_group():
    discovered = dict(snapshot.RESERVED_AGG_STATE_KEY_GROUPS, EXTRA_STATE_KEYS="m.x")
    registry = dict(snapshot.RESERVED_AGG_STATE_KEY_GROUPS, STALE_STATE_KEYS="elsewhere",
                    GONE_STATE_KEYS="m.y")
    found = K.mur900_registry_findings(discovered, registry, "snapshot.py")
    assert _rules(found) == ["MUR900"] and len(found) == 3


@pytest.mark.parametrize("module,rule", [
    ("murmura_tpu_torch.attacks", "MUR100"), ("murmura_tpu_torch.faults.schedule", "MUR300"),
])
def test_import_failures_are_findings(monkeypatch, module, rule):
    monkeypatch.setitem(sys.modules, module, None)
    assert rule in _rules(K.check_contracts())


def test_mur1000_fires_on_an_attack_whose_state_escapes():
    from murmura_tpu_torch.attacks.adaptive import (
        ADAPTIVE_ATTACKS,
        ATTACK_STATE_KEYS,
        AdaptiveAttack,
    )

    def stray():
        atk = ADAPTIVE_ATTACKS["adaptive_alie"]()
        return AdaptiveAttack(**{**atk.__dict__, "state_keys": atk.state_keys + ("own_key",),
                                 "strength_stats": None})

    attacks = {**ADAPTIVE_ATTACKS, "stray": stray}
    found = A.attack_state_findings(attacks, tuple(ATTACK_STATE_KEYS), AdaptiveAttack,
                                    snapshot.RESERVED_AGG_STATE_KEY_GROUPS)
    assert _rules(found) == ["MUR1000"]
    text = " ".join(f.message for f in found)
    assert "own_key" in text and "strength_stats" in text
    unregistered = A.attack_state_findings(ADAPTIVE_ATTACKS, tuple(ATTACK_STATE_KEYS),
                                           AdaptiveAttack, {})
    assert "not registered" in unregistered[0].message


def test_mur1100_fires_on_an_initialiser_that_drops_a_key():
    from murmura_tpu_torch.core import stale

    def dropping(spec, n, p, dtype):
        return {"stale_cache": stale.init_stale_state(spec, n, p, dtype)["stale_cache"]}

    found = S.stale_state_findings(tuple(stale.STALE_STATE_KEYS), stale.StalenessSpec,
                                   dropping, snapshot.RESERVED_AGG_STATE_KEY_GROUPS)
    assert _rules(found) == ["MUR1100"] and "init_stale_state keys" in found[0].message


def test_mur1200_fires_on_a_pipeline_keeping_its_buffer_under_staleness():
    from murmura_tpu_torch.core import pipeline

    doctored = types.SimpleNamespace(**{k: getattr(pipeline, k) for k in (
        "PIPELINE_STATE_KEYS", "BCAST_KEY", "ADJ_KEY", "VALID_KEY", "init_pipeline_state")})
    doctored.pipeline_state_keys = lambda stale: pipeline.PIPELINE_STATE_KEYS
    found = P.pipeline_state_findings(doctored, snapshot.RESERVED_AGG_STATE_KEY_GROUPS)
    assert _rules(found) == ["MUR1200"]
    assert any("stale=True" in f.message for f in found)


def test_mur1400_fires_on_doctored_guard_sources():
    schema_src = (ROOT / "murmura_tpu_torch" / "config" / "schema.py").read_text()
    factories_src = (ROOT / "murmura_tpu_torch" / "utils" / "factories.py").read_text()
    bypass = schema_src + '\nMSG = "a does not compose with b"\n'
    found = C.refusal_guard_findings(bypass, factories_src)
    assert _rules(found) == ["MUR1400"] and "refusal-shaped literal" in found[0].message
    undeclared = schema_src + '\nX = refusal_reason("faults", "mobility")\n'
    assert "declares no such refusal" in C.refusal_guard_findings(
        undeclared, factories_src)[0].message
    uncited = factories_src.replace('refusal_reason("sparse", "sweep", "tpu_backend")', '"x"')
    assert "no guard site" in C.refusal_guard_findings(schema_src, uncited)[0].message


def test_mur1400_fires_on_a_bad_table_row_and_a_silent_census_entry():
    from murmura_tpu_torch.durability.snapshot import resolve_reserved_agg_state_keys

    refusals = dict(levers._REFUSALS)
    refusals[("sweep", "adaptive", None)] = "backwards"
    labels = {**C.stage_labels(), "murmura.unordered": [("rounds.py", 1)]}
    found = C.table_findings(refusals, {**levers.LEVER_STATE_GROUPS, "bogus_lever": "X"},
                             set(resolve_reserved_agg_state_keys()), labels)
    assert _rules(found) == ["MUR1400"] and len(found) == 4
    census = copy.deepcopy(C.REFUSAL_CONFIGS)
    census[("adaptive", "dmtt", None)] = {"via": "schema", "arm": ("adaptive",)}
    del census[("dmtt", "sparse", None)]
    found = C.census_findings(census, device="cpu")
    assert _rules(found) == ["MUR1400"]
    text = " ".join(f.message for f in found)
    assert "no guard fired" in text and "no REFUSAL_CONFIGS census entry" in text


def test_mur1402_fires_on_overlapping_state_groups():
    found = C.disjoint_group_findings({"A_STATE_KEYS": ("x", "y"), "B_STATE_KEYS": ("y",)})
    assert _rules(found) == ["MUR1402"] and "'y'" in found[0].message
