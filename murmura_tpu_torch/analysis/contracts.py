# Counterpart of murmura_tpu/analysis/contracts.py.
"""Cross-layer contract checks (MUR100-103, MUR300/301, MUR401, MUR602,
MUR900).

The port's component wiring spans layers that must stay in bijection with
no shared source of truth: the runtime registries (``AGGREGATORS``,
``ATTACKS``, ``TOPOLOGY_TYPES``, the sparse families and the cohort
samplers), the config schema's ``Literal`` enums (what a YAML file may
name) and the port's own tests (``tests/test_torch_*.py``: each name must
appear in at least one).  MUR103 runs every topology generator on small
instances and requires a zero diagonal; MUR301 holds the fault-masked
adjacency to the same and to "only removes edges"; MUR401 requires the
manifest schema version's migration note in docs/OBSERVABILITY.md; MUR900
holds the ``*_STATE_KEYS`` groups in bijection with the snapshot registry
and pushes a payload carrying every reserved key through the snapshot.

The checks import the live modules: an import failure is itself a finding.
"""

import typing
from pathlib import Path
from typing import Iterable, List, Optional, Set

from murmura_tpu_torch.analysis.lint import Finding

# Topology instances MUR103 builds (the JAX package's table): every
# TOPOLOGY_TYPES entry at more than one size, including the generators' edge
# cases (odd-k bump, k >= n, ER isolated-node fixup, exponential dedupe).
_TOPOLOGY_CASES = {
    "ring": [{"num_nodes": 2}, {"num_nodes": 9}],
    "fully": [{"num_nodes": 2}, {"num_nodes": 8}],
    "erdos": [
        {"num_nodes": 8, "p": 0.05, "seed": 7},
        {"num_nodes": 12, "p": 0.9, "seed": 3},
    ],
    "k-regular": [
        {"num_nodes": 10, "k": 3},  # odd k bumped to 4
        {"num_nodes": 4, "k": 6},  # k >= n: fully-connected degeneration
    ],
    "exponential": [{"num_nodes": 2}, {"num_nodes": 9}, {"num_nodes": 12}],
    "one_peer": [{"num_nodes": 5}, {"num_nodes": 8}],
}

_PKG = Path(__file__).resolve().parent.parent


def _literal_values(annotation) -> Set[str]:
    """String values of a (possibly Optional-wrapped) ``Literal`` annotation."""
    values: Set[str] = set()
    for arg in typing.get_args(annotation):
        if isinstance(arg, str):
            values.add(arg)
        elif arg is not type(None):
            values |= _literal_values(arg)
    return values


def _schema_enum(field_name: str, model) -> Set[str]:
    return _literal_values(model.model_fields[field_name].annotation)


def _sync_findings(kind: str, registry_names: Set[str], schema_names: Set[str],
                   registry_path: str, schema_path: str) -> Iterable[Finding]:
    """MUR101: registry and schema enum must name the same components."""
    for name in sorted(registry_names - schema_names):
        yield Finding(
            "MUR101", registry_path, 1,
            f"{kind} '{name}' is in the runtime registry but missing from "
            "the config schema enum (config/schema.py) — it is unreachable "
            "from any config file",
        )
    for name in sorted(schema_names - registry_names):
        yield Finding(
            "MUR101", schema_path, 1,
            f"{kind} '{name}' is in the config schema enum but has no "
            "runtime registry entry — any config naming it fails at build "
            "time",
        )


def _coverage_findings(kind: str, names: Set[str], tests_src: str,
                       registry_path: str) -> Iterable[Finding]:
    """MUR102: every registered name must appear as a string literal in the
    port's tests — the cheapest machine-checkable proxy for 'this component
    has a test pinning it'."""
    if not tests_src:
        return
    for name in sorted(names):
        if f'"{name}"' not in tests_src and f"'{name}'" not in tests_src:
            yield Finding(
                "MUR102", registry_path, 1,
                f"{kind} '{name}' never appears as a string literal in "
                "tests/test_torch_*.py — add a test exercising it by its "
                "registry name",
            )


def _tests_dir() -> Optional[Path]:
    """The repo's tests/ directory, if running from a source checkout."""
    tests = _PKG.parent / "tests"
    return tests if tests.is_dir() else None


def port_tests_source(tests_dir: Optional[Path] = None) -> str:
    """The text of the port's tests (``test_torch_*.py``) only: the JAX
    package's tests would cover every name for free."""
    tests = tests_dir if tests_dir is not None else _tests_dir()
    if tests is None:
        return ""
    return "\n".join(f.read_text() for f in sorted(tests.glob("test_torch_*.py")))


def check_contracts(tests_dir: Optional[Path] = None) -> List[Finding]:
    """Run the static contracts; returns findings (empty = all hold)."""
    import numpy as np

    try:
        from murmura_tpu_torch.aggregation import AGGREGATORS
        from murmura_tpu_torch.attacks import ATTACKS
        from murmura_tpu_torch.config import schema
        from murmura_tpu_torch.topology import generators
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        return [Finding(
            "MUR100", str(_PKG), 1,
            "contract checks could not import the runtime registries "
            f"({type(e).__name__}: {e}) — the package is broken at a level "
            "below the cross-layer contracts",
        )]

    findings: List[Finding] = []
    schema_path = str(_PKG / "config" / "schema.py")
    agg_path = str(_PKG / "aggregation" / "__init__.py")
    atk_path = str(_PKG / "attacks" / "__init__.py")
    topo_path = str(_PKG / "topology" / "generators.py")

    # -- MUR101: registry <-> schema enum bijection -------------------------
    findings += _sync_findings("aggregation rule", set(AGGREGATORS),
                               _schema_enum("algorithm", schema.AggregationConfig),
                               agg_path, schema_path)
    findings += _sync_findings("attack", set(ATTACKS),
                               _schema_enum("type", schema.AttackConfig),
                               atk_path, schema_path)
    findings += _sync_findings("topology", set(generators.TOPOLOGY_TYPES),
                               _schema_enum("type", schema.TopologyConfig),
                               topo_path, schema_path)

    # -- MUR102: per-component test coverage in the port's tests ------------
    tests_src = port_tests_source(tests_dir)
    for kind, names, path in (
        ("aggregation rule", set(AGGREGATORS), agg_path),
        ("attack", set(ATTACKS), atk_path),
        ("topology", set(generators.TOPOLOGY_TYPES), topo_path),
    ):
        findings += _coverage_findings(kind, names, tests_src, path)

    # -- MUR103: every generator emits a zero-diagonal adjacency ------------
    findings += topology_findings(generators, topo_path)
    dyn_path = str(_PKG / "topology" / "dynamic.py")
    try:
        from murmura_tpu_torch.topology.dynamic import MobilityModel
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        findings.append(Finding(
            "MUR100", dyn_path, 1,
            f"topology.dynamic failed to import ({type(e).__name__}: {e}) — "
            "the MobilityModel zero-diagonal contract cannot be checked",
        ))
        return findings
    mob = MobilityModel(num_nodes=6, area_size=50.0, comm_range=60.0, max_speed=5.0, seed=0)
    for r in (0, 3):
        if np.asarray(mob.adjacency_at(r)).diagonal().any():
            findings.append(Finding(
                "MUR103", dyn_path, 1,
                f"MobilityModel.adjacency_at({r}) emitted self-edges — "
                "the dynamic G^t must keep the zero-diagonal invariant",
            ))

    # -- MUR300/301: fault-masked adjacency stays a valid neighbour mask ---
    sched_path = str(_PKG / "faults" / "schedule.py")
    try:
        from murmura_tpu_torch.faults.schedule import FaultSchedule
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        findings.append(Finding(
            "MUR300", sched_path, 1,
            f"faults.schedule failed to import ({type(e).__name__}: {e}) — "
            "the fault-mask contracts cannot be checked",
        ))
        return findings
    sched = FaultSchedule(6, crash_prob=0.35, recovery_prob=0.3, link_drop_prob=0.3,
                          straggler_prob=0.3, seed=0)
    sources = [("mobility G^t", np.asarray(mob.adjacency_at(3), np.float32))]
    try:
        sources.append(("ring topology", generators.create_topology("ring", num_nodes=6).mask()))
    except Exception:  # noqa: BLE001 — already a MUR103 finding above
        pass
    findings += fault_mask_findings(sched, sources, sched_path)

    # -- MUR602: sparse-topology + population-sampler bijections ------------
    findings += sparse_population_findings(generators, schema, schema_path, topo_path)

    # -- MUR401: telemetry schema version carries a migration note ----------
    tel_path = str(_PKG / "telemetry" / "schema.py")
    try:
        from murmura_tpu_torch.telemetry.schema import MANIFEST_SCHEMA_VERSION
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        findings.append(Finding(
            "MUR401", tel_path, 1,
            f"telemetry.schema failed to import ({type(e).__name__}: {e}) "
            "— the manifest schema-version contract cannot be checked",
        ))
        return findings
    obs_doc = _PKG.parent / "docs" / "OBSERVABILITY.md"
    if obs_doc.is_file():  # source checkout only, like the MUR102 scan
        findings += migration_note_findings(MANIFEST_SCHEMA_VERSION, obs_doc.read_text(),
                                            tel_path)

    # -- MUR900: snapshot completeness bijection ----------------------------
    dur_path = str(_PKG / "durability" / "snapshot.py")
    try:
        from murmura_tpu_torch.durability import snapshot as dsnap
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        findings.append(Finding(
            "MUR900", dur_path, 1,
            f"durability.snapshot failed to import ({type(e).__name__}: "
            f"{e}) — the snapshot completeness contract cannot be checked",
        ))
        return findings
    findings += mur900_registry_findings(dsnap.discover_state_key_groups(_PKG),
                                         dsnap.RESERVED_AGG_STATE_KEY_GROUPS, dur_path)
    findings += mur900_roundtrip_findings(dur_path)
    return findings


def topology_findings(generators, topo_path: str, cases=None) -> List[Finding]:
    """MUR103 over ``cases`` (default :data:`_TOPOLOGY_CASES`): every
    registered type has cases, every case builds, no case has a self-edge."""
    import numpy as np

    cases = _TOPOLOGY_CASES if cases is None else cases
    findings: List[Finding] = []
    for topo_type in sorted(set(generators.TOPOLOGY_TYPES) - set(cases)):
        findings.append(Finding(
            "MUR103", topo_path, 1,
            f"topology '{topo_type}' has no _TOPOLOGY_CASES entry "
            "(analysis/contracts.py) — its zero-diagonal invariant is never "
            "executed; add small-instance cases",
        ))
    for topo_type, kwargs_list in cases.items():
        for kwargs in kwargs_list:
            try:
                topo = generators.create_topology(topo_type, **kwargs)
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                findings.append(Finding(
                    "MUR103", topo_path, 1,
                    f"topology generator '{topo_type}' raised on {kwargs}: "
                    f"{type(e).__name__}: {e}",
                ))
                continue
            if np.asarray(topo.adjacency).diagonal().any():
                findings.append(Finding(
                    "MUR103", topo_path, 1,
                    f"topology '{topo_type}' with {kwargs} emitted self-"
                    "edges (non-zero adjacency diagonal) — aggregation "
                    "neighbour masks assume a zero diagonal",
                ))
    return findings


def fault_mask_findings(sched, sources, sched_path: str) -> List[Finding]:
    """MUR301: the fault-masked adjacency over each (label, adjacency)
    source keeps a zero diagonal and never adds edge weight."""
    import numpy as np

    findings: List[Finding] = []
    for label, adj in sources:
        for r in (0, 2, 7):
            masked = np.asarray(sched.masked_adjacency(adj, r))
            if masked.diagonal().any():
                findings.append(Finding(
                    "MUR301", sched_path, 1,
                    f"FaultSchedule.masked_adjacency over the {label} "
                    f"emitted self-edges at round {r} — the fault-masked "
                    "adjacency must keep the zero-diagonal invariant",
                ))
            if (masked > np.asarray(adj, dtype=np.float32)).any():
                findings.append(Finding(
                    "MUR301", sched_path, 1,
                    f"FaultSchedule.masked_adjacency over the {label} "
                    f"ADDED edge weight at round {r} — fault masking may "
                    "only remove edges, never create or amplify them",
                ))
    return findings


def sparse_population_findings(generators, schema, schema_path: str,
                               topo_path: str) -> List[Finding]:
    """MUR602: the sampler registry against the schema enum, the sparse
    families inside TOPOLOGY_TYPES, and each sparse family returning a
    SparseTopology with nonzero, in-range, deduped offsets."""
    sparse_path = str(_PKG / "topology" / "sparse.py")
    sampler_path = str(_PKG / "population" / "sampler.py")
    try:
        from murmura_tpu_torch.population.sampler import SAMPLERS
        from murmura_tpu_torch.topology.sparse import SparseTopology
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        return [Finding(
            "MUR602", sparse_path, 1,
            f"the population/sparse registries failed to import "
            f"({type(e).__name__}: {e}) — the MUR602 bijections cannot "
            "be checked",
        )]
    findings = list(_sync_findings("population sampler", set(SAMPLERS),
                                   _schema_enum("sampler", schema.PopulationConfig),
                                   sampler_path, schema_path))
    for name in sorted(set(generators.SPARSE_TOPOLOGY_TYPES) - set(generators.TOPOLOGY_TYPES)):
        findings.append(Finding(
            "MUR602", topo_path, 1,
            f"sparse topology '{name}' is not in TOPOLOGY_TYPES — the "
            "MUR101/MUR103 contracts never see it",
        ))
    for name in generators.SPARSE_TOPOLOGY_TYPES:
        for nn in (6, 8):
            try:
                topo = generators.create_topology(name, num_nodes=nn)
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                findings.append(Finding(
                    "MUR602", topo_path, 1,
                    f"sparse topology '{name}' raised at num_nodes={nn}: "
                    f"{type(e).__name__}: {e}",
                ))
                continue
            if not isinstance(topo, SparseTopology):
                findings.append(Finding(
                    "MUR602", topo_path, 1,
                    f"sparse topology '{name}' returned a "
                    f"{type(topo).__name__} — sparse families must return "
                    "SparseTopology (the [k, N] edge-mask engine's input "
                    "contract)",
                ))
                continue
            offs = list(topo.offsets)
            if not offs or any(not 0 < o < nn for o in offs) or len(set(offs)) != len(offs):
                findings.append(Finding(
                    "MUR602", sparse_path, 1,
                    f"sparse topology '{name}' at num_nodes={nn} emitted "
                    f"invalid offsets {offs} — offsets must be nonzero mod "
                    "N, in-range, and deduped (self-loops/double-counting "
                    "break every weighted circulant kernel)",
                ))
    return findings


def migration_note_findings(version: int, docs_text: str, tel_path: str) -> List[Finding]:
    """MUR401: the manifest schema version has its '### v<N>' note."""
    if f"### v{version}" in docs_text:
        return []
    return [Finding(
        "MUR401", tel_path, 1,
        f"MANIFEST_SCHEMA_VERSION is {version} but docs/OBSERVABILITY.md "
        f"has no '### v{version}' migration note under 'Schema versions' — "
        "a schema bump must document how existing run directories migrate",
    )]


def mur900_registry_findings(discovered, registry, dur_path: str) -> List[Finding]:
    """MUR900 half (a): the discovered ``*_STATE_KEYS`` assignments and the
    durability registry name the same groups, in the same modules."""
    findings: List[Finding] = []
    for name, module in sorted(discovered.items()):
        reg = registry.get(name)
        if reg is None:
            findings.append(Finding(
                "MUR900", dur_path, 1,
                f"reserved carried-state key group '{name}' ({module}) is "
                "not registered in durability.snapshot."
                "RESERVED_AGG_STATE_KEY_GROUPS — state it reserves would "
                "be invisible to the snapshot completeness contract; "
                "register it",
            ))
        elif reg != module:
            findings.append(Finding(
                "MUR900", dur_path, 1,
                f"carried-state key group '{name}' is registered under "
                f"module '{reg}' but defined in '{module}' — fix the "
                "registry entry",
            ))
    for name in sorted(set(registry) - set(discovered)):
        findings.append(Finding(
            "MUR900", dur_path, 1,
            f"RESERVED_AGG_STATE_KEY_GROUPS entry '{name}' names no "
            "module-level *_STATE_KEYS assignment in the package — remove "
            "the stale registry entry",
        ))
    return findings


def mur900_roundtrip_findings(dur_path: str, roundtrip=None) -> List[Finding]:
    """MUR900 half (b): a payload carrying every base section and every
    reserved agg_state key survives the snapshot save->restore roundtrip
    bit for bit.  ``roundtrip`` replaces the snapshot module's probe (the
    tests plant a snapshot that drops a key)."""
    import tempfile

    import numpy as np

    from murmura_tpu_torch.durability import snapshot as dsnap

    try:
        groups = dsnap.resolve_reserved_agg_state_keys()
    except Exception as e:  # noqa: BLE001 — a stale entry IS the finding
        return [Finding(
            "MUR900", dur_path, 1,
            f"RESERVED_AGG_STATE_KEY_GROUPS failed to resolve "
            f"({type(e).__name__}: {e}) — registry entries must import to "
            "non-empty tuples of agg_state key strings",
        )]
    rng = np.random.default_rng(0)
    agg_state = {"ordinary_stat": rng.normal(size=(4,)).astype(np.float32)}
    for keys in groups.values():
        for k in keys:
            agg_state[k] = rng.normal(size=(4, 3)).astype(np.float32)
    payload = {
        "params": rng.normal(size=(4, 2)).astype(np.float32),
        "agg_state": agg_state,
        "rng": np.zeros(2, np.uint32),
        "round": 3,
        "history": {"round": [1, 2, 3]},
        "round_times": [0.1, 0.2, 0.3],
    }
    probe = roundtrip or dsnap.snapshot_roundtrip_missing_sections
    try:
        with tempfile.TemporaryDirectory() as d:
            missing, corrupted = probe(d, payload)
    except Exception as e:  # noqa: BLE001 — a broken writer IS the finding
        return [Finding(
            "MUR900", dur_path, 1,
            f"the snapshot roundtrip probe crashed ({type(e).__name__}: "
            f"{e}) — the save/restore path cannot carry the reserved state",
        )]
    findings: List[Finding] = []
    for section in missing:
        findings.append(Finding(
            "MUR900", dur_path, 1,
            f"snapshot base section '{section}' did not survive the "
            "save->restore roundtrip — the snapshot payload is incomplete",
        ))
    for key in corrupted:
        findings.append(Finding(
            "MUR900", dur_path, 1,
            f"reserved carried-state key '{key}' was lost or corrupted by "
            "the snapshot roundtrip — a resumed run would silently drop "
            "this subsystem's carried state",
        ))
    return findings
