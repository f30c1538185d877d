# Counterpart of murmura_tpu/analysis/composition.py (MUR1400-1402).
"""Cross-feature composition contracts (``check --compose``).

The port keeps the lever composition grid as static tables
(murmura_tpu_torch/levers.py: the levers, the refusal messages keyed by
``(a, b, constraint)``, each lever's carried-state group; core/rounds.py:
the stage order).
This module closes the loop both ways:

- **MUR1400 — table <-> guard bijection.**  The tables are well formed
  (sorted pairs of known levers; the lever state groups in bijection with
  the snapshot registry; every ``record_function`` stage label of the round
  program in ``STAGE_ORDER``); every ``refusal_reason(...)`` guard site in
  config/schema.py and utils/factories.py cites a declared refusal with
  literal arguments, every declared refusal is cited, and no
  refusal-shaped literal there bypasses the table; and the executable
  census arms each refused combination and requires the declared message
  verbatim in the raised error.
- **MUR1401 — the pairwise grid.**  Every compatible pair's composed
  config builds, trains 2 rounds and then 2 more with no program or kernel
  build (:class:`~murmura_tpu_torch.analysis.sanitizers.CompileTracker`),
  with a finite ``mean_loss``.
- **MUR1402 — composed carried state and stage order.**  The reserved
  state-key groups are pairwise disjoint; a composed program carries the
  union of the two single-lever programs' ``agg_state`` keys (less the
  pipeline's broadcast buffer under staleness, which the stale cache
  replaces); its ``record_function`` stages first occur in
  ``STAGE_ORDER`` order, and each armed lever's own stage is there.

The collective parity of a composed cell is the sharded family's
(analysis/sharded.py): an in-process cell makes no collective.  The jaxpr
taint half (MUR1403) has no torch counterpart.
"""

import ast
import contextlib
import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from murmura_tpu_torch.analysis.cells import family_registry, run_families
from murmura_tpu_torch.analysis.lint import Finding
from murmura_tpu_torch.core.rounds import (
    STAGE_AGGREGATE,
    STAGE_COMPRESS,
    STAGE_EXCHANGE,
    STAGE_ORDER,
    STAGE_PIPELINE,
    STAGE_STALE,
)
from murmura_tpu_torch.levers import (
    LEVER_STATE_GROUPS,
    LEVERS,
    compatible_pairs,
    declared_refusals,
    refusal_reason,
)

COMPOSE_CHECK_FAMILIES, _family = family_registry()

_PKG = Path(__file__).resolve().parent.parent
_LEVERS_PATH = str(_PKG / "levers.py")
_SCHEMA_PATH = str(_PKG / "config" / "schema.py")
_FACTORIES_PATH = str(_PKG / "utils" / "factories.py")
# The modules whose record_function labels are round stages.
_STAGE_MODULES = ("core/rounds.py", "core/gang.py")

# Stage labels a lever's arming opens in the composed round.
_SCOPED_STAGES: Dict[str, str] = {
    "adaptive": STAGE_EXCHANGE,
    "compression": STAGE_COMPRESS,
    "staleness": STAGE_STALE,
    "pipeline": STAGE_PIPELINE,
}


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _pair_anchor(a: str, b: str) -> Tuple[str, int]:
    """Findings about a pair anchor at its first refusal row in levers.py,
    else at the table."""
    earlier, later = sorted((a, b))
    try:
        for i, text in enumerate(Path(_LEVERS_PATH).read_text().splitlines(), 1):
            if f'("{earlier}", "{later}"' in text:
                return _LEVERS_PATH, i
    except OSError:
        pass
    return _LEVERS_PATH, 1


def _tag(a, b, tag) -> str:
    return f"({a}, {b}" + (f", {tag!r})" if tag else ")")


# --------------------------------------------------------------------------
# The canonical cell: one tiny experiment + one armer per lever (the JAX
# package's tables)
# --------------------------------------------------------------------------

# Ring of 8 nodes, the tiny MLP, synthetic data.
_BASE_RAW: Dict[str, Any] = {
    "experiment": {"name": "compose-cell", "seed": 7, "rounds": 6},
    "topology": {"type": "ring", "num_nodes": 8},
    "aggregation": {"algorithm": "balance", "params": {}},
    "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.05},
    "data": {"adapter": "synthetic",
             "params": {"num_samples": 40, "input_shape": [6], "num_classes": 3}},
    "model": {"factory": "mlp",
              "params": {"input_dim": 6, "hidden_dims": [8], "num_classes": 3}},
}

# One canonical arming per lever.  Constrained pairs arm outside their
# refused sub-configuration (int8 block 10 divides the 50-wide shard-local
# width, the sparse armer is not one_peer, the staleness armer carries the
# fault model it requires, the dmtt armer sets allow_static).
LEVER_ARMERS: Dict[str, Dict[str, Any]] = {
    "adaptive": {"attack": {"enabled": True, "type": "gaussian", "percentage": 0.25,
                            "adaptive": {"enabled": True},
                            "params": {"noise_std": 5.0, "seed": 7}}},
    "compression": {"compression": {"algorithm": "int8", "error_feedback": True,
                                    "block": 10}},
    "dmtt": {"dmtt": {"budget_B": 3, "rho": 0.1, "lambda_forget": 0.9, "w_a": 0.7,
                      "tau_U": 0.3, "eta": 5.0, "allow_static": True}},
    "faults": {"faults": {"enabled": True, "seed": 777, "straggler_prob": 0.3,
                          "link_drop_prob": 0.2}},
    "mobility": {"mobility": {"area_size": 100.0, "comm_range": 60.0, "max_speed": 5.0,
                              "seed": 42, "ensure_connected": True}},
    "pipeline": {"exchange": {"pipeline": True}},
    "population": {"population": {"enabled": True, "virtual_size": 32,
                                  "sampler": "stratified", "seed": 3,
                                  "rounds_per_cohort": 1}},
    "sharding": {"backend": "tpu", "tpu": {"param_shards": 2}},
    "sparse": {"topology": {"type": "exponential", "num_nodes": 8}},
    "staleness": {"exchange": {"max_staleness": 2, "staleness_discount": 0.7},
                  "faults": {"enabled": True, "seed": 777, "straggler_prob": 0.3}},
    "sweep": {"sweep": {"num_seeds": 2}},
}

_PAIR_OVERRIDES: Dict[Tuple[str, str], Dict[str, Any]] = {
    # carried_state: error feedback is per-slot carried state; the
    # population cell arms the stateless int8 codec.
    ("compression", "population"): {"compression": {"error_feedback": False}},
}


def pair_raw(a: str, b: str) -> Dict[str, Any]:
    """The raw config of the (a, b) grid cell: base + both armers."""
    earlier, later = sorted((a, b))
    raw = _deep_merge(copy.deepcopy(_BASE_RAW), LEVER_ARMERS[earlier])
    raw = _deep_merge(raw, LEVER_ARMERS[later])
    return _deep_merge(raw, _PAIR_OVERRIDES.get((earlier, later), {}))


def _validate(raw: Dict[str, Any]):
    from murmura_tpu_torch.config.schema import Config

    return Config.model_validate(raw)


def _build_cell(cfg, device):
    """(runner, is_gang) for one validated cell config."""
    from murmura_tpu_torch.utils.factories import (
        build_gang_from_config,
        build_network_from_config,
    )

    if cfg.sweep is not None:
        return build_gang_from_config(cfg, device=device), True
    return build_network_from_config(cfg, device=device), False


# --------------------------------------------------------------------------
# MUR1400 — table <-> schema/guard bijection
# --------------------------------------------------------------------------


def stage_labels(sources: Optional[Dict[str, str]] = None) -> Dict[str, List[Tuple[str, int]]]:
    """The ``record_function`` labels of the stage modules, a literal or a
    constant of core/rounds.py: {label: [(path, line), ...]} (``sources``
    maps path to text)."""
    from murmura_tpu_torch.core import rounds

    if sources is None:
        sources = {str(_PKG / m): (_PKG / m).read_text() for m in _STAGE_MODULES}
    out: Dict[str, List[Tuple[str, int]]] = {}
    for path, src in sources.items():
        for node in ast.walk(ast.parse(src)):
            if not (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                    node.func, "attr", None)) == "record_function" and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                label = str(arg.value)
            elif isinstance(arg, ast.Name):
                label = str(getattr(rounds, arg.id, arg.id))
            else:
                continue
            out.setdefault(label, []).append((path, node.lineno))
    return out


@_family
def check_manifest_bijection(device=None) -> List[Finding]:
    """MUR1400 (structural): the levers tables are well formed and agree
    with the snapshot registry and the round program's stage labels."""
    from murmura_tpu_torch.durability.snapshot import resolve_reserved_agg_state_keys
    from murmura_tpu_torch.levers import _REFUSALS

    return table_findings(_REFUSALS, LEVER_STATE_GROUPS,
                          set(resolve_reserved_agg_state_keys()), stage_labels())


def table_findings(refusals, state_groups, reserved, labels) -> List[Finding]:
    """MUR1400 over the given tables (the tests plant a bad row)."""
    findings: List[Finding] = []
    for a, b, tag in refusals:
        if a not in LEVERS or b not in LEVERS or not a < b:
            findings.append(Finding(
                "MUR1400", _LEVERS_PATH, 1,
                f"refusal row {_tag(a, b, tag)} is not a sorted pair of "
                "levers.LEVERS — refusal_reason() could never find it",
            ))
    for lever in sorted(set(state_groups) - set(LEVERS)):
        findings.append(Finding(
            "MUR1400", _LEVERS_PATH, 1,
            f"LEVER_STATE_GROUPS names '{lever}', which is not a lever",
        ))
    claimed = set(state_groups.values())
    for group in sorted(claimed - reserved):
        findings.append(Finding(
            "MUR1400", _LEVERS_PATH, 1,
            f"a lever claims state-key group '{group}' which "
            "RESERVED_AGG_STATE_KEY_GROUPS does not register "
            "(durability/snapshot.py)",
        ))
    for group in sorted(reserved - claimed):
        findings.append(Finding(
            "MUR1400", _LEVERS_PATH, 1,
            f"reserved state-key group '{group}' is claimed by no lever in "
            "LEVER_STATE_GROUPS — carried state with no composition owner",
        ))
    for label, sites in sorted(labels.items()):
        if label not in STAGE_ORDER:
            path, line = sites[0]
            findings.append(Finding(
                "MUR1400", path, line,
                f"round stage {label!r} is not a STAGE_ORDER label "
                "(core/rounds.py) — the composition grid cannot order it",
            ))
    return findings


_REFUSAL_PHRASES: Tuple[str, ...] = ("does not compose", "do not compose", "not gang-batchable")


def _cited_refusals(src: str, path: str):
    """(citations, findings) of one guard module's source."""
    findings: List[Finding] = []
    cited: List[Tuple[str, str, Optional[str]]] = []
    declared = set(declared_refusals())
    tree = ast.parse(src, filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        fname = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if fname != "refusal_reason":
            continue
        lits = [a.value for a in node.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        if len(lits) != len(node.args) or len(lits) not in (2, 3):
            findings.append(Finding(
                "MUR1400", path, node.lineno,
                "refusal_reason(...) cited with non-literal arguments — the "
                "table bijection cannot be verified statically; cite lever "
                "names as string literals",
            ))
            continue
        a, b = sorted(lits[:2])
        key = (a, b, lits[2] if len(lits) == 3 else None)
        cited.append(key)
        if key not in declared:
            findings.append(Finding(
                "MUR1400", path, node.lineno,
                f"guard cites refusal_reason{tuple(lits)} but levers.py "
                "declares no such refusal — an undeclared refusal (or a "
                "stale citation after a lift)",
            ))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            low = node.value.lower()
            hits = [p for p in _REFUSAL_PHRASES if p in low]
            if hits:
                findings.append(Finding(
                    "MUR1400", path, node.lineno,
                    f"refusal-shaped literal (contains {hits!r}) is not "
                    "routed through refusal_reason(...) — an undeclared "
                    "cross-feature refusal bypassing the table",
                ))
    return cited, findings


def refusal_guard_findings(schema_src: Optional[str] = None,
                           factories_src: Optional[str] = None) -> List[Finding]:
    """MUR1400 (guard sites): every citation resolves to a declared refusal;
    every declared refusal is cited.  The sources are injectable for the
    tests' doctored guards."""
    if schema_src is None:
        schema_src = Path(_SCHEMA_PATH).read_text()
    if factories_src is None:
        factories_src = Path(_FACTORIES_PATH).read_text()
    findings: List[Finding] = []
    cited: List[Tuple[str, str, Optional[str]]] = []
    for src, path in ((schema_src, _SCHEMA_PATH), (factories_src, _FACTORIES_PATH)):
        c, f = _cited_refusals(src, path)
        cited.extend(c)
        findings.extend(f)
    for a, b, tag in declared_refusals():
        if (a, b, tag) not in set(cited):
            path, line = _pair_anchor(a, b)
            findings.append(Finding(
                "MUR1400", path, line,
                f"levers.py declares refusal {_tag(a, b, tag)} but no guard "
                "site in config/schema.py or utils/factories.py cites it — a "
                "stale row (lift it) or a missing guard",
            ))
    return findings


# The executable census: for every declared refusal, a raw config arming
# exactly the refused combination ("arm" pulls lever armers, "extra"
# patches on top) and the layer whose guard must fire.  The JAX package's
# table, less its ("compression", "sharding", "int8_block") row: the port
# refuses that block in its round program, in the JAX round program's words.
REFUSAL_CONFIGS: Dict[Tuple[str, str, Optional[str]], Dict[str, Any]] = {
    ("adaptive", "dmtt", None): {"via": "schema", "arm": ("adaptive", "dmtt")},
    ("adaptive", "pipeline", None): {"via": "schema", "arm": ("adaptive", "pipeline")},
    ("compression", "dmtt", None): {"via": "schema", "arm": ("compression", "dmtt")},
    ("compression", "population", "carried_state"): {
        "via": "schema", "arm": ("compression", "population"),
        "extra": {"compression": {"error_feedback": True}},
    },
    ("compression", "sharding", "topk"): {
        "via": "schema", "arm": ("compression", "sharding"),
        "extra": {"compression": {"algorithm": "topk", "topk_ratio": 0.1}},
    },
    ("dmtt", "mobility", "requires_mobility"): {
        "via": "schema", "arm": ("dmtt",), "extra": {"dmtt": {"allow_static": False}},
    },
    ("dmtt", "pipeline", None): {"via": "schema", "arm": ("dmtt", "pipeline")},
    ("dmtt", "population", None): {"via": "schema", "arm": ("dmtt", "population")},
    ("dmtt", "sharding", None): {"via": "schema", "arm": ("dmtt", "sharding")},
    ("dmtt", "sparse", None): {"via": "schema", "arm": ("dmtt", "sparse")},
    ("dmtt", "staleness", None): {"via": "schema", "arm": ("dmtt", "staleness")},
    ("faults", "staleness", "requires_faults"): {
        "via": "schema", "arm": (),
        "extra": {"exchange": {"max_staleness": 2, "staleness_discount": 0.7}},
    },
    ("mobility", "sparse", None): {"via": "schema", "arm": ("mobility", "sparse")},
    ("mobility", "staleness", None): {"via": "schema", "arm": ("mobility", "staleness")},
    ("pipeline", "population", None): {"via": "schema", "arm": ("pipeline", "population")},
    ("population", "sharding", None): {"via": "schema", "arm": ("population", "sharding")},
    ("population", "staleness", None): {"via": "schema", "arm": ("population", "staleness")},
    ("population", "sweep", None): {"via": "schema", "arm": ("population", "sweep")},
    ("sparse", "staleness", "one_peer"): {
        "via": "schema", "arm": ("staleness",),
        "extra": {"topology": {"type": "one_peer", "num_nodes": 8}},
    },
    ("sparse", "sweep", "tpu_backend"): {
        "via": "gang", "arm": ("sparse", "sweep"), "extra": {"backend": "tpu"},
    },
}


def census_raw(entry: Dict[str, Any]) -> Dict[str, Any]:
    raw = copy.deepcopy(_BASE_RAW)
    for lever in entry.get("arm", ()):
        raw = _deep_merge(raw, LEVER_ARMERS[lever])
    return _deep_merge(raw, entry.get("extra", {}))


def census_cell_findings(key: Tuple[str, str, Optional[str]], entry: Dict[str, Any],
                         device="cuda") -> List[Finding]:
    """Arm ONE declared refusal's combination and require its guard to fire
    with the declared message verbatim."""
    a, b, tag = key
    path, line = _pair_anchor(a, b)
    reason = refusal_reason(a, b, tag)
    try:
        cfg = _validate(census_raw(entry))
        if entry["via"] == "network":
            from murmura_tpu_torch.utils.factories import build_network_from_config

            build_network_from_config(cfg, device=device)
        elif entry["via"] == "gang":
            from murmura_tpu_torch.utils.factories import build_gang_from_config

            build_gang_from_config(cfg, device=device)
        elif entry["via"] != "schema":
            raise ValueError(f"unknown census layer {entry['via']!r}")
    except Exception as e:  # noqa: BLE001 — the raise IS the contract
        if reason not in str(e):
            return [Finding(
                "MUR1400", path, line,
                f"census {_tag(a, b, tag)} raised via {entry['via']} but the "
                "error does not carry the declared reason verbatim: "
                f"{type(e).__name__}: {str(e)[:300]}",
            )]
        return []
    return [Finding(
        "MUR1400", path, line,
        f"census {_tag(a, b, tag)} armed the refused combination via "
        f"{entry['via']} and no guard fired — a stale refusal row (lift it) "
        "or a guard that silently degraded",
    )]


def census_findings(census: Dict, device="cuda") -> List[Finding]:
    """MUR1400 (executable) over a census table: it covers every declared
    refusal and every entry's guard fires with the declared message."""
    findings: List[Finding] = []
    declared = set(declared_refusals())
    order = lambda k: (k[0], k[1], k[2] or "")  # noqa: E731
    for a, b, tag in sorted(declared - set(census), key=order):
        path, line = _pair_anchor(a, b)
        findings.append(Finding(
            "MUR1400", path, line,
            f"declared refusal {_tag(a, b, tag)} has no REFUSAL_CONFIGS "
            "census entry — add the arming raw config so the guard is "
            "executed, not just grepped",
        ))
    for a, b, tag in sorted(set(census) - declared, key=order):
        findings.append(Finding(
            "MUR1400", str(Path(__file__).resolve()), 1,
            f"census entry {_tag(a, b, tag)} matches no declared refusal — "
            "remove it (the pair was lifted) or declare the refusal",
        ))
    for key in sorted(set(census) & declared, key=order):
        try:
            findings.extend(census_cell_findings(key, census[key], device))
        except Exception as e:  # noqa: BLE001 — a crash IS the finding
            path, line = _pair_anchor(key[0], key[1])
            findings.append(Finding(
                "MUR1400", path, line,
                f"census {_tag(*key)} probe crashed: {type(e).__name__}: {e}",
            ))
    return findings


@_family
def check_refusal_census(device) -> List[Finding]:
    """MUR1400: the guard sites and the executable census."""
    return refusal_guard_findings() + census_findings(REFUSAL_CONFIGS, device)


# --------------------------------------------------------------------------
# MUR1401 + MUR1402 — the pairwise grid
# --------------------------------------------------------------------------

_COMPOSE_SUMMARIES: List[Dict[str, Any]] = []


def compose_summaries() -> List[Dict[str, Any]]:
    """Machine-readable grid rows for ``check --json`` (one
    ``{"kind": "compose_summary", ...}`` per pair, refusals included)."""
    return list(_COMPOSE_SUMMARIES)


@contextlib.contextmanager
def recorded_stages(out: List[str]):
    """Record the round program's ``record_function`` labels into ``out``
    (first occurrences, in order) while the block runs."""
    from murmura_tpu_torch.core import gang, rounds

    real = {m: m.record_function for m in (rounds, gang)}

    def recording(label, *args, **kwargs):
        if label not in out:
            out.append(label)
        return real[rounds](label, *args, **kwargs)

    for m in real:
        m.record_function = recording
    try:
        yield out
    finally:
        for m, fn in real.items():
            m.record_function = fn


_SINGLE_MEMO: Dict[str, Any] = {}


def _single_keys(lever: str, override: Dict[str, Any], device) -> set:
    """The single-lever program's agg_state keys (memoized)."""
    key = f"{lever}|{sorted(override.items())}|{device}"
    if key not in _SINGLE_MEMO:
        raw = _deep_merge(_deep_merge(copy.deepcopy(_BASE_RAW), LEVER_ARMERS[lever]), override)
        runner, is_gang = _build_cell(_validate(raw), device)
        prog = runner.program
        _SINGLE_MEMO[key] = set(prog.init_agg_state)
    return _SINGLE_MEMO[key]


def composed_state_findings(a: str, b: str, composed: set, singles: Dict[str, set],
                            reused: set) -> List[Finding]:
    """MUR1402: the composed agg_state keys cover each single's."""
    path, line = _pair_anchor(a, b)
    findings = []
    for lever, keys in singles.items():
        missing = keys - composed - reused
        if missing:
            findings.append(Finding(
                "MUR1402", path, line,
                f"[{a} x {b}] the composed agg_state drops {sorted(missing)} "
                f"that the '{lever}'-only program carries — arming a second "
                "lever silently disarmed the first",
            ))
    return findings


def stage_order_findings(a: str, b: str, stages: Sequence[str],
                         pipelined: bool) -> List[Finding]:
    """MUR1402: stages in STAGE_ORDER order, each armed lever's present."""
    path, line = _pair_anchor(a, b)
    findings = []
    order = {s: i for i, s in enumerate(STAGE_ORDER)}
    checked = list(stages)
    if pipelined and checked[:1] == [STAGE_AGGREGATE]:
        # A pipelined round drains round r-1's delayed aggregation first.
        checked = checked[1:]
    idx = [order[s] for s in checked if s in order]
    if idx != sorted(idx):
        findings.append(Finding(
            "MUR1402", path, line,
            f"[{a} x {b}] the composed round's stages first occur as "
            f"{list(stages)} — out of STAGE_ORDER (core/rounds.py)",
        ))
    for lever in (a, b):
        want = _SCOPED_STAGES.get(lever)
        if want is not None and want not in stages:
            findings.append(Finding(
                "MUR1402", path, line,
                f"[{a} x {b}] lever '{lever}' opens stage {want!r} but the "
                "composed round has no such stage — the lever is disarmed",
            ))
    return findings


def grid_cell_findings(a: str, b: str, device="cuda") -> List[Finding]:
    """One compatible pair's composed cell (MUR1401 and MUR1402)."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles

    a, b = sorted((a, b))
    path, line = _pair_anchor(a, b)
    findings: List[Finding] = []
    try:
        cfg = _validate(pair_raw(a, b))
    except Exception as e:  # noqa: BLE001 — the refusal IS the finding
        return [Finding(
            "MUR1401", path, line,
            f"[{a} x {b}] the pair is compatible in levers.py but the "
            f"composed config refuses at validation: {type(e).__name__}: "
            f"{str(e)[:300]}",
        )]
    try:
        runner, is_gang = _build_cell(cfg, device)
    except Exception as e:  # noqa: BLE001
        return [Finding(
            "MUR1401", path, line,
            f"[{a} x {b}] the pair is compatible in levers.py but the "
            f"composed build crashed: {type(e).__name__}: {str(e)[:300]}",
        )]
    runner.train(rounds=2)
    stages: List[str] = []
    with track_compiles() as tracker, recorded_stages(stages):
        runner.train(rounds=2)
    if tracker.total:
        findings.append(Finding(
            "MUR1401", path, line,
            f"[{a} x {b}] 2 composed rounds after warmup built "
            f"{tracker.total} program(s) or kernel(s) — arming two levers "
            "together must stay value-only over one round program",
        ))
    histories = list(runner.histories) if is_gang else [runner.history]
    for h in histories:
        tail = h.get("mean_loss", [])
        if not tail or not np.isfinite(np.asarray(tail, np.float64)).all():
            findings.append(Finding(
                "MUR1401", path, line,
                f"[{a} x {b}] the composed cell's mean_loss history is missing "
                f"or non-finite ({tail[-3:] if tail else []})",
            ))
            break
    if not is_gang:
        from murmura_tpu_torch.core.pipeline import PIPELINE_STATE_KEYS, pipeline_state_keys

        prog = runner.program
        override = _PAIR_OVERRIDES.get((a, b), {})
        reused = set()
        if prog.pipelined and any(k.startswith("stale_") for k in prog.init_agg_state):
            reused = set(PIPELINE_STATE_KEYS) - set(pipeline_state_keys(stale=True))
        singles = {lever: _single_keys(lever, override, device) for lever in (a, b)
                   if lever != "sweep"}
        findings += composed_state_findings(a, b, set(prog.init_agg_state), singles, reused)
        findings += stage_order_findings(a, b, stages, prog.pipelined)
    _COMPOSE_SUMMARIES.append({
        "kind": "compose_summary", "pair": [a, b], "verdict": "composes",
        "constraints": [t for x, y, t in declared_refusals() if (x, y) == (a, b) and t],
        "cell": "gang" if is_gang else "network", "recompiles": int(tracker.total),
        "clean": not findings,
    })
    return findings


@_family
def check_composition_grid(device) -> List[Finding]:
    """MUR1401/MUR1402 over every compatible pair."""
    _COMPOSE_SUMMARIES.clear()
    for a, b, tag in declared_refusals():
        if tag is None:
            _COMPOSE_SUMMARIES.append({"kind": "compose_summary", "pair": [a, b],
                                       "verdict": "refuses", "reason": refusal_reason(a, b)})
    findings: List[Finding] = []
    for a, b in compatible_pairs():
        try:
            findings.extend(grid_cell_findings(a, b, device))
        except Exception as e:  # noqa: BLE001 — a crash IS the finding
            path, line = _pair_anchor(a, b)
            findings.append(Finding(
                "MUR1401", path, line,
                f"[{a} x {b}] composed grid cell crashed: {type(e).__name__}: {e}",
            ))
    return findings


@_family
def check_composed_state(device=None) -> List[Finding]:
    """MUR1402 (global): the reserved state-key groups are pairwise
    disjoint."""
    from murmura_tpu_torch.durability.snapshot import resolve_reserved_agg_state_keys

    return disjoint_group_findings(resolve_reserved_agg_state_keys())


def disjoint_group_findings(resolved: Dict[str, Tuple[str, ...]]) -> List[Finding]:
    findings: List[Finding] = []
    groups = sorted(resolved)
    for i, g1 in enumerate(groups):
        for g2 in groups[i + 1:]:
            clash = set(resolved[g1]) & set(resolved[g2])
            if clash:
                findings.append(Finding(
                    "MUR1402", _LEVERS_PATH, 1,
                    f"reserved state-key groups {g1} and {g2} both claim "
                    f"{sorted(clash)} — composed programs would overwrite one "
                    "lever's carried state with the other's",
                ))
    return findings


def check_composition(device="cuda") -> List[Finding]:
    """MUR1400-1402."""
    return run_families(COMPOSE_CHECK_FAMILIES, "MUR1400", __file__, device)
