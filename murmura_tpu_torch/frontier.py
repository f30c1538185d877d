# Copy of FRONTIER_SCHEMA_VERSION, FrontierCell, _geom_grid, _cell_config,
# _members_for, _honest_final, _adaptive_summary, _locate_break, run_cell,
# declared_influence, run_frontier, write_frontier, load_frontier and
# frontier_break_summary from murmura_tpu/frontier.py, and AGG_CASES from
# murmura_tpu/analysis/ir.py.
"""``python -m murmura_tpu_torch frontier <yaml>``: the robustness frontier.

For every (rule x adaptive attack x topology [x percentage]) cell of the
config's ``frontier:`` grid, the search charts honest accuracy against
attack strength and locates the rule's empirical breaking point (the
strength where the honest accuracy falls below ``break_fraction`` of the
0-strength member's), then writes one artifact with that point beside the
rule's declared influence bound (``AggregatorDef.influence``).

A cell's strength x seed grid is one gang (core/gang.py): every strength
is a member's ``attack_scale``, and a 0-strength member rides every stage
as the benign reference.  Successive halving re-aims the grid at the cliff
between stages through :meth:`GangNetwork.reset_run`, a value-only reset,
so the stages reuse the cell's programs.  The attacks are adaptive
(attacks/adaptive.py): each member's attacker tunes its own strength
against the acceptance taps within the member's base strength.

``compiles`` in the artifact: the JAX package counts the XLA compiles a
cell triggered.  The port compiles no program; it counts what it builds
inside the cell instead: the gang's chunk programs
(``GangNetwork.program_builds``, 1 for a cell whose stages all run the
same fused chunk) plus the ``nvcc`` builds started inside the cell (0 once
the kernels are built).  A stage reset adds none.

In a group's ranks (cli.py launches them once for the command) each
cell's gang is split over the group: over a seed group each rank trains a
block of the members, and the histories and the members' adaptive state
are gathered, so every rank computes the same curve, the same breaking
point and the same next stage; over a param group every rank runs every
member on its own node rows (core/gang.py).  Only rank 0 writes the
artifact.
"""

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from murmura_tpu_torch.config.schema import Config, FrontierConfig

FRONTIER_SCHEMA_VERSION = 1

# The strength grid's floor: successive halving must not chase the cliff
# into denormals (a strength this small means the rule filters the attack
# outright, which the artifact records as such).
_MIN_STRENGTH = 1e-3

# The canonical parameters of each rule: a cell that runs another rule than
# the base config's takes these.
AGG_CASES: Dict[str, Dict[str, Any]] = {
    "fedavg": {},
    "krum": {"num_compromised": 1},
    "balance": {},
    "sketchguard": {"sketch_size": 64},
    "ubar": {},
    "evidential_trust": {},
    "median": {},
    "trimmed_mean": {},
    "geometric_median": {"max_iters": 4},
}


@dataclass
class FrontierCell:
    """One cell's accumulated results."""

    rule: str
    attack: str
    topology: str
    degree: int
    percentage: Optional[float] = None
    # strength -> {"per_seed", "adaptive", "stage", "mean", "std"}
    curve: Dict[float, Dict[str, Any]] = field(default_factory=dict)
    benign_accuracy: float = float("nan")
    compiles: int = 0
    stages_run: int = 0


def _geom_grid(lo: float, hi: float, points: int) -> List[float]:
    lo = max(float(lo), _MIN_STRENGTH)
    hi = max(float(hi), lo * (1.0 + 1e-6))
    return [float(g) for g in np.geomspace(lo, hi, points)]


def _cell_config(
    config: Config,
    f: FrontierConfig,
    rule: str,
    attack: str,
    topology: str,
    members: Optional[List[Dict[str, Any]]] = None,
    percentage: Optional[float] = None,
) -> Config:
    """One cell's runnable config, derived from the base experiment: its
    data, model and training; the rule's params from the base config when
    the cell runs the configured rule, else from :data:`AGG_CASES`; the
    adaptive attack with its placement seed pinned to the base experiment's
    (every member of every stage shares the compromised set); the dense
    topology, or the exponential graph of the same size for ``sparse``.
    Telemetry, durability and the sweep and frontier blocks are dropped."""
    from murmura_tpu_torch.utils.factories import ConfigError

    raw = config.model_dump()
    raw["aggregation"] = {
        "algorithm": rule,
        "params": (
            dict(config.aggregation.params)
            if rule == config.aggregation.algorithm
            else dict(AGG_CASES.get(rule, {}))
        ),
    }
    base_attack = config.attack
    if percentage is not None:
        # The breakdown-point axis: a compromised fraction of its own (the
        # placement cannot vary inside one gang).
        pct = float(percentage)
    else:
        pct = base_attack.percentage if base_attack.enabled else 0.25
    params: Dict[str, Any] = {}
    if attack == "gaussian":
        params["noise_std"] = float(
            base_attack.params.get("noise_std", 10.0)
        ) if base_attack.type == "gaussian" else 10.0
    elif base_attack.type == "alie" and "z" in base_attack.params:
        params["z"] = base_attack.params["z"]
    params["seed"] = int(base_attack.params.get("seed", config.experiment.seed))
    raw["attack"] = {
        "enabled": True,
        "type": attack,
        "percentage": pct,
        "params": params,
        "adaptive": {"enabled": True},
    }
    n = config.topology.num_nodes
    if topology == "sparse":
        raw["topology"] = {"type": "exponential", "num_nodes": n}
    elif config.topology.type in ("exponential", "one_peer"):
        # A sparse base config: the dense cell takes the k-regular(4) graph
        # of the same size.
        raw["topology"] = {"type": "k-regular", "num_nodes": n, "k": min(4, n - 1)}
    else:
        raw["topology"] = config.topology.model_dump()
    if f.rounds is not None:
        raw["experiment"] = {**raw["experiment"], "rounds": int(f.rounds)}
    raw["experiment"]["verbose"] = False
    for key in ("telemetry", "durability", "sweep", "frontier"):
        raw.pop(key, None)
    if members is not None:
        raw["sweep"] = {"members": members}
    try:
        return Config.model_validate(raw)
    except Exception as e:  # noqa: BLE001 - surfaced as the CLI's config error
        raise ConfigError(
            f"frontier cell {rule} x {attack} x {topology} does not validate "
            f"against the base config: {e}"
        ) from e


def _members_for(strengths: Sequence[float], seeds: Sequence[int]) -> List[Dict[str, Any]]:
    return [{"seed": int(s), "attack_scale": float(g)} for g in strengths for s in seeds]


def frontier_gang_size(config: Config) -> int:
    """The members of every cell's gang: the 0-strength member and
    ``points`` strengths, each at every seed (a later stage keeps the
    count)."""
    f = config.frontier or FrontierConfig()
    seeds = list(f.seeds) if f.seeds is not None else [config.experiment.seed]
    return (1 + f.points) * len(seeds)


def _honest_final(history: Dict[str, List[float]]) -> float:
    rows = history.get("honest_accuracy") or history.get("mean_accuracy")
    return float(rows[-1]) if rows else float("nan")


def _adaptive_summary(gang, member: int) -> Dict[str, float]:
    """The member's adaptation state, each ``atk_*`` key's mean over the
    compromised rows: where the attacker converged (``member``: its lane
    on this rank)."""
    comp = np.asarray(gang.compromised) > 0
    out: Dict[str, float] = {}
    for key, arr in gang.agg_state.items():
        if not key.startswith("atk_"):
            continue
        rows = torch.as_tensor(arr)[member].cpu().numpy()
        out[key] = float(rows[comp].mean()) if comp.any() else float("nan")
    return out


def _locate_break(curve: Dict[float, Dict[str, Any]], benign: float, break_fraction: float):
    """(last_held, first_broken, threshold): the largest strength whose mean
    honest accuracy still clears the threshold and the smallest below it."""
    thr = break_fraction * benign
    held = [g for g, rec in curve.items() if g > 0 and rec["mean"] >= thr]
    broken = [g for g, rec in curve.items() if g > 0 and rec["mean"] < thr]
    last_held = max(held) if held else None
    first_broken = min(broken) if broken else None
    return last_held, first_broken, thr


def run_cell(
    config: Config,
    f: FrontierConfig,
    rule: str,
    attack: str,
    topology: str,
    seeds: Sequence[int],
    progress: Optional[Callable[[str], None]] = None,
    percentage: Optional[float] = None,
    device="cuda",
) -> FrontierCell:
    """One cell: the stage-0 grid, then successive halving around the
    cliff, on one gang with value-only resets between stages."""
    from murmura_tpu_torch.core.gang import GangMember
    from murmura_tpu_torch.ops import _build
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    say = progress or (lambda s: None)
    grid = _geom_grid(f.strength_lo, f.strength_hi, f.points)
    strengths = [0.0] + grid
    cfg = _cell_config(config, f, rule, attack, topology,
                       members=_members_for(strengths, seeds), percentage=percentage)
    rounds = cfg.experiment.rounds
    nvcc_before = len(_build.STARTED)
    gang = build_gang_from_config(cfg, device=device, retain_init=True)
    if topology == "sparse":
        degree = len(gang.topology.offsets)
    else:
        degree = int(np.asarray(gang.topology.mask()).sum(axis=1).max())

    cell = FrontierCell(
        rule=rule, attack=attack, topology=topology, degree=degree,
        percentage=float(percentage) if percentage is not None
        else float(cfg.attack.percentage),
    )

    def run_stage(stage: int, stage_strengths: Sequence[float]) -> None:
        members = [GangMember(seed=int(s), attack_scale=float(g))
                   for g in stage_strengths for s in seeds]
        if stage > 0:
            gang.reset_run(members)
        histories = gang.train(rounds=rounds, eval_every=rounds, rounds_per_dispatch=rounds)
        comp = np.asarray(gang.compromised) > 0
        adaptive = []
        if comp.any():
            # Over a seed group a rank holds its block of the members: their
            # adaptation state is summarised there and gathered.
            seeds_of = getattr(gang, "seed_group", None)
            held = len(members) if seeds_of is None else len(gang.agg_states)
            adaptive = [_adaptive_summary(gang, i) for i in range(held)]
            if seeds_of is not None:
                adaptive = gang.gather_members(adaptive)
        for i, m in enumerate(members):
            g = float(m.attack_scale)
            rec = cell.curve.setdefault(g, {"per_seed": {}, "adaptive": {}, "stage": stage})
            rec["per_seed"][str(m.seed)] = _honest_final(histories[i])
            if comp.any():
                rec["adaptive"][str(m.seed)] = adaptive[i]
        for rec in cell.curve.values():
            vals = list(rec["per_seed"].values())
            rec["mean"] = float(np.mean(vals))
            rec["std"] = float(np.std(vals))
        cell.stages_run = stage + 1

    say(f"  stage 0: strengths {['%.3g' % g for g in strengths]}")
    run_stage(0, strengths)
    cell.benign_accuracy = cell.curve[0.0]["mean"]
    for stage in range(1, f.stages):
        last_held, first_broken, _thr = _locate_break(cell.curve, cell.benign_accuracy,
                                                      f.break_fraction)
        if last_held is None and first_broken is None:
            break
        if first_broken is None:
            # Nothing broke: push the grid up.
            nxt = _geom_grid(last_held, last_held * 4.0, f.points)
        elif last_held is None:
            # Everything broke: pull the grid down.
            nxt = _geom_grid(first_broken / 8.0, first_broken, f.points)
        else:
            if first_broken <= last_held * (1.0 + 1e-6):
                break  # not monotone: the bracket is as tight as this grid makes it
            nxt = _geom_grid(last_held, first_broken, f.points + 2)[1:-1]
        fresh = [g for g in nxt if all(abs(g - g0) > 1e-9 for g0 in cell.curve)]
        if not fresh:
            break
        while len(fresh) < f.points:
            fresh.append(grid[len(fresh) % len(grid)])
        say(f"  stage {stage}: refining {['%.3g' % g for g in fresh[: f.points]]}")
        run_stage(stage, [0.0] + fresh[: f.points])
    cell.compiles = gang.program_builds + len(_build.STARTED) - nvcc_before
    return cell


def declared_influence(rule: str, degree: int) -> Optional[Dict[str, Any]]:
    """The rule's declared influence contract at this cell's degree."""
    try:
        from murmura_tpu_torch.aggregation import build_aggregator

        agg = build_aggregator(rule, dict(AGG_CASES.get(rule, {})), model_dim=8)
    except Exception:  # noqa: BLE001 - the artifact stays writable
        return None
    decl = agg.influence
    if decl is None:
        return None
    return {
        "kind": decl.kind,
        "bound": decl.bound(degree) if decl.kind == "bounded" else None,
        "describe": decl.describe(degree),
    }


def run_frontier(config: Config, progress: Optional[Callable[[str], None]] = None,
                 device="cuda") -> Dict[str, Any]:
    """Run the configured grid on ``device``; returns the artifact dict."""
    from murmura_tpu_torch.aggregation import AGGREGATORS
    from murmura_tpu_torch.utils.factories import ConfigError

    say = progress or (lambda s: None)
    f = config.frontier or FrontierConfig()
    unknown = sorted(set(f.rules) - set(AGGREGATORS))
    if unknown:
        raise ConfigError(
            f"frontier.rules names unregistered aggregation rule(s) {unknown}; "
            f"known: {sorted(AGGREGATORS)}"
        )
    # Before any cell trains: every cell runs an adaptive attack.
    if config.dmtt is not None:
        raise ConfigError(
            "frontier cells run adaptive attacks, which do not compose with dmtt — "
            "remove the dmtt block from the frontier config"
        )
    if config.backend == "distributed":
        raise ConfigError(
            "frontier cells close the attack feedback loop inside the jitted round "
            "program; use backend: simulation or tpu"
        )
    seeds = list(f.seeds) if f.seeds is not None else [config.experiment.seed]
    percentages: List[Optional[float]] = (
        [float(p) for p in f.percentages] if f.percentages is not None else [None])

    cells: List[Dict[str, Any]] = []
    for rule in f.rules:
        for attack in f.attacks:
            for topology in f.topologies:
                for pct in percentages:
                    pct_label = "" if pct is None else f" x pct={pct:g}"
                    say(f"cell {rule} x {attack} x {topology}{pct_label}")
                    cell = run_cell(config, f, rule, attack, topology, seeds,
                                    progress=progress, percentage=pct, device=device)
                    last_held, first_broken, thr = _locate_break(
                        cell.curve, cell.benign_accuracy, f.break_fraction)
                    cells.append({
                        "rule": rule,
                        "attack": attack,
                        "topology": topology,
                        "percentage": cell.percentage,
                        "degree": cell.degree,
                        "benign_accuracy": cell.benign_accuracy,
                        "curve": [{"strength": g, **rec} for g, rec in sorted(cell.curve.items())],
                        "breaking_point": {
                            "last_held": last_held,
                            "first_broken": first_broken,
                            "threshold_accuracy": thr,
                            "criterion": (
                                f"mean honest accuracy < {f.break_fraction} x benign "
                                "(0-strength) accuracy"
                            ),
                        },
                        "declared_influence": declared_influence(rule, cell.degree),
                        "stages": cell.stages_run,
                        "compiles": cell.compiles,
                    })

    return {
        "schema_version": FRONTIER_SCHEMA_VERSION,
        "generated_by": "murmura frontier",
        "experiment": config.experiment.name,
        "grid": {
            "rules": list(f.rules),
            "attacks": list(f.attacks),
            "topologies": list(f.topologies),
            "percentages": list(f.percentages) if f.percentages is not None else None,
            "seeds": seeds,
            "points": f.points,
            "stages": f.stages,
            "rounds": f.rounds or config.experiment.rounds,
            "strength_lo": f.strength_lo,
            "strength_hi": f.strength_hi,
            "break_fraction": f.break_fraction,
            "num_nodes": config.topology.num_nodes,
        },
        "cells": cells,
    }


def write_frontier(artifact: Dict[str, Any], path) -> Path:
    """Write the artifact durably (fsync'd, then renamed into place)."""
    from murmura_tpu_torch.utils.checkpoint import durable_replace

    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    durable_replace(path.parent, path.name,
                    (json.dumps(artifact, indent=2) + "\n").encode("utf-8"))
    return path


def load_frontier(path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        artifact = json.load(fh)
    if "cells" not in artifact:
        raise ValueError(f"{path} is not a frontier artifact (no 'cells' section)")
    return artifact


def frontier_break_summary(artifact: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row a cell: the empirical breaking point beside the declared
    bound (``report --frontier``)."""
    rows = []
    for c in artifact.get("cells", []):
        decl = c.get("declared_influence") or {}
        bp = c.get("breaking_point") or {}
        rows.append({
            "rule": c.get("rule"),
            "attack": c.get("attack"),
            "topology": c.get("topology"),
            # Artifacts older than the percentage axis have none: unknown, not 0.
            "percentage": c.get("percentage"),
            "degree": c.get("degree"),
            "benign_accuracy": c.get("benign_accuracy"),
            "last_held": bp.get("last_held"),
            "first_broken": bp.get("first_broken"),
            "declared": decl.get("describe"),
            "declared_kind": decl.get("kind"),
            "declared_bound": decl.get("bound"),
            "compiles": c.get("compiles"),
        })
    return rows
