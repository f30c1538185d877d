# Copy of GRID_SCHEMA_VERSION, _NON_STRUCTURAL_SECTIONS, _MEMBER_LEAVES,
# structural_fingerprint, GridCell, GridBucket, expand_cells, class_config,
# _cell_members, plan_grid, run_grid, write_grid and load_grid from
# murmura_tpu/serve/scheduler.py.
"""``python -m murmura_tpu_torch grid <yaml>``: the grid scheduler.

The paper's evaluation grid is rule x attack x topology x strength x seed.
Only rule, attack type and topology change a round program; strength is a
member's ``attack_scale`` and seed its own lane.  The scheduler partitions
the grid's cells into buckets, one structural class each, and runs every
bucket as one gang (core/gang.py) on the fused dispatch path, then writes
one cross-cell manifest (``grid.json``) that ``report --grid`` renders.

**The bucket key.**  The JAX package keys a bucket by the traced jaxpr
skeleton of a representative member program, and refuses two classes whose
skeletons are equal but whose configs differ (their trace-time constants
would differ, so one compiled bucket could not serve both).  The port
traces nothing: it keys a class by :func:`structural_fingerprint` of its
one-member class config, a hash of every config field that reaches a round
program (the rule, attack and topology, the shapes and every constant the
programs close over).  That key is also the serve daemon's admission key,
so the grid and the daemon agree.  A port that compiles nothing cannot pay
a hidden recompile, so it has no such refusal: two classes with equal
fingerprints are value-compatible by construction and share a bucket.
The fingerprint leaves out the member values (seed, strength), so every
cell of a class has its bucket's key by construction; what can still fail
is a cell whose own program cannot take its bucket's lanes (its data or
batch schedule differs from the bucket's).  :func:`cell_program` builds
that cell's one-member program through the factories, as the JAX package's
MUR1600 check builds it to trace, and a test holds every cell's program
admissible (``core.gang.check_member_compatible``) beside its bucket's
first.

**Compiles.**  A bucket's ``compiles`` is what it built: the gang's chunk
programs (1: the bucket runs its rounds as one fused chunk) plus the
``nvcc`` builds started inside it (each kernel builds once a process, in
the first bucket that launches it).

**In a group.**  ``grid`` (cli.py) runs in the ranks of one group where
the largest bucket's gang plan has a seed or param axis above 1: each
bucket's lanes are split over a seed group (the histories gathered, so
every rank builds the same manifest), or each bucket's gang runs over a
param group.  The manifest keeps its one-process meaning: ``compiles`` is
one rank's (every rank builds the same), ``wall_s`` the rank's own, and
rank 0 writes.
"""

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from murmura_tpu_torch.config.schema import Config, GridConfig

GRID_SCHEMA_VERSION = 1

# Config sections that never reach a round program: identity,
# observability, durability and driver blocks.  Everything else is
# structural and therefore part of the bucket.
_NON_STRUCTURAL_SECTIONS = (
    "telemetry", "durability", "sweep", "frontier", "grid", "serve",
)
# The member axis inside structural sections: values a gang passes each
# lane (its seed, and its learning rate, which the serve path always sets).
_MEMBER_LEAVES = (("experiment", "name"), ("experiment", "seed"),
                  ("experiment", "verbose"), ("training", "lr"))


def structural_fingerprint(config: Config) -> str:
    """Stable hash of the config's structural content: the serve daemon's
    admission key and the grid's bucket key.  Two configs with equal
    fingerprints build member programs that one warm gang can run side by
    side (same shapes, rule, attack placement and constants, topology)."""
    raw = config.model_dump()
    for section in _NON_STRUCTURAL_SECTIONS:
        raw.pop(section, None)
    for section, leaf in _MEMBER_LEAVES:
        if isinstance(raw.get(section), dict):
            raw[section].pop(leaf, None)
    blob = json.dumps(raw, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


@dataclass(frozen=True)
class GridCell:
    """One executable point of the grid."""

    rule: str
    attack: str
    topology: str
    strength: float
    seed: int

    @property
    def cell_id(self) -> str:
        return (
            f"{self.rule}/{self.attack}/{self.topology}"
            f"/g{self.strength:g}/s{self.seed}"
        )

    @property
    def class_key(self) -> Tuple[str, str, str]:
        """The cell's structural class: strength and seed are member values
        inside a class."""
        return (self.rule, self.attack, self.topology)


@dataclass
class GridBucket:
    """One bucket: the cells of one structural class, run as one gang."""

    key: str
    rule: str
    attack: str
    topology: str
    cells: List[GridCell] = field(default_factory=list)
    config: Optional[Config] = field(repr=False, default=None)


def _grid_seeds(config: Config, g: GridConfig) -> List[int]:
    return ([int(s) for s in g.seeds] if g.seeds is not None
            else [config.experiment.seed, config.experiment.seed + 1])


def expand_cells(config: Config, g: GridConfig) -> List[GridCell]:
    """The configured grid as a flat cell list.  Benign (``none``) cells
    carry strength 0 only: there is no perturbation to scale."""
    seeds = _grid_seeds(config, g)
    cells: List[GridCell] = []
    for rule in g.rules:
        for attack in g.attacks:
            strengths = [0.0] if attack == "none" else list(g.strengths)
            for topology in g.topologies:
                for strength in strengths:
                    for seed in seeds:
                        cells.append(GridCell(
                            rule=rule, attack=attack, topology=topology,
                            strength=float(strength), seed=int(seed),
                        ))
    return cells


def class_config(
    config: Config, g: GridConfig, rule: str, attack: str, topology: str,
    members: Optional[List[Dict[str, Any]]] = None,
) -> Config:
    """One structural class's runnable config, derived from the base
    experiment (frontier._cell_config's discipline): the rule's params from
    the base config for the configured rule, else :data:`AGG_CASES`; the
    attack's placement pinned to the base experiment seed, so that every
    member of every generation shares it; telemetry, durability and the
    driver blocks dropped (the grid manifest is the output); ``members`` as
    the ``sweep`` block."""
    from murmura_tpu_torch.frontier import AGG_CASES

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
    if attack == "none":
        raw["attack"] = {"enabled": False}
    else:
        params: Dict[str, Any] = {}
        if attack == "gaussian":
            params["noise_std"] = float(
                base_attack.params.get("noise_std", 10.0)
            ) if base_attack.type == "gaussian" else 10.0
        elif attack == "alie" and base_attack.type == "alie":
            if "z" in base_attack.params:
                params["z"] = base_attack.params["z"]
        params["seed"] = int(base_attack.params.get("seed", config.experiment.seed))
        raw["attack"] = {
            "enabled": True,
            "type": attack,
            "percentage": base_attack.percentage if base_attack.enabled else 0.25,
            "params": params,
        }
    n = config.topology.num_nodes
    if topology == "sparse":
        raw["topology"] = {"type": "exponential", "num_nodes": n}
    elif config.topology.type in ("exponential", "one_peer"):
        raw["topology"] = {"type": "k-regular", "num_nodes": n, "k": min(4, n - 1)}
    else:
        raw["topology"] = config.topology.model_dump()
    if g.rounds is not None:
        raw["experiment"] = {**raw["experiment"], "rounds": int(g.rounds)}
    raw["experiment"]["verbose"] = False
    for section in _NON_STRUCTURAL_SECTIONS:
        raw.pop(section, None)
    if members is not None:
        raw["sweep"] = {"members": members}
    try:
        return Config.model_validate(raw)
    except Exception as e:  # noqa: BLE001 — surface as the CLI's error kind
        from murmura_tpu_torch.utils.factories import ConfigError

        raise ConfigError(
            f"grid cell class {rule} x {attack} x {topology} does not "
            f"validate against the base config: {e}"
        ) from e


def _cell_members(cells: Sequence[GridCell], attack: str) -> List[Dict[str, Any]]:
    if attack == "none":
        return [{"seed": c.seed} for c in cells]
    return [{"seed": c.seed, "attack_scale": c.strength} for c in cells]


def cell_program(config: Config, g: GridConfig, cell: GridCell, device="cuda"):
    """That exact cell's one-member program, built on ``device`` through the
    factories from the cell's own config (the JAX package's
    ``cell_skeleton`` builds the same program to trace it)."""
    from murmura_tpu_torch.core.gang import resolve_members
    from murmura_tpu_torch.utils.factories import build_gang_member_programs

    cfg = class_config(config, g, cell.rule, cell.attack, cell.topology,
                       members=_cell_members([cell], cell.attack))
    return build_gang_member_programs(cfg, resolve_members(cfg), device=device)[0]


def plan_grid(config: Config, g: Optional[GridConfig] = None) -> List[GridBucket]:
    """Partition the configured grid into buckets, one a structural class
    (rule x attack x topology) in the order the cells expand, keyed by the
    fingerprint of the class's config.  Builds nothing."""
    from murmura_tpu_torch.aggregation import AGGREGATORS
    from murmura_tpu_torch.utils.factories import ConfigError

    g = g or config.grid or GridConfig()
    unknown = sorted(set(g.rules) - set(AGGREGATORS))
    if unknown:
        raise ConfigError(
            f"grid.rules names unregistered aggregation rule(s) "
            f"{unknown}; known: {sorted(AGGREGATORS)}"
        )
    classes: Dict[Tuple[str, str, str], List[GridCell]] = {}
    for cell in expand_cells(config, g):
        classes.setdefault(cell.class_key, []).append(cell)
    by_key: Dict[str, GridBucket] = {}
    for (rule, attack, topology), cls_cells in classes.items():
        key = structural_fingerprint(class_config(config, g, rule, attack, topology))
        bucket = by_key.get(key)
        if bucket is None:
            bucket = by_key[key] = GridBucket(key=key, rule=rule, attack=attack,
                                              topology=topology)
        bucket.cells.extend(cls_cells)
    for b in by_key.values():
        b.config = class_config(config, g, b.rule, b.attack, b.topology,
                                members=_cell_members(b.cells, b.attack))
    return list(by_key.values())


def run_grid(
    config: Config,
    progress: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Plan and run the whole grid on ``device``; returns the ``grid.json``
    manifest.  Each bucket runs as one gang, its rounds fused into one
    chunk, and records what it built (``compiles``, the module docstring)
    beside the manifest's total."""
    import time

    import torch

    from murmura_tpu_torch.ops import _build
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    say = progress or (lambda s: None)
    g = config.grid or GridConfig()
    buckets = plan_grid(config, g)
    say(
        f"grid: {sum(len(b.cells) for b in buckets)} cells in "
        f"{len(buckets)} buckets"
    )

    bucket_rows: List[Dict[str, Any]] = []
    cell_rows: List[Dict[str, Any]] = []
    total_compiles = 0
    for bucket in buckets:
        cfg = bucket.config
        rounds = cfg.experiment.rounds
        say(
            f"bucket {bucket.key} ({bucket.rule} x {bucket.attack} x "
            f"{bucket.topology}): {len(bucket.cells)} cells"
        )
        nvcc_before = len(_build.STARTED)
        gang = build_gang_from_config(cfg, device=device)
        t0 = time.perf_counter()
        histories = gang.train(rounds=rounds, eval_every=rounds, rounds_per_dispatch=rounds)
        if gang.device.type == "cuda":
            torch.cuda.synchronize(gang.device)
        wall = time.perf_counter() - t0
        compiles = gang.program_builds + len(_build.STARTED) - nvcc_before
        total_compiles += compiles
        bucket_rows.append({
            "key": bucket.key,
            "rule": bucket.rule,
            "attack": bucket.attack,
            "topology": bucket.topology,
            "cells": [c.cell_id for c in bucket.cells],
            "batch": gang.batch,
            "gang_size": gang.gang_size,
            "rounds": rounds,
            "compiles": compiles,
            "wall_s": wall,
        })
        mean_round_s = float(np.mean(gang.round_times)) if gang.round_times else 0.0
        for i, cell in enumerate(bucket.cells):
            hist = histories[i]
            honest = hist.get("honest_accuracy") or hist.get("mean_accuracy")
            mean = hist.get("mean_accuracy")
            cell_rows.append({
                "id": cell.cell_id,
                "rule": cell.rule,
                "attack": cell.attack,
                "topology": cell.topology,
                "strength": cell.strength,
                "seed": cell.seed,
                "bucket": bucket.key,
                "final_accuracy": float(mean[-1]) if mean else None,
                "honest_accuracy": float(honest[-1]) if honest else None,
                "phase_times": {
                    "mode": "gang_fused",
                    "rounds": rounds,
                    "bucket_wall_s": wall,
                    "mean_round_s": mean_round_s,
                },
            })
        del gang

    return {
        "schema_version": GRID_SCHEMA_VERSION,
        "generated_by": "murmura grid",
        "experiment": config.experiment.name,
        "grid": {
            "rules": list(g.rules),
            "attacks": list(g.attacks),
            "topologies": list(g.topologies),
            "strengths": list(g.strengths),
            "seeds": _grid_seeds(config, g),
            "rounds": g.rounds or config.experiment.rounds,
            "num_nodes": config.topology.num_nodes,
        },
        "buckets": bucket_rows,
        "cells": cell_rows,
        "total_cells": len(cell_rows),
        "total_compiles": total_compiles,
    }


def write_grid(artifact: Dict[str, Any], path) -> Path:
    """Durably write the manifest (fsync'd replace: a grid run is minutes
    of compute the write must not tear)."""
    from murmura_tpu_torch.utils.checkpoint import durable_replace

    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    durable_replace(
        path.parent, path.name,
        (json.dumps(artifact, indent=2) + "\n").encode("utf-8"),
    )
    return path


def load_grid(path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        artifact = json.load(fh)
    if "buckets" not in artifact or "cells" not in artifact:
        raise ValueError(
            f"{path} is not a grid manifest (no 'buckets'/'cells' section)"
        )
    return artifact
