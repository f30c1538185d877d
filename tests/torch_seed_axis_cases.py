"""The cases of the seed-axis tests, run twice: in the test process, as the
one-process gang, and in the ranks of a spawned seed group (``launch(...,
axis="seed")``, murmura_tpu_torch/parallel/launch.py), each rank holding a
block of the members.  The ranks import this module, so it imports neither
JAX nor the JAX package.

Every case returns plain numpy or JSON-able values: the gang's whole
``[S, N, P]`` state as rank 0 gathers it (None on the other ranks), every
member's history (every rank records them all), the rank's block of
members and what it built, so that the two runs compare directly.
"""

from pathlib import Path

import torch

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.parallel.launch import forbidden_modules
from murmura_tpu_torch.parallel.mesh import process_group
from murmura_tpu_torch.utils.factories import build_gang_from_config
from torch_node_axis_cases import N, SEED, tiny_config  # noqa: F401

WORLD = 4


def gang_config(**over) -> dict:
    """tests/torch_node_axis_cases.py's tiny flagship-shaped config (Krum
    under a gaussian attack, chaos_churn.yaml's faults, ``backend: tpu``)
    at ``tpu.num_devices: 4``: a gang of 3 to 8 members plans a seed axis
    of 4 there (the JAX package's ``make_gang_mesh``)."""
    return tiny_config(**over)


def _state(gang):
    """The gang's whole state in the snapshot layout, on the host (rank 0's;
    None on the other ranks of a group)."""
    flat, state = gang._durability_params()
    if flat is None:
        return None
    return {"flat": flat.numpy(), "state": {k: v.numpy() for k, v in state.items()}}


def rounds_with_draws(gang, draws, rounds):
    """``rounds`` gang rounds through the gang's step with injected draws
    (one dict a member a round, the JAX members' own; the rank takes its
    block's), each evaluated and recorded as ``train`` records it, the
    metric rows gathered over a seed group."""
    adj = torch.from_numpy(gang.topology.mask())
    lo, hi = gang._block
    n = gang.program.num_nodes
    for r in range(rounds):
        rows = []
        if hi > lo:
            gang.flats, gang.agg_states, metrics = gang._step(
                gang.flats, gang.agg_states, adj, r, draws=draws[r][lo:hi])
            s_count, own, p = gang.flats.shape
            ev = gang.program.eval_step(gang.flats.reshape(s_count * own, p), data=gang._data,
                                        members=s_count)
            rows = [{**{k: v[s * n:(s + 1) * n].numpy() for k, v in ev.items()},
                     **{k: v.numpy() for k, v in metrics[s].items()}} for s in range(s_count)]
        gang._record_all(r + 1, gang.gather_members(rows), verbose=False)
        gang.current_round = r + 1


def gang_case(spec):
    """A gang through ``build_gang_from_config`` (``spec``: the config's raw
    dict, seeds, rounds, rounds_per_dispatch; ``init`` one initial parameter
    set a member and ``draws`` one list of member draws a round, which then
    run through the gang's step; ``telemetry`` a run dir; with
    ``snapshot_dir`` the first round snapshotted there; ``resume_from`` a
    snapshot a second gang restores and trains on to ``rounds``)."""
    cfg = Config.model_validate(spec["raw"])
    if spec.get("telemetry"):
        cfg.telemetry.enabled = True
        cfg.telemetry.dir = spec["telemetry"]
    seeds = spec.get("seeds")
    rounds = spec.get("rounds", 2)
    gang = build_gang_from_config(cfg, seeds=seeds, device="cpu", init_params=spec.get("init"))
    out = {"block": tuple(gang._block), "local": int(gang.flats.shape[0]),
           "batch": gang.batch, "describe": None if gang.seed_group is None
           else gang.seed_group.describe()}
    if spec.get("draws") is not None:
        rounds_with_draws(gang, spec["draws"], rounds)
    elif spec.get("snapshot_dir"):
        gang.train(1, checkpoint_dir=spec["snapshot_dir"])
        gang.train(rounds - 1)
    else:
        gang.train(rounds, rounds_per_dispatch=spec.get("rounds_per_dispatch", 1))
    for t in gang.telemetry:
        t.close()
    out.update(run=_state(gang), histories=gang.histories, builds=gang.program_builds,
               writers=len(gang.telemetry))
    if spec.get("resume_from"):
        resumed = build_gang_from_config(cfg, seeds=seeds, device="cpu")
        out["restored_round"] = resumed.restore_checkpoint(spec["resume_from"])
        resumed.train(rounds - out["restored_round"])
        out["resumed"] = _state(resumed)
        out["resumed_histories"] = resumed.histories
    return out


def frontier_case(spec):
    """``run_frontier`` of the config (``spec``: its raw dict with a
    ``frontier:`` block): the artifact, every rank's."""
    from murmura_tpu_torch.frontier import run_frontier

    return run_frontier(Config.model_validate(spec["raw"]), device="cpu")


def grid_case(spec):
    """``run_grid`` of the config (``spec``: its raw dict with a ``grid:``
    block): the manifest, every rank's."""
    from murmura_tpu_torch.serve.scheduler import run_grid

    return run_grid(Config.model_validate(spec["raw"]), device="cpu")


def capture_gangs():
    """Keep every gang ``build_gang_from_config`` builds (the frontier's
    cells and the grid's buckets build theirs through the factories) with
    its config: returns the list of (gang, config) and a function that
    undoes the capture."""
    from murmura_tpu_torch.utils import factories

    real = factories.build_gang_from_config
    built = []

    def keep(config, *args, **kwargs):
        gang = real(config, *args, **kwargs)
        built.append((gang, config))
        return gang

    factories.build_gang_from_config = keep
    return built, lambda: setattr(factories, "build_gang_from_config", real)


def single_runs(gang, config):
    """Each member of ``gang`` (its last stage's, after a frontier's stage
    reset) as a one-member gang of the same config, trained as the frontier
    and the grid train theirs (one fused chunk, evaluated at the end): its
    whole state and history."""
    from murmura_tpu_torch.config.schema import SweepConfig

    rounds = config.experiment.rounds
    out = []
    for m in gang.members:
        cfg = config.model_copy(deep=True)
        member = {"seed": m.seed}
        if m.attack_scale is not None:
            member["attack_scale"] = m.attack_scale
        cfg.sweep = SweepConfig(members=[member])
        one = build_gang_from_config(cfg, device="cpu")
        one.train(rounds=rounds, eval_every=rounds, rounds_per_dispatch=rounds)
        out.append({"run": _state(one), "history": one.histories[0]})
    return out


def gangs_of(fn, spec):
    """``fn(spec)`` (a frontier or a grid case) with each gang it built:
    (its result, [each gang's whole state on rank 0, its histories and
    labels; with ``spec["singles"]`` each member's one-member run])."""
    built, undo = capture_gangs()
    try:
        result = fn(spec)
    finally:
        undo()
    return result, [{"run": _state(g), "histories": g.histories,
                     "labels": [m.label for m in g.members],
                     "singles": single_runs(g, c) if spec.get("singles") else None}
                    for g, c in built]


def as_param_group(fn, spec):
    """``fn(spec)`` with this rank's group re-bound as a param group of the
    same ranks (the same ``torch.distributed`` group), so that one spawn
    serves the seed and the param cases; ``fn(spec)`` outside a group."""
    from murmura_tpu_torch.parallel.mesh import ParamGroup, set_process_group

    group = process_group()
    if group is None:
        return fn(spec)
    set_process_group(ParamGroup(group.rank, group.world, group.backend, group.device))
    try:
        return fn(spec)
    finally:
        set_process_group(group)


def run_cases(cases):
    """Every (kind, spec) case in order, with this process's forbidden
    modules; what a seed group's ranks run (a ``param:`` kind over the same
    ranks as a param group)."""
    fns = {"gang": gang_case, "frontier": frontier_case, "grid": grid_case,
           "frontier_gangs": lambda s: gangs_of(frontier_case, s),
           "grid_gangs": lambda s: gangs_of(grid_case, s)}
    fns.update({f"param:{k}": (lambda s, fn=fn: as_param_group(fn, s))
                for k, fn in list(fns.items())})
    results = [fns[kind](spec) for kind, spec in cases]
    group = process_group()
    return {"results": results, "forbidden_modules": forbidden_modules(),
            "rank": None if group is None else group.rank}


def snapshot_bytes(directory) -> dict:
    """The committed snapshot's payload bytes and meta history (the meta's
    round times are walls)."""
    import json

    d = Path(directory)
    meta = json.loads((d / "meta.json").read_text())
    return {"state": (d / f"state.{meta['round']}.pt").read_bytes(),
            "history": meta["history"], "extra_meta": meta["extra_meta"]}


def without(x, keys):
    """``x`` (an artifact or a manifest) with every dict entry under one of
    ``keys`` (the walls, ``compiles``) dropped, at any depth."""
    if isinstance(x, dict):
        return {k: without(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [without(v, keys) for v in x]
    return x
