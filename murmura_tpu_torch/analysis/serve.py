# Counterpart of murmura_tpu/analysis/serve.py (MUR1600-1603).
"""The serving contracts (``check --serve``): multiplexing experiments
through shared buckets changes nothing about their numbers.

- **MUR1600 — bucket-key soundness.**  Plan a small grid and describe
  every cell's round program independently of the planner: its own
  one-member program (serve/scheduler.py ``cell_program``), described by
  its stage list (one round's ``record_function`` stages, the rule's and
  the attack's names on theirs), the shapes and dtypes of its carried state
  and data, and the kernels one round launches (or, on the CPU, whose plain
  versions it calls).  Two cells share a bucket (``structural_fingerprint``)
  if and only if their descriptions are equal.
- **MUR1601 — build-free admissions.**  A warm bucket admits a new tenant
  set (``reset_run(member_programs=...)``) and runs it with no program or
  kernel build.
- **MUR1602 — frozen-lane non-interference.**  Freezing one member of a
  two-member gang leaves the survivor's history bit-equal to a gang that
  never had the neighbour.
- **MUR1603 — resume completeness.**  An in-process daemon killed
  mid-generation and recovered over the same ``state_dir`` finishes every
  submission with the uninterrupted daemon's histories.
"""

import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Tuple

from murmura_tpu_torch.analysis.cells import anchor, base_raw, family_registry, run_families
from murmura_tpu_torch.analysis.durability import history_equal
from murmura_tpu_torch.analysis.lint import Finding

SERVE_CHECK_FAMILIES, _family = family_registry()


def tenant_raw(seed: int, rounds: int = 3, rule: str = "fedavg") -> Dict[str, Any]:
    """One tenant's config: the tiny cell at ``seed``."""
    raw = base_raw(f"serve-probe-{seed}", rule, rounds=rounds, seed=seed)
    raw["aggregation"] = {"algorithm": rule}
    return raw


def grid_raw() -> Dict[str, Any]:
    return {**tenant_raw(seed=7, rounds=2),
            "grid": {"rules": ["fedavg", "median", "krum"], "attacks": ["gaussian"],
                     "topologies": ["dense"], "strengths": [0.0, 1.0], "seeds": [7]}}


def _kernel_counts() -> Dict[str, int]:
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    out: Dict[str, int] = {}
    for mod in (agg_kernels, candidate_kernels, sketch_kernels):
        for d in (mod.LAUNCHES, mod.PLAIN_CALLS):
            for k, v in d.items():
                out[k] = out.get(k, 0) + v
    return out


def program_description(program, rule: str, attack: str) -> Tuple:
    """A round program's structure, read off the program itself: its
    stages over one round (with the names of the ``rule`` and the
    ``attack`` it was built for on theirs), its carried state, flat and
    data as (name, shape, dtype), and the kernels the round reached."""
    import numpy as np
    import torch

    from murmura_tpu_torch.analysis.composition import recorded_stages
    from murmura_tpu_torch.core.rounds import STAGE_AGGREGATE, STAGE_EXCHANGE, round_generators

    n, dev = program.num_nodes, program.device
    if program.sparse:
        adj = torch.ones((len(program.sparse_offsets), n), device=dev)
    else:
        adj = torch.from_numpy(np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)).to(dev)
    kw = {"alive": torch.ones(n, device=dev)} if program.faulted else {}
    before = _kernel_counts()
    stages: List[str] = []
    with recorded_stages(stages):
        program.train_step(program.init_flat, dict(program.init_agg_state), adj,
                           torch.zeros(n, device=dev), 0.0,
                           generators=round_generators(0, 0, dev), **kw)
    after = _kernel_counts()
    named = {STAGE_EXCHANGE: attack, STAGE_AGGREGATE: rule}
    stage_list = tuple(f"{s}:{named[s]}" if named.get(s) else s for s in stages)
    if STAGE_AGGREGATE not in stages:
        stage_list += (f"rule:{rule}",)

    def spec(t):
        return (tuple(t.shape), str(t.dtype))

    state = tuple(sorted((k, *spec(v)) for k, v in program.init_agg_state.items()))
    data = tuple(sorted((k, *spec(v)) for k, v in program.data.items()))
    kernels = tuple(sorted(k for k in after if after[k] > before.get(k, 0)))
    return (stage_list, ("flat", *spec(program.init_flat)), state, data,
            tuple(program.sparse_offsets), kernels)


def bucket_key_findings(buckets, describe) -> List[Finding]:
    """MUR1600 over planned ``buckets`` and a cell -> description function."""
    path, line = anchor("serve/scheduler.py", "def plan_grid")
    findings: List[Finding] = []
    seen: Dict[Tuple, str] = {}
    for bucket in buckets:
        descriptions = {cell.cell_id: describe(cell) for cell in bucket.cells}
        first = next(iter(descriptions.values()))
        for cell_id, d in descriptions.items():
            if d != first:
                findings.append(Finding(
                    "MUR1600", path, line,
                    f"cell {cell_id} describes a round program different from "
                    f"its bucket {bucket.key}'s other cells — the bucket would "
                    "run the wrong program for it",
                ))
        prior = seen.get(first)
        if prior is not None:
            findings.append(Finding(
                "MUR1600", path, line,
                f"buckets {prior} and {bucket.key} hold cells with equal round "
                "programs — cells of one program must share a bucket",
            ))
        seen[first] = bucket.key
    return findings


@_family
def check_bucket_key_soundness(device) -> List[Finding]:
    """MUR1600: same bucket <=> equal independently built descriptions."""
    from murmura_tpu_torch.config.schema import Config, GridConfig
    from murmura_tpu_torch.serve.scheduler import cell_program, plan_grid

    config = Config.model_validate(grid_raw())
    g = config.grid or GridConfig()
    return bucket_key_findings(
        plan_grid(config, g),
        lambda cell: program_description(cell_program(config, g, cell, device=device),
                                         cell.rule, cell.attack))


@_family
def check_admission_recompile(device) -> List[Finding]:
    """MUR1601: generation 2 admitted into a warm bucket builds nothing."""
    from murmura_tpu_torch.analysis.cells import build_gang
    from murmura_tpu_torch.analysis.sanitizers import track_compiles
    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.core.gang import GangMember
    from murmura_tpu_torch.utils.factories import build_gang_member_programs

    path, line = anchor("core/gang.py", "def _admit_members")
    raw = tenant_raw(seed=7, rounds=2)
    raw["sweep"] = {"members": [{"seed": 7, "lr": 0.05}]}
    gang = build_gang(raw, device, min_batch=4)
    gang.train(rounds=2, eval_every=1)
    gen2 = [GangMember(seed=21, lr=0.05), GangMember(seed=22, lr=0.02)]
    progs = []
    for m in gen2:
        t_raw = tenant_raw(seed=m.seed, rounds=2)
        t_raw["training"]["lr"] = m.lr
        progs.append(build_gang_member_programs(Config.model_validate(t_raw), [m],
                                                device=device)[0])
    with track_compiles() as tracker:
        gang.reset_run(gen2, member_programs=progs)
        gang.train(rounds=2, eval_every=1)
    if not tracker.total:
        return []
    return [Finding(
        "MUR1601", path, line,
        f"admitting generation 2 into a warm bucket built {tracker.total} "
        "program(s) or kernel(s) — admission must be a value-only splice "
        "into the gang's lanes",
    )]


@_family
def check_frozen_lane_interference(device) -> List[Finding]:
    """MUR1602: freezing a lane leaves the survivor bit-equal to a gang that
    never had the neighbour."""
    from murmura_tpu_torch.analysis.cells import build_gang

    path, line = anchor("core/gang.py", "def freeze_member")
    raw = tenant_raw(seed=7, rounds=3)
    raw["sweep"] = {"members": [{"seed": 7, "lr": 0.05}, {"seed": 8, "lr": 0.05}]}
    pair = build_gang(raw, device)
    pair.train(rounds=1, eval_every=1)
    pair.freeze_member(1, "mur1602-probe")
    pair.train(rounds=2, eval_every=1)
    solo_raw = tenant_raw(seed=7, rounds=3)
    solo_raw["sweep"] = {"members": [{"seed": 7, "lr": 0.05}]}
    solo = build_gang(solo_raw, device, min_batch=2)
    solo.train(rounds=3, eval_every=1)
    return frozen_lane_findings(pair.histories, solo.histories[0], path, line)


def frozen_lane_findings(pair_histories, solo_history, path, line) -> List[Finding]:
    findings: List[Finding] = []
    if not history_equal(pair_histories[0], solo_history):
        diverged = sorted(k for k in set(pair_histories[0]) | set(solo_history)
                          if not history_equal(pair_histories[0].get(k), solo_history.get(k)))
        findings.append(Finding(
            "MUR1602", path, line,
            f"survivor history diverges from the unadmitted reference in "
            f"{diverged} after freezing the neighbour lane — eviction must "
            "not perturb co-tenants",
        ))
    frozen_len = len(pair_histories[1].get("round", []))
    if frozen_len > 1:
        findings.append(Finding(
            "MUR1602", path, line,
            f"frozen lane kept recording ({frozen_len} rounds after a freeze "
            "at round 1) — freeze_member must stop the lane's history",
        ))
    return findings


def serve_daemon(state: Path, device):
    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.serve.daemon import ServeDaemon

    cfg = Config.model_validate({
        **tenant_raw(seed=0, rounds=3),
        "serve": {"state_dir": str(state), "capacity": 2, "checkpoint_every": 1},
    })
    return ServeDaemon(cfg, device=device)


@_family
def check_resume_completeness(device) -> List[Finding]:
    """MUR1603: kill the daemon mid-generation, recover a fresh one from the
    same state_dir: every submission terminal, histories bit-equal to an
    uninterrupted daemon's."""
    import murmura_tpu_torch.core.gang as gang_mod
    from murmura_tpu_torch.serve.daemon import TERMINAL_STATES

    path, line = anchor("serve/daemon.py", "def recover")
    findings: List[Finding] = []
    tmp = Path(tempfile.mkdtemp(prefix="murmura-serve-check-"))
    try:
        ref = serve_daemon(tmp / "ref", device)
        ref.submit_config(tenant_raw(seed=5))
        ref.submit_config(tenant_raw(seed=6))
        ref.drain()

        victim = serve_daemon(tmp / "crash", device)
        victim.submit_config(tenant_raw(seed=5))
        victim.submit_config(tenant_raw(seed=6))

        class _Kill(BaseException):
            """Out-of-band like a real SIGKILL: no handler catches it."""

        orig_train = gang_mod.GangNetwork.train

        def dying_train(self, rounds, **kw):
            orig_train(self, rounds=1, **kw)  # round 1 + its snapshot
            raise _Kill()

        gang_mod.GangNetwork.train = dying_train
        try:
            victim.drain()
        except _Kill:
            pass
        finally:
            gang_mod.GangNetwork.train = orig_train
        victim.close()
        del victim

        revived = serve_daemon(tmp / "crash", device)
        revived.recover()
        revived.drain()
        revived.close()
        ref.close()
        for (rid, ref_rec), (vid, rec) in zip(sorted(ref._ledger.items()),
                                              sorted(revived._ledger.items())):
            if rec["state"] not in TERMINAL_STATES:
                findings.append(Finding(
                    "MUR1603", path, line,
                    f"submission {vid} is still '{rec['state']}' after daemon "
                    "kill + recover + drain — every submitted run must reach a "
                    "terminal state",
                ))
            elif rec["state"] != "done":
                findings.append(Finding(
                    "MUR1603", path, line,
                    f"submission {vid} recovered to '{rec['state']}' "
                    f"({rec.get('error')}) — the interrupted generation did not "
                    "resume",
                ))
            elif not history_equal(rec.get("history"), ref_rec.get("history")):
                findings.append(Finding(
                    "MUR1603", path, line,
                    f"submission {vid} resumed to a history diverging from the "
                    f"uninterrupted reference {rid} — the recovered generation "
                    "is not crash-equivalent",
                ))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return findings


def check_serve(device="cuda") -> List[Finding]:
    """MUR1600-1603."""
    return run_families(SERVE_CHECK_FAMILIES, "MUR1600", __file__, device)
