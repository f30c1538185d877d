"""Gang-batched multi-seed execution (the PyTorch counterpart of
murmura_tpu/core/gang.py).

A gang runs S experiments that differ in seed, and optionally in learning
rate and attack intensity, side by side on one device, with one history a
member.  The JAX package ``vmap``s the whole round over a member axis.  The
port cannot: its kernels are ``ctypes`` calls on ``data_ptr()``, which
``torch.func.vmap`` cannot batch through.  So a gang round has two stages:

1. **Training and eval, one pass over all members.**  The members are
   folded into the node axis: S members x N nodes are S*N rows, trained by
   one ``RoundProgram.train_rows`` call over the members' stacked data and
   evaluated by one ``eval_step``.  Each member draws its shuffle keys and
   dropout masks from its own ``round_generators(seed, round)``, in the
   order its single run draws them, so the draws are bit-equal to the
   single runs'.  A member's learning rate becomes a per-row factor.
2. **The exchange and the rule, a loop over members.**  Each member's
   trained rows go to its own ``train_step(..., trained=rows)``: the
   sentinels, the attack (its noise from the member's generator), the
   codec, the stale fold and the rule on that member's [N, P] rows and
   carried state.  Every kernel of the rule launches once a member.

The attack's compromised placement is one set for the whole gang, seeded
by ``attack.params.seed`` (default: the base experiment seed), so a single
run with that seed pinned reproduces a member.  The topology, the mobility
model, the fault schedule and the per-round adjacency (G^t under mobility,
or the sparse edge mask) are shared.  Under DMTT each member carries its
own trust state (``DMTT_STATE_KEYS`` in its carried state), makes its own
topology claims and cross-evaluates the broadcast on its own probe rows,
inside its own ``train_step``: nothing of one member's trust reaches
another's.

The JAX package pads the member axis to a power of two (``next_bucket``)
so that XLA compiles a few shapes; the port compiles nothing a round and
runs no padding lanes.  It reports the same ``batch`` (the lane count the
JAX gang would compile, ``min_batch`` pre-growing it), so manifests and
metrics agree, and trains the members' rows alone.

Over a param group (``tpu.param_shards`` > 1, parallel/mesh.py) every
rank runs the same gang on its own node rows of every member: the
carried parameters are an ``[S, R_r, P_pad]`` stack.  Rank r trains its
S * R_r rows in the one ``train_rows`` call, each member's draws taken
whole from its own generators and cut to the rank's rows (as a single
group round cuts them); one ``rows_to_columns`` turns the whole trained
stack into the members' ``[N, P_pad / W]`` column blocks (the members
become another row block: one all_to_all for every member, where a loop
of single rounds would make S), the member loop runs the exchange and
the rule on each member's block, one ``columns_to_rows`` turns the new
blocks back, and eval's metrics are gathered over the group.  Every rank
keeps the same histories; rank 0 alone writes telemetry and snapshots,
the snapshot gathered into the ordinary ``[S, N, P]`` layout with
``param_shards`` in its meta.

Over a seed group (the JAX package's ("seed", "nodes") gang mesh laid
seed-major; parallel/mesh.py ``SeedGroup``) rank r holds the members
``block(S, W, r)``, each whole, and runs them as the ordinary gang above:
their data, initial parameters, draws and programs are the rank's alone
(``programs`` are the block's; an empty block keeps one ``template``
program for the shapes and runs nothing).  Members are independent
experiments, so no collective runs inside a round.  After each chunk the
ranks gather the members' metric rows, so that every rank records every
member's history in the one-process gang's order (so that the frontier
and the grid read the same curves on every rank); a member's
telemetry writer lives on the rank that trains it.  A snapshot gathers the
members' ``[S_r, N, P]`` stacks to rank 0, which writes the one-process
gang's snapshot byte for byte; a restore cuts each rank's block out, so a
snapshot written at one W restores at any other.

A member's learning rate and attack scale are values the gang passes to
its programs each round, so :meth:`GangNetwork.reset_run` can change them
without building a program: the stage reset (the frontier's) returns
every member to its round-0 state, and re-tenanting (the grid's and the
serve daemon's admission, ``member_programs``) splices a new generation's
values into the lanes: each member's RoundProgram (its data rows, initial
parameters, carried state and the closures built from its seed), its seed,
lr and attack scale.  The gang's step and its chunk programs stay; no
chunk program is built and no kernel compiled.  :meth:`freeze_member`
stops recording one lane while it keeps computing, as the JAX package's
vmap lane does.  A serving gang (``boundary_freezes``, the serve daemon's)
takes the freezes requested from another thread (:meth:`request_freeze`)
at its chunk boundaries instead, before the chunk's rows are recorded: over
a group rank 0's requests are broadcast there, so that every rank freezes
the same lanes before the same round.
"""

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from murmura_tpu_torch.analysis.sanitizers import (
    RecompileError,
    note_program_build,
    transfer_sanitizer,
)
from murmura_tpu_torch.core.network import (
    _host_rows,
    check_exchange_layout,
    check_snapshot_shards,
    empty_history,
    record_round_metrics,
    stage_rounds,
    static_exchange_input,
)
from murmura_tpu_torch.core.rounds import (
    EVAL_DATA_KEYS,
    STAGE_TRAIN,
    TRAIN_DATA_KEYS,
    RoundProgram,
    round_generators,
)
from murmura_tpu_torch.ops import _build
from murmura_tpu_torch.parallel.mesh import (
    SeedGroup,
    barrier,
    broadcast_object,
    columns_to_rows,
    gather_columns,
    gather_objects,
    gather_rows,
    refuse_transfer_guard_across_processes,
    rows_to_columns,
)
from murmura_tpu_torch.utils.checkpoint import committed_bytes


# Copy of next_bucket, GangMember, resolve_members and gang_hp_inputs from
# murmura_tpu/core/gang.py.
def next_bucket(size: int) -> int:
    """Smallest power of two >= size: the JAX gang's compile-shape bucket."""
    if size < 1:
        raise ValueError(f"gang size must be >= 1, got {size}")
    b = 1
    while b < size:
        b *= 2
    return b


@dataclass(frozen=True)
class GangMember:
    """One experiment of the gang: a seed plus optional hyperparameter
    overrides."""

    seed: int
    lr: Optional[float] = None
    attack_scale: Optional[float] = None

    @property
    def label(self) -> str:
        parts = [f"seed_{self.seed}"]
        if self.lr is not None:
            parts.append(f"lr_{self.lr:g}")
        if self.attack_scale is not None:
            parts.append(f"atk_{self.attack_scale:g}")
        return "-".join(parts)


def resolve_members(config, seeds: Optional[Sequence[int]] = None) -> List[GangMember]:
    """The gang's member list from ``config.sweep`` (or an explicit seed
    list: the CLI's ``--seeds``).

    ``noise_std`` member overrides are resolved here into the
    ``attack_scale`` multiplier (scale = noise_std / the configured
    gaussian noise_std), so the round program needs only one knob.
    """
    def _distinct(members: List[GangMember]) -> List[GangMember]:
        # Member labels key the sweep output JSON and the per-member
        # telemetry run dirs: a duplicate would silently collapse one
        # member's results onto another's.
        labels = [m.label for m in members]
        if len(labels) != len(set(labels)):
            raise ValueError(
                f"sweep members are not distinct (labels: {labels}) — two "
                "identical members would just duplicate work"
            )
        return members

    if seeds is not None:
        return _distinct([GangMember(seed=int(s)) for s in seeds])
    sweep = config.sweep
    if sweep is None:
        raise ValueError("config has no sweep block and no explicit seeds")
    if sweep.seeds is not None:
        return _distinct([GangMember(seed=int(s)) for s in sweep.seeds])
    if sweep.num_seeds is not None:
        base = config.experiment.seed
        return [GangMember(seed=base + i) for i in range(sweep.num_seeds)]
    p = config.attack.params
    base_noise = float(p.get("noise_std", p.get("std", 10.0)))
    members = []
    for m in sweep.members:
        scale = m.attack_scale
        if m.noise_std is not None:
            if base_noise <= 0:
                raise ValueError(
                    "sweep member noise_std override needs a positive "
                    "attack.params.noise_std to scale against"
                )
            scale = m.noise_std / base_noise
        members.append(GangMember(
            seed=int(m.seed if m.seed is not None else config.experiment.seed),
            lr=m.lr,
            attack_scale=scale,
        ))
    return _distinct(members)


def gang_hp_inputs(members: Sequence[GangMember]) -> Tuple[str, ...]:
    """The hyperparameters some member overrides: with ``lr`` every member
    trains with a per-row learning rate, with ``attack_scale`` every
    member's program scales its attack's perturbation (by 1.0 where the
    member sets none), as in the JAX package.  A seed-only gang lifts none
    and its members run the single runs' arithmetic."""
    hp = []
    if any(m.lr is not None for m in members):
        hp.append("lr")
    if any(m.attack_scale is not None for m in members):
        hp.append("attack_scale")
    return tuple(hp)


def check_member_compatible(progs: Sequence[RoundProgram], members) -> None:
    """Refuse member programs that cannot train as one stack: the gang
    trains every member with member 0's schedule (the step count, the batch
    width) over the members' stacked data, so every shape must agree, or a
    member would silently train differently than its single run."""
    base = progs[0]

    def shapes(prog):
        return {k: (tuple(v.shape), v.dtype) for k, v in prog.data.items()}

    base_shapes = shapes(base)
    for i, prog in enumerate(progs[1:], start=1):
        label = members[i].label
        if prog.num_nodes != base.num_nodes or prog.model_dim != base.model_dim:
            raise ValueError(
                f"gang member {label}: num_nodes/model_dim mismatch with "
                "member 0 — members must share the network and model shape"
            )
        got = shapes(prog)
        if got != base_shapes:
            diff = sorted(k for k in set(got) | set(base_shapes)
                          if got.get(k) != base_shapes.get(k))
            raise ValueError(
                f"gang member {label}: data arrays differ from member 0's "
                f"in {diff} — per-seed partitions must produce identical "
                "shapes to train as one stack (pin training.max_samples or "
                "use an equal-shard partitioner)"
            )
        for k in ("steps", "eff_batch"):
            if int(prog.data[k].max()) != int(base.data[k].max()):
                raise ValueError(
                    f"gang member {label}: batch schedule (max {k}) differs "
                    "from member 0's — the stacked training would silently "
                    "truncate this member's; equalize per-node sample counts "
                    "across seeds"
                )


def build_gang_step(lanes: Dict[str, Any], compromised: torch.Tensor, knobs: dict):
    """One gang round over the [S, N, P] stack:

        step(flats, agg_states, adj, round_idx, alive=None, draws=None)
            -> (flats', agg_states', [metrics of each member])

    Training folds the members into S*N rows (one ``train_rows`` over the
    stacked data, each member's draws from its own generators); the
    exchange and the rule run member by member (``train_step(...,
    trained=rows)``).  Over a param group ``flats`` is the rank's [S, R_r,
    P_pad] stack, and the members' trained rows (with the pre-round rows
    on a faulted program) turn to column blocks in one ``rows_to_columns``
    and back in one ``columns_to_rows`` (the module docstring).  ``lanes`` is read every round: its ``programs`` (one
    RoundProgram a member), ``seeds`` and ``data`` (the members' data
    stacked on the node axis), which re-tenanting replaces.  ``knobs`` too:
    its ``step_lr`` the [S*N] per-row learning rate (None: the programs'
    own) and its ``attack_scales`` one scale a member (None: the programs'
    own).  ``draws`` (tests) injects one dict a member of what its
    generators would draw, in ``train_step``'s layout."""

    def stacked_draws(draws):
        """The members' training draws as the stack's: each epoch's ``u``
        and each step's dropout masks concatenated in member order."""
        if draws is None:
            return None
        out = {}
        if draws[0].get("u") is not None:
            out["u"] = [np.concatenate([np.asarray(d["u"][e]) for d in draws])
                        for e in range(len(draws[0]["u"]))]
        if draws[0].get("dropout") is not None:
            out["dropout"] = [
                [[np.concatenate([np.asarray(d["dropout"][e][t][l]) for d in draws])
                  for l in range(len(step_masks))]
                 for t, step_masks in enumerate(epoch)]
                for e, epoch in enumerate(draws[0]["dropout"])
            ]
        return out

    def step(flats, agg_states, adj, round_idx, alive=None, draws=None):
        programs, seeds = lanes["programs"], lanes["seeds"]
        prog0 = programs[0]
        group = prog0.group
        s_count, rows, p = flats.shape
        own = slice(None) if group is None else slice(*group.rows)
        gens = [round_generators(seed, round_idx, prog0.device) for seed in seeds]
        train_mask = torch.cat([prog.training_mask(compromised, alive)[own]
                                for prog in programs])
        with record_function(STAGE_TRAIN):
            trained = prog0.train_rows(
                flats.reshape(s_count * rows, p).clone(), train_mask, float(round_idx),
                [g["train"] for g in gens], data=lanes["data"], step_lr=knobs["step_lr"],
                draws=stacked_draws(draws),
            ).reshape(s_count, rows, p)
        pre = flats
        if group is not None:
            # One turn for every member's trained rows, and for the
            # pre-round rows that a faulted round's guards read.
            stack = torch.cat([trained, flats]) if prog0.faulted else trained
            cols = rows_to_columns(stack, group)
            trained, pre = cols[:s_count], (cols[s_count:] if prog0.faulted
                                            else [None] * s_count)
        scales = knobs["attack_scales"]
        outs, states, metrics = [], [], []
        for s, prog in enumerate(programs):
            noise = None if draws is None else {"noise": draws[s].get("noise")}
            new_flat, state, m = prog.train_step(
                pre[s], agg_states[s], adj, compromised, float(round_idx),
                generators=gens[s], draws=noise, alive=alive, trained=trained[s],
                attack_scale=None if scales is None else scales[s],
            )
            outs.append(new_flat)
            states.append(state)
            metrics.append(m)
        new = torch.stack(outs)
        if group is not None:
            new = columns_to_rows(new, group)
            if prog0.flat_dim > prog0.model_dim:
                # The pad stays exact zeros, as a single round keeps it.
                new[:, :, prog0.model_dim:] = 0
        return new, states, metrics

    return step


def build_gang_multi_round(step, lanes: Dict[str, Any], chunk: int, eval_every: int):
    """Fuse ``chunk`` gang rounds into one call (the gang's
    ``build_multi_round``):

        multi_round(flats, agg_states, adj_stack, round0, alive_stack=None)
            -> (flats', agg_states', rows)

    ``rows`` holds one (round number, [metrics of each member]) pair per
    round on the ``eval_every`` cadence, the metrics left on the device;
    eval runs once over all S*N rows of ``lanes``' data (over a param
    group, each rank's S*R_r, the metrics gathered).  Nothing here
    synchronises with the host."""
    note_program_build()

    def multi_round(flats, agg_states, adj_stack, round0, alive_stack=None):
        rows = []
        for i in range(chunk):
            r = round0 + i
            flats, agg_states, metrics = step(
                flats, agg_states, adj_stack[i], r,
                None if alive_stack is None else alive_stack[i],
            )
            if (r + 1) % eval_every == 0:
                s_count, own_rows, p = flats.shape
                prog0 = lanes["programs"][0]
                n = prog0.num_nodes
                ev = prog0.eval_step(flats.reshape(s_count * own_rows, p),
                                     data=lanes["data"], members=s_count)
                rows.append((r + 1, [
                    {**{k: v[s * n:(s + 1) * n] for k, v in ev.items()}, **metrics[s]}
                    for s in range(s_count)
                ]))
        return flats, agg_states, rows

    return multi_round


class GangNetwork:
    """Orchestrates S experiments as one gang: the counterpart of
    :class:`~murmura_tpu_torch.core.network.Network` with one history, one
    telemetry writer (optional) and one carried state a member.  Rounds run
    per round or fused into chunks (``rounds_per_dispatch``) exactly as a
    single run's, under the same ``transfer_guard`` and ``recompile_guard``
    (core/network.py's docstring), and the whole gang snapshots and resumes
    through durability/snapshot.py.

    Args:
        programs: one RoundProgram a member, each built with that member's
            seed (its data, initial parameters) and learning rate.
        members: the resolved member list.
        topology / attack / fault_schedule / mobility: shared by the members
            (``mobility``: a MobilityModel whose G^t is each round's graph).
        base_lr: the learning rate of a member without an override.
        telemetry_writers: one TelemetryWriter a member, or None.
        retain_init: keep host copies of the round-0 parameters and carried
            state for :meth:`reset_run`.
        min_batch / bucket: the reported ``batch``, the JAX gang's compiled
            lane count, ``next_bucket(max(S, min_batch))`` (``S`` without
            ``bucket``); re-tenanting admits 1..batch members.  No lane
            beyond the members' runs.
        seed_group: this rank's SeedGroup, or None: ``programs`` (and
            ``telemetry_writers``) are then those of the rank's members
            ``seed_group.members()`` of ``members``, and ``template`` the
            program whose shapes an empty block takes.
    """

    def __init__(
        self,
        programs: Sequence[RoundProgram],
        members: Sequence[GangMember],
        topology,
        attack=None,
        fault_schedule=None,
        base_lr: float = 0.01,
        transfer_guard: bool = False,
        recompile_guard: bool = False,
        telemetry_writers: Optional[Sequence] = None,
        retain_init: bool = False,
        min_batch: int = 1,
        bucket: bool = True,
        mobility=None,
        seed_group: Optional[SeedGroup] = None,
        template: Optional[RoundProgram] = None,
    ):
        if not members:
            raise ValueError("a gang needs at least one member")
        self.seed_group = None if seed_group is None else seed_group.bind(len(members))
        self._block = (0, len(members)) if self.seed_group is None else self.seed_group.members()
        local = list(members)[slice(*self._block)]
        if len(programs) != len(local):
            raise ValueError("one RoundProgram per member required")
        if programs:
            check_member_compatible(programs, local)
        elif template is None:
            raise ValueError("a rank that holds no member needs a template program")
        program = programs[0] if programs else template
        self._template = program
        check_exchange_layout(program, topology)
        if mobility is not None and program.sparse:
            raise ValueError(
                "sparse exchange mode does not compose with mobility (G^t is a dense "
                "per-round graph)"
            )
        n = program.num_nodes
        if topology.num_nodes != n:
            raise ValueError(f"Topology has {topology.num_nodes} nodes, gang stack has {n}")
        self.group = program.group
        refuse_transfer_guard_across_processes(self.group or seed_group, transfer_guard)
        if self.group is not None and self.group.staged and transfer_guard:
            raise ValueError(
                "tpu.transfer_guard does not compose with a gloo param group on CUDA "
                "tensors: its all_to_all is staged through host memory every round")
        if fault_schedule is not None and not program.faulted:
            raise ValueError(
                "A fault schedule was supplied but the round programs were built "
                "without faults (build_round_program(faults=...))"
            )
        self.members = list(members)
        self.gang_size = len(members)
        self.batch = next_bucket(max(self.gang_size, min_batch)) if bucket else self.gang_size
        self.topology = topology
        self.mobility = mobility
        self.attack = attack
        self.fault_schedule = fault_schedule
        self.device = program.device
        self.transfer_guard = transfer_guard
        self.recompile_guard = recompile_guard
        self.telemetry = list(telemetry_writers or [])
        if self.telemetry and len(self.telemetry) != len(local):
            raise ValueError("one telemetry writer per member required")

        # One placement for the whole gang (the module docstring).
        self.compromised = (attack.compromised.astype(np.float32) if attack is not None
                            else np.zeros(n, dtype=np.float32))
        self._comp = torch.as_tensor(self.compromised).to(self.device)
        # What the gang step reads every round, which re-tenanting replaces.
        self._lanes: Dict[str, Any] = {}
        self._retain_init = retain_init
        self._init_host = None
        self._set_lanes(programs)
        self._base_lr = base_lr
        self._hp = gang_hp_inputs(members)
        self._knobs: Dict[str, Any] = {}
        self._set_knobs(self._local(self.members))
        self._step = build_gang_step(self._lanes, self._comp, self._knobs)
        self._fused: Dict[Tuple[int, int], Any] = {}
        # Chunk programs built (one a (chunk, eval_every) key); a stage
        # reset builds none.
        self.program_builds = 0
        self._warmed: set = set()
        static = static_exchange_input(topology, fault_schedule, mobility)
        self._static_host = static
        self._static_adj = None if static is None else torch.as_tensor(static).to(self.device)
        self._in_degree: Dict[int, np.ndarray] = {}
        self.histories: List[Dict[str, List[Any]]] = [
            empty_history() for _ in range(self.gang_size)]
        self._last_stats: List[Dict[str, np.ndarray]] = [{} for _ in range(self.gang_size)]
        self.round_times: List[float] = []
        self.current_round = 0
        self.checkpoints: List[Dict[str, Any]] = []
        # freeze_member: a frozen lane keeps computing and stops recording.
        self.member_active: List[bool] = [True] * self.gang_size
        # request_freeze: (lane, reason) pairs taken at the next chunk
        # boundary where boundary_freezes is set (on every rank alike).
        self.boundary_freezes = False
        self._freeze_lock = threading.Lock()
        self._freeze_queue: List[Tuple[int, str]] = []

    @property
    def programs(self) -> List[RoundProgram]:
        """The RoundPrograms of the members this process trains."""
        return self._lanes["programs"]

    @property
    def program(self) -> RoundProgram:
        progs = self._lanes["programs"]
        return progs[0] if progs else self._template

    def _local(self, members: Sequence) -> list:
        """This rank's part of a whole-gang member list (all of it outside
        a seed group)."""
        return list(members)[slice(*self._block)]

    @property
    def _data(self) -> Dict[str, torch.Tensor]:
        return self._lanes["data"]

    def _set_lanes(self, programs: Sequence[RoundProgram]) -> None:
        """Make ``programs`` the lanes' value sources: their seeds, their
        data stacked on the node axis (each member's rank rows over a param
        group), their round-0 parameters and carried state (with host
        copies where ``retain_init`` asked for them)."""
        group = self._template.group
        own = slice(None) if group is None else slice(*group.rows)
        self._lanes.update(
            programs=list(programs), seeds=[m.seed for m in self._local(self.members)],
            data={k: torch.cat([p.data[k][own] for p in programs])
                  for k in TRAIN_DATA_KEYS + EVAL_DATA_KEYS} if programs else {})
        if programs:
            self.flats = torch.stack([p.init_flat for p in programs])  # [S, N, P]
        else:
            t = self._template.init_flat
            self.flats = t.new_empty((0,) + tuple(t.shape))
        self.agg_states: List[Dict[str, torch.Tensor]] = [
            dict(p.init_agg_state) for p in programs]
        if self._retain_init:
            # The round-0 state a stage reset returns to, on the host.
            self._init_host = (self.flats.cpu().clone(),
                               [{k: v.cpu().clone() for k, v in st.items()}
                                for st in self.agg_states])

    # The snapshot's view of the gang (durability/snapshot.py): the members'
    # parameters as one [S, N, P] tensor, their carried states stacked key
    # by key, and the member seeds.

    @property
    def flat(self) -> torch.Tensor:
        return self.flats

    @flat.setter
    def flat(self, value: torch.Tensor) -> None:
        self.flats = value

    @property
    def agg_state(self) -> Dict[str, torch.Tensor]:
        if not self.agg_states:
            return {k: v.new_empty((0,) + tuple(v.shape))
                    for k, v in self._template.init_agg_state.items()}
        return {k: torch.stack([st[k] for st in self.agg_states]) for k in self.agg_states[0]}

    @agg_state.setter
    def agg_state(self, stacked: Dict[str, torch.Tensor]) -> None:
        self.agg_states = [{k: v[s] for k, v in stacked.items()}
                           for s in range(self.flats.shape[0])]

    @property
    def seed(self) -> List[int]:
        return [m.seed for m in self.members]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _set_knobs(self, members: Sequence[GangMember]) -> None:
        """The per-member values the gang step reads every round (of this
        rank's ``members``): the [S*N] learning rates where some member
        overrides lr, the attack scales (1.0 where a member sets none) where
        some member overrides attack_scale; None leaves the programs'
        own."""
        n = self.flats.shape[1]  # the rows of a member (a rank's, over a group)
        step_lr = scales = None
        if "lr" in self._hp:
            lrs = [m.lr if m.lr is not None else self._base_lr for m in members]
            step_lr = torch.as_tensor(np.repeat(np.asarray(lrs, np.float32), n)).to(self.device)
        if "attack_scale" in self._hp:
            scales = [m.attack_scale if m.attack_scale is not None else 1.0 for m in members]
        self._knobs.update(step_lr=step_lr, attack_scales=scales)

    def reset_run(self, members: Sequence[GangMember], member_programs=None,
                  telemetry_writers=None) -> None:
        """A value-only reset for a fresh run over the gang's step and chunk
        programs: the next ``train`` builds none.  Two modes, as in the JAX
        package:

        - **Stage reset** (``member_programs=None``, the frontier's): the
          same seeds, new learning rates and attack scales, every member
          back at round 0 from the host copies kept by ``retain_init``.
          Only the values the gang lifted (``gang_hp_inputs`` at
          construction) can change.
        - **Re-tenanting** (``member_programs`` given, the grid's and the
          serve daemon's admission): 1..``batch`` new members, each with
          its own RoundProgram (``build_gang_member_programs``), spliced
          into the lanes (:meth:`_admit_members`).
        """
        if member_programs is not None:
            self._admit_members(members, member_programs, telemetry_writers)
            return
        if telemetry_writers is not None:
            raise ValueError(
                "reset_run(telemetry_writers=...) is only meaningful on the "
                "re-tenanting path (member_programs given) — a stage reset keeps "
                "the gang's writers"
            )
        if self._init_host is None:
            raise ValueError(
                "reset_run() needs the gang built with retain_init=True (the "
                "stacked host init arrays are the reset source)"
            )
        members = list(members)
        if len(members) != self.gang_size:
            raise ValueError(
                f"reset_run got {len(members)} members for a gang of {self.gang_size} — "
                "the bucket shape must not change (that is the whole point of the reset)"
            )
        for i, (old, new) in enumerate(zip(self.members, members)):
            if new.seed != old.seed:
                raise ValueError(
                    f"reset_run member {i} changes seed {old.seed} -> {new.seed} — data "
                    "shards and init params were built per original seed; only "
                    "lr/attack_scale may vary across stages"
                )
        labels = [m.label for m in members]
        if len(labels) != len(set(labels)):
            raise ValueError(f"reset_run members are not distinct (labels: {labels})")
        self.members = members
        self._set_knobs(self._local(members))
        flats, states = self._init_host
        self.flats = flats.to(self.device)
        self.agg_states = [{k: v.to(self.device) for k, v in st.items()} for st in states]
        self._clear_run()

    def _clear_run(self) -> None:
        self.histories = [empty_history() for _ in range(self.gang_size)]
        self._last_stats = [{} for _ in range(self.gang_size)]
        self._in_degree.clear()
        self.round_times = []
        self.current_round = 0
        self.member_active = [True] * self.gang_size

    def _admit_members(self, members: Sequence[GangMember],
                       member_programs: Sequence[RoundProgram],
                       telemetry_writers: Optional[Sequence]) -> None:
        """The re-tenanting half of :meth:`reset_run`: a new generation of
        1..``batch`` members (new seeds allowed, duplicate labels allowed:
        serve tenants are told apart by submission id) takes the lanes.
        Their programs must be gang-compatible with the template's (the
        construction check); each brings its data rows, round-0 parameters
        and carried state and its seed's closures, and the gang's lifted
        lr and attack scale become the new members'.  The gang's step and
        chunk programs are kept: nothing is built.  Over a seed group
        ``member_programs`` (and the writers) are the rank's block of the
        new generation."""
        members = list(members)
        progs = list(member_programs)
        block = (0, len(members))
        if self.seed_group is not None:
            block = self.seed_group.bind(len(members)).members()
        if len(progs) != block[1] - block[0]:
            raise ValueError("one RoundProgram per admitted member required")
        if not 1 <= len(members) <= self.batch:
            raise ValueError(
                f"cannot admit {len(members)} members into a bucket of batch {self.batch} — "
                "the compiled shape is fixed; a larger tenant set needs a bigger bucket "
                "(a new compile)"
            )
        # The template (lane 0's program) against every admitted one.
        check_member_compatible([self.program, *progs],
                                [self.members[0], *members[block[0]:block[1]]])
        writers = self.telemetry if telemetry_writers is None else list(telemetry_writers)
        if writers and len(writers) != len(progs):
            raise ValueError(
                f"{len(writers)} telemetry writers for {len(progs)} admitted members — "
                "pass one writer per member (or an empty list) when re-tenanting"
            )
        # An empty block keeps the last program for its shapes.
        self._template = progs[0] if progs else self.program
        if self.seed_group is not None:
            self.seed_group = self.seed_group.bind(len(members))
        self._block = block
        self.members = members
        self.gang_size = len(members)
        self.telemetry = writers
        self._set_lanes(progs)
        self._set_knobs(self._local(members))
        # The new programs make their one-time device copies in their first
        # chunk, as a fresh gang's do (tpu.transfer_guard exempts it).
        self._warmed.clear()
        self._clear_run()
        with self._freeze_lock:
            # Requests for the last generation's lanes.
            self._freeze_queue = []

    def freeze_member(self, member: int, reason: str) -> None:
        """Degrade one lane gracefully: its history freezes at the current
        round and a ``backend_degraded`` event lands in its telemetry; the
        lane keeps computing (as the JAX package's vmap lane does), so the
        surviving members see the same shapes and numbers before and after.
        Idempotent."""
        if not 0 <= member < self.gang_size:
            raise ValueError(f"member {member} out of range for gang of {self.gang_size}")
        if not self.member_active[member]:
            return
        self.member_active[member] = False
        lo, hi = self._block
        if self.telemetry and lo <= member < hi:
            self.telemetry[member - lo].emit("backend_degraded",
                                             member=self.members[member].label,
                                             reason=reason, round=self.current_round)

    def request_freeze(self, member: int, reason: str) -> None:
        """Queue :meth:`freeze_member` of lane ``member`` for the next chunk
        boundary of a gang with ``boundary_freezes`` set (safe from another
        thread; over a group, rank 0's queue is the one taken).  The next
        admission drops what is still queued."""
        with self._freeze_lock:
            self._freeze_queue.append((int(member), str(reason)))

    def _take_freezes(self) -> List[Tuple[int, str]]:
        """The freezes requested since the last boundary: this process's
        queue, over a group rank 0's on every rank (a collective)."""
        with self._freeze_lock:
            queued, self._freeze_queue = self._freeze_queue, []
        group = self.seed_group if self.seed_group is not None else self.group
        if group is not None:
            queued = broadcast_object(queued, group)
        return queued

    # ------------------------------------------------------------------

    def train(
        self,
        rounds: int,
        verbose: bool = False,
        eval_every: int = 1,
        rounds_per_dispatch: int = 1,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
    ) -> List[Dict[str, List[Any]]]:
        """Run the gang for ``rounds`` rounds; returns the member histories
        (``self.histories``).  The arguments are :meth:`Network.train`'s: a
        chunk of ``rounds_per_dispatch`` rounds is staged once and copied
        back once, and ``checkpoint_dir`` snapshots the whole gang (every
        member's parameters, carried state and history) after each chunk
        that crosses a multiple of ``checkpoint_every`` rounds and after
        the last."""
        builds = self.program_builds + len(_build.STARTED)
        try:
            self._train_chunks(rounds, verbose, eval_every, rounds_per_dispatch,
                               checkpoint_dir, checkpoint_every)
        finally:
            # What this call built (chunk programs and nvcc builds): the JAX
            # package's compile count in every member's manifest.
            built = self.program_builds + len(_build.STARTED) - builds
            for t, h in zip(self.telemetry, self._local(self.histories)):
                if built:
                    t.add_counters({"compiles": built})
                t.finalize(history=h)
        return self.histories

    def _train_chunks(self, rounds, verbose, eval_every, rounds_per_dispatch, checkpoint_dir,
                      checkpoint_every) -> None:
        mode = "gang_per_round" if rounds_per_dispatch == 1 else "gang_fused"
        done = 0
        while done < rounds:
            k = min(rounds_per_dispatch, rounds - done)
            key = (k, eval_every)
            if key not in self._fused:
                if self.recompile_guard and key in self._warmed:
                    raise RecompileError(
                        f"tpu.recompile_guard: the gang's fused program for {key} (chunk, "
                        "eval_every) was built again after it had run"
                    )
                self._fused[key] = build_gang_multi_round(self._step, self._lanes, k,
                                                          eval_every)
                self.program_builds += 1
            warmup = key not in self._warmed
            builds = len(_build.STARTED)
            round0 = self.current_round
            t0 = time.perf_counter()
            adj_stack, alive_stack, in_deg = stage_rounds(
                self.topology, self.fault_schedule, self.program, self._static_host,
                self._static_adj, list(range(round0, round0 + k)),
                degrees=bool(self.telemetry), mobility=self.mobility)
            self._in_degree.update(in_deg)
            guard = (transfer_sanitizer() if self.transfer_guard and not warmup
                     and self.device.type == "cuda" else contextlib.nullcontext())
            local = self._block[1] - self._block[0]
            flat_rows = []
            if local:
                with guard:
                    self.flats, self.agg_states, rows = self._fused[key](
                        self.flats, self.agg_states, adj_stack, round0,
                        alive_stack=alive_stack)
                # One device-to-host copy for every member's rows of the chunk.
                flat_rows = _host_rows([(r, m) for r, ms in rows for m in ms])
            self._sync()
            elapsed = time.perf_counter() - t0
            self._warmed.add(key)
            self.current_round = round0 + k
            self.round_times.extend([elapsed / k] * k)
            done += k
            for t in self.telemetry:
                for i in range(k):
                    extra = {"chunk": k} if rounds_per_dispatch > 1 else {}
                    if self.program.pipelined:
                        extra["overlap"] = "pipelined"
                    t.phase_times(round0 + i, mode, elapsed / k, gang=self.gang_size, **extra)
                t.memory_event(self.current_round - 1, self.device)
            evaluated = [r + 1 for r in range(round0, round0 + k) if (r + 1) % eval_every == 0]
            by_round = [[m for _, m in flat_rows[i * local:(i + 1) * local]]
                        for i in range(len(evaluated))]
            if self.seed_group is not None:
                # Every rank records every member, in member order.
                parts = gather_objects(by_round, self.seed_group)
                by_round = [[m for part in parts for m in part[i]]
                            for i in range(len(evaluated))]
            if self.boundary_freezes:
                for member, reason in self._take_freezes():
                    self.freeze_member(member, reason)
            for round_num, member_metrics in zip(evaluated, by_round):
                self._record_all(round_num, member_metrics, verbose)
            if self.recompile_guard and not warmup and len(_build.STARTED) > builds:
                raise RecompileError(
                    f"tpu.recompile_guard: kernel build(s) {_build.STARTED[builds:]} "
                    f"started in rounds {round0}-{round0 + k - 1}, after the first chunk "
                    f"of {key} (chunk, eval_every)"
                )
            crossed = checkpoint_every and (
                self.current_round // checkpoint_every > round0 // checkpoint_every)
            if checkpoint_dir and (crossed or done >= rounds):
                self.save_checkpoint(checkpoint_dir)

    def _record_all(self, round_num: int, member_metrics, verbose: bool) -> None:
        """One evaluated round's per-member metrics into the member
        histories (the single run's ``record_round_metrics``, so a member's
        row is its single run's), with the member-shared in-degree of the
        round's staged graph in each member's telemetry."""
        in_deg = None
        if self.telemetry:
            in_deg = self._in_degree.pop(round_num - 1)
            self._in_degree = {r: v for r, v in self._in_degree.items() if r >= round_num}
        lo, hi = self._block
        for s, metrics in enumerate(member_metrics):
            if not self.member_active[s]:
                # A frozen lane (freeze_member) computed and is not recorded.
                continue
            record_round_metrics(self.histories[s], round_num, metrics, self.compromised,
                                 self.program.evidential, self.attack is not None)
            self._last_stats[s] = {k[len("agg_"):]: v for k, v in metrics.items()
                                   if k.startswith("agg_")}
            if self.telemetry and lo <= s < hi:
                self.telemetry[s - lo].round_event(round_num, metrics, in_degree=in_deg)
        if verbose:
            line = ", ".join(f"{m.label}={np.asarray(mm['accuracy']).mean():.4f}"
                             for m, mm in zip(self.members, member_metrics))
            print(f"Round {round_num}: {line}", flush=True)

    def gather_members(self, values: Sequence) -> list:
        """One value of each of this rank's members -> every member's, in
        member order, on every rank (``values`` itself outside a seed
        group)."""
        if self.seed_group is None:
            return list(values)
        return [v for part in gather_objects(list(values), self.seed_group) for v in part]

    def get_node_statistics(self, member: int = 0) -> Dict[int, Dict[str, Any]]:
        """Per-node rule statistics of one member's last recorded round."""
        stats = self._last_stats[member]
        return {i: {k: float(np.asarray(v).reshape(-1)[i]) if np.ndim(v) else float(v)
                    for k, v in stats.items()}
                for i in range(self.program.num_nodes)}

    # ------------------------------------------------------------------
    # durability (durability/snapshot.py): the whole gang in one snapshot.

    def save_checkpoint(self, directory: str) -> None:
        """Snapshot every member's parameters, carried state and history."""
        from murmura_tpu_torch.durability.snapshot import save_run_snapshot

        t0 = time.perf_counter()
        nbytes = save_run_snapshot(directory, self)
        if self.group is not None or self.seed_group is not None:
            # Rank 0 writes: no rank goes on before the snapshot is committed.
            barrier(self.group)
        self._log_checkpoint("save", self.current_round, nbytes, time.perf_counter() - t0,
                             directory)

    def restore_checkpoint(self, directory: str) -> int:
        """Restore the whole gang; returns the round to continue from.  Each
        member's telemetry stream gets ``run_resumed``."""
        from murmura_tpu_torch.durability.snapshot import restore_run_snapshot

        t0 = time.perf_counter()
        round_num = restore_run_snapshot(directory, self)
        self._in_degree.clear()
        self._log_checkpoint("restore", round_num, committed_bytes(directory),
                             time.perf_counter() - t0, directory)
        for t in self.telemetry:
            t.emit("run_resumed", round=round_num, path=str(directory), run_id=t.run_id)
        return round_num

    def _log_checkpoint(self, action, round_num, nbytes, seconds, directory) -> None:
        self.checkpoints.append({"action": action, "round": round_num, "bytes": nbytes,
                                 "seconds": seconds})
        for t in self.telemetry:
            t.checkpoint_event(round_num, seconds, action=action, path=str(directory),
                               bytes=nbytes)

    def _labels(self) -> List[str]:
        return [m.label for m in self.members]

    def _durability_params(self):
        """The [S, N, P] parameters and the stacked carried state; over a
        param group the row and column blocks gathered to rank 0, over a
        seed group the members' stacks (a collective; (None, None) on the
        other ranks)."""
        if self.seed_group is not None:
            flat = gather_rows(self.flats, self.seed_group, dst=0)
            state = {k: gather_rows(v, self.seed_group, dst=0)
                     for k, v in self.agg_state.items()}
            return (flat, state) if self.seed_group.rank == 0 else (None, None)
        if self.group is None:
            return self.flat, self.agg_state
        sharded = self.program.sharded_state_keys
        flat = gather_rows(self.flats, self.group, dst=0, stacked=True)
        state = {k: gather_columns(v, self.group, dst=0) if k in sharded else v
                 for k, v in self.agg_state.items()}
        if self.group.rank != 0:
            return None, None
        return flat, state

    def _durability_layout(self):
        from murmura_tpu_torch.durability.snapshot import describe_state

        flat_desc, state_desc = describe_state(self.flat, self.agg_state)
        if self.seed_group is not None:
            # The whole gang's layout: each rank holds a block of members.
            return ((self.gang_size,) + flat_desc[0][1:], flat_desc[1]), {
                k: ((self.gang_size,) + shape[1:], dtype)
                for k, (shape, dtype) in state_desc.items()}
        if self.group is None:
            return flat_desc, state_desc
        whole = (self.gang_size, self.program.num_nodes, self.program.flat_dim)
        for k in self.program.sharded_state_keys:
            state_desc[k] = (whole, state_desc[k][1])
        return (whole, flat_desc[1]), state_desc

    def _durability_set_params(self, flat, agg_state) -> None:
        """Assign a restored snapshot, cut to a param group's blocks or to
        a seed group's members."""
        if self.seed_group is not None:
            lo, hi = self._block
            flat = flat[lo:hi].contiguous()
            agg_state = {k: v[lo:hi].contiguous() for k, v in agg_state.items()}
        if self.group is not None:
            lo, hi = self.group.rows
            c0, c1 = self.group.cols
            flat = flat[:, lo:hi].contiguous()
            agg_state = {k: v[:, :, c0:c1].contiguous()
                         if k in self.program.sharded_state_keys else v
                         for k, v in agg_state.items()}
        self.flat, self.agg_state = flat, agg_state

    def _durability_writes(self) -> bool:
        """Whether this process writes the snapshot (rank 0 of a group)."""
        group = self.group if self.seed_group is None else self.seed_group
        return group is None or group.rank == 0

    def _durability_history(self):
        return {"gang_members": self.histories, "labels": self._labels()}

    def _durability_set_history(self, history) -> None:
        self.histories = history["gang_members"]

    def _durability_extra_state(self):
        meta: Dict[str, Any] = {"gang": {"gang_size": self.gang_size,
                                         "labels": self._labels(),
                                         "member_active": list(self.member_active)}}
        run_ids = [t.run_id for t in self.telemetry]
        if self.seed_group is not None:
            run_ids = [i for part in gather_objects(run_ids, self.seed_group) for i in part]
        if run_ids:
            meta["telemetry_run_ids"] = run_ids
        if self.program.param_shards > 1:
            meta["param_shards"] = int(self.program.param_shards)
        return {}, meta

    def _durability_validate_extra(self, arrays, meta) -> None:
        """Refuse, before any member's state is overwritten, a single run's
        snapshot, a gang snapshot of another member set (the same count
        of other seeds has the same shapes, so only the labels tell) and
        one of another shard count."""
        gm = meta.get("gang")
        if gm is None:
            raise ValueError(
                "snapshot carries no gang section — it was written by a "
                "single run; resume it with `run --resume` instead"
            )
        if arrays or "population" in meta:
            raise ValueError(
                f"snapshot carries sections {sorted(set(arrays) | {'population'} & set(meta))} "
                "a gang does not understand; rebuild with the matching config"
            )
        labels, ours = gm.get("labels"), self._labels()
        if labels != ours:
            raise ValueError(
                f"gang snapshot members {labels} != this gang's {ours} — "
                "resuming into a different member set would misattribute "
                "every lane; rebuild with the sweep that wrote the snapshot"
            )
        check_snapshot_shards(meta, self.program.param_shards)

    def _durability_restore_extra(self, arrays, meta) -> None:
        """The frozen lanes."""
        active = meta["gang"].get("member_active")
        if active is not None and len(active) == self.gang_size:
            self.member_active = [bool(a) for a in active]
