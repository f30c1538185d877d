"""The cases of the serve-group tests, run in the ranks of one spawned seed
group of 2 (``launch(..., axis="seed")``, murmura_tpu_torch/parallel/
launch.py), the same ranks re-bound as a param group for the param cases,
and the one-process daemon's in the test process.  The ranks import this
module, so it imports neither JAX nor the JAX package.

Every case returns plain values: each generation's tenant histories (every
rank's gang records every tenant), the lanes it froze, what each rank
built and held, rank 0's ledger records and the gang's whole state as rank
0 gathers it (None on the other ranks).
"""

import os
import pickle
import signal
import time
from pathlib import Path

import numpy as np

import torch_seed_axis_cases as seed_cases
import torch_sharding_cases as sharding
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core import gang as gang_mod
from murmura_tpu_torch.parallel.launch import forbidden_modules
from murmura_tpu_torch.parallel.mesh import process_group
from murmura_tpu_torch.serve.daemon import ServeDaemon
from torch_node_axis_cases import tiny_config

WORLD = 2
# Tenants of one bucket: (seed, lr); the bucket's template is the first.
TENANTS = ((7, 0.05), (8, 0.02), (9, 0.05), (10, 0.03))
LRS = dict(TENANTS)


def tenant(seed: int, group: str = "seed") -> dict:
    """One tenant: the tiny flagship-shaped config (Krum under a gaussian
    attack, backend: tpu, no faults) at ``tpu.num_devices: 2`` (``group``
    "seed"), at ``tpu.param_shards: 2`` (torch_sharding_cases' tiny MLP,
    "param") or planned in one process (``group`` None)."""
    if group == "param":
        raw = sharding.tiny_config(tpu={"param_shards": WORLD},
                                   attack={"params": {"noise_std": 1.0}})
        for section in ("faults", "exchange", "compression"):
            raw.pop(section)
    else:
        raw = tiny_config()
        raw.pop("faults")
        raw["tpu"] = {"param_dtype": "float32"}
        if group == "seed":
            raw["tpu"]["num_devices"] = WORLD
    raw["experiment"] = {**raw["experiment"], "seed": seed, "name": f"tenant-{seed}"}
    raw["training"] = {**raw["training"], "lr": LRS[seed]}
    return raw


def daemon_raw(state_dir, capacity: int, group="seed", rounds: int = 2, **serve) -> dict:
    """A daemon config over ``state_dir`` whose own layout is its tenants'."""
    raw = tenant(TENANTS[0][0], group)
    raw["experiment"]["rounds"] = rounds
    raw["serve"] = {"state_dir": str(state_dir), "capacity": capacity, "checkpoint_every": 1,
                    "poll_interval_s": 0.05, **serve}
    return raw


class _Kill(BaseException):
    """SIGKILL stand-in (not an Exception: nothing between the training loop
    and the case swallows it); raised on every rank at the same point."""


def _bucket_gang(daemon):
    (bucket,) = daemon._buckets.values()
    return bucket["gang"]


def _evicting(daemon, gang, ids, lane, reason):
    """Make the gang's next generation train one round, then (rank 0) evict
    lane ``lane``'s tenant, then train the rest."""
    real = gang.train

    def train(rounds, **kwargs):
        real(rounds=1, **kwargs)
        if daemon._owner:
            daemon.evict(ids[lane], reason)
        del gang.train
        return real(rounds=rounds - 1, **kwargs)

    gang.train = train


def jax_inputs(path, seconds: float = 600.0):
    """The JAX members' initial parameters and draws by seed, from the
    pickle the test process writes at ``path`` once its JAX references
    have run (the ranks start before them and wait here)."""
    path = Path(path)
    deadline = time.monotonic() + seconds
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX inputs at {path} after {seconds} s")
        time.sleep(0.1)
    return pickle.loads(path.read_bytes())


def _injected(path):
    """Patch the daemon's member programs and training for the JAX
    comparison (the inputs at ``path``, :func:`jax_inputs`): each tenant's
    initial parameters are JAX's (by seed), and each generation runs its
    rounds through the gang's step with the JAX members' draws
    (torch_seed_axis_cases.rounds_with_draws).  Returns a function that
    undoes the patches."""
    from murmura_tpu_torch.utils import factories

    inputs = jax_inputs(path)
    init, draws = inputs["init"], inputs["draws"]
    real_build = factories.build_gang_member_programs
    real_train = gang_mod.GangNetwork.train

    def build(config, members, device="cuda", whole=False, attack=None):
        return factories._gang_members_and_programs(
            config, device, members=list(members), whole=whole, round_attack=attack,
            init_params=[init[m.seed] for m in members])[3]

    def train(gang, rounds, **kwargs):
        n = gang.program.num_nodes
        for r in range(gang.current_round, gang.current_round + rounds):
            # The round events' in-degree, which the comparison reads nowhere.
            gang._in_degree[r] = np.zeros(n)
        seed_cases.rounds_with_draws(
            gang, [[draws[m.seed][r] for m in gang.members] for r in range(rounds)], rounds)
        return gang.histories

    factories.build_gang_member_programs = build
    gang_mod.GangNetwork.train = train

    def undo():
        factories.build_gang_member_programs = real_build
        gang_mod.GangNetwork.train = real_train

    return undo


def daemon_case(spec):
    """A daemon over ``spec["daemon"]`` (its raw config) fed
    ``spec["generations"]`` (one list of tenant configs a generation, each
    list drained before the next is submitted).  ``evict``: {generation
    index: lane} evicted after round 1; ``jax``: the path of the JAX
    members' initial parameters and draws by seed (:func:`_injected`);
    ``kill``: every rank
    stops after round 1 of the first generation (:class:`_Kill`), and a
    second daemon over the same state dir recovers and drains."""
    undo = _injected(spec["jax"]) if spec.get("jax") else None
    try:
        return _daemon_run(spec)
    finally:
        if undo is not None:
            undo()


def _daemon_run(spec):
    cfg = Config.model_validate(spec["daemon"])
    daemon = ServeDaemon(cfg, device="cpu")
    out = {"plan": daemon.plan, "gens": [], "owner": daemon._owner}
    killed = None
    for g, tenants in enumerate(spec["generations"]):
        ids = [daemon.submit_config(t)["id"] for t in tenants] if daemon._owner else []
        built = daemon._compile_count()
        if g in spec.get("evict", {}):
            _evicting(daemon, _bucket_gang(daemon), ids, spec["evict"][g], "case eviction")
        real_train = gang_mod.GangNetwork.train
        if spec.get("kill") and g == 0:
            def dying(self, rounds, **kwargs):
                real_train(self, rounds=1, **kwargs)
                raise _Kill()

            gang_mod.GangNetwork.train = dying
        try:
            daemon.drain()
        except _Kill:
            killed = ids
        finally:
            gang_mod.GangNetwork.train = real_train
        if killed is not None:
            daemon = ServeDaemon(cfg, device="cpu")
            out["recovered"] = daemon.recover()
            daemon.drain()
            killed = None
        gang = _bucket_gang(daemon)
        rec = {"block": tuple(gang._block), "held": int(gang.flats.shape[0]),
               "histories": gang.histories, "active": list(gang.member_active),
               "built": daemon._compile_count() - built, "round": gang.current_round,
               "run": seed_cases._state(gang)}
        if daemon._owner:
            rec["ledger"] = [{k: daemon._ledger[i].get(k) for k in ("state", "history", "gen",
                                                                     "lane", "error")}
                             for i in ids]
            rec["counters"] = dict(daemon._counters)
        out["gens"].append(rec)
    return out


def single_case(spec):
    """Each tenant of ``spec["tenants"]`` as a one-member gang (its seed and
    lr, the daemon's member) of its config over this process's group, its
    attack placement pinned to the bucket's (``attack.params.seed``: the
    first tenant's seed), trained as the daemon trains (one round a chunk,
    evaluated every round): its whole state and history."""
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    out = []
    placement = spec["tenants"][0]["experiment"]["seed"]
    for raw in spec["tenants"]:
        attack = {**raw["attack"], "params": {**raw["attack"]["params"], "seed": placement}}
        raw = {**raw, "attack": attack,
               "sweep": {"members": [{"seed": raw["experiment"]["seed"],
                                      "lr": raw["training"]["lr"]}]}}
        gang = build_gang_from_config(Config.model_validate(raw), device="cpu")
        gang.train(rounds=raw["experiment"]["rounds"], eval_every=1)
        out.append({"run": seed_cases._state(gang), "history": gang.histories[0]})
    return out


def idle_case(spec):
    """``serve_forever`` of a daemon over ``spec["daemon"]`` on every rank
    (rank 0 on its socket) until a client's shutdown; the rank's pid and
    the seconds it served."""
    t0 = time.perf_counter()
    daemon = ServeDaemon(Config.model_validate(spec["daemon"]), device="cpu")
    daemon.serve_forever()
    return {"pid": os.getpid(), "served_s": time.perf_counter() - t0}


def run_cases(cases):
    """Every (kind, spec) case in order, and this process's forbidden
    modules: ``seed:`` kinds in the process's group as it is, ``param:``
    kinds with the same ranks re-bound as a param group."""
    fns = {"daemon": daemon_case, "single": single_case, "idle": idle_case}
    results = []
    for kind, spec in cases:
        axis, name = kind.split(":")
        fn = fns[name]
        results.append(seed_cases.as_param_group(fn, spec) if axis == "param" else fn(spec))
    group = process_group()
    return {"results": results, "forbidden_modules": forbidden_modules(),
            "rank": None if group is None else group.rank}


def hold_the_card(pid_dir):
    """A rank of the card's orphan test: put a tensor on its card, write its
    pid to ``pid_dir``, then wait to be killed."""
    import torch

    torch.ones(1 << 20, device="cuda").sum().item()
    Path(pid_dir, f"{os.getpid()}.pid").write_text("ready")
    while True:
        time.sleep(1.0)


def launch_and_hold(pid_dir):
    """The launcher of the card's orphan test: a group of 2 on cuda:0 whose
    ranks hold the card until this process is killed."""
    from murmura_tpu_torch.parallel.launch import launch

    Path(pid_dir, "launcher").write_text(str(os.getpid()))
    launch(hold_the_card, (str(pid_dir),), world=2, device_type="cuda", one_device=True)


def alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie counts as gone)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
    return state != "Z"


def children(pid: int) -> list:
    """The pids whose parent is ``pid``, read from the process table."""
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
            except (FileNotFoundError, ProcessLookupError, IndexError):
                continue
            if int(fields[1]) == pid:
                out.append(int(d.name))
    return out


def survivors(pids, seconds: float = 30.0) -> list:
    """Which of ``pids`` are still alive after at most ``seconds``."""
    deadline = time.monotonic() + seconds
    left = list(pids)
    while left and time.monotonic() < deadline:
        left = [p for p in left if alive(p)]
        time.sleep(0.05)
    return left


def kill_and_wait(pid: int, others, seconds: float = 30.0) -> list:
    """SIGKILL ``pid`` and return which of ``others`` are still alive after
    at most ``seconds``."""
    os.kill(pid, signal.SIGKILL)
    return survivors(others, seconds)
