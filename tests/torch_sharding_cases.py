"""The cases of the param-group tests, run twice: in the test process, in
one process on the padded flat vector, and in the ranks of a spawned param
group (murmura_tpu_torch/parallel/launch.py).  The ranks import this
module, so it imports neither JAX nor the JAX package.

Every case returns plain numpy (the whole [N, P] parameters gathered over
the group, the round metrics; a gang's whole [S, N, P]), so that the two
runs compare directly.
"""

import pickle
import tempfile
from pathlib import Path

import numpy as np
import torch

from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.aggregation.base import AggContext, self_probe_metrics
from murmura_tpu_torch.aggregation.probe import (
    circulant_probe_eval,
    evidential_trust_metric,
    pairwise_probe_eval,
)
from murmura_tpu_torch.attacks.adaptive import make_bisection_attack
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.rounds import (
    build_round_program,
    init_stacked_params,
    round_generators,
)
from murmura_tpu_torch.data.base import FederatedArrays
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops.flatten import (
    make_sharded_flatteners,
    model_dimension,
    padded_dim,
    tree_map,
)
from murmura_tpu_torch.parallel.launch import forbidden_modules
from murmura_tpu_torch.parallel.mesh import (
    gather_columns,
    gather_rows,
    param_group_scope,
    process_group,
)
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils.factories import build_gang_from_config, build_network_from_config

N = 8
SEED = 7
SHARDS = 4
RULES = ("fedavg", "krum", "median", "trimmed_mean", "geometric_median", "balance",
         "sketchguard", "ubar", "evidential_trust")
# Each rule's params: Krum selects (c = 1 < (5 - 2) / 2), Sketchguard's
# sketch is narrower than the flat vector.
RULE_PARAMS = {"krum": {"num_compromised": 1}, "sketchguard": {"sketch_size": 16},
               "geometric_median": {"max_iters": 4}}


def tiny_data(n: int = N, s: int = 16, seed: int = 0) -> FederatedArrays:
    """The JAX package's tiny sharded program's data
    (tests/test_param_sharding.py ``_tiny_program``)."""
    rng = np.random.default_rng(seed)
    return FederatedArrays(
        x=rng.normal(size=(n, s, 6)).astype(np.float32),
        y=rng.integers(0, 3, size=(n, s)).astype(np.int32),
        mask=np.ones((n, s), np.float32),
        num_samples=np.full((n,), s),
        num_classes=3,
    )


def tiny_model(evidential: bool = False):
    return make_mlp(input_dim=6, hidden_dims=(9,), num_classes=3, evidential=evidential)


def spread_init(model, n: int = N, seed: int = SEED):
    """Node 0's initial parameters for every node plus offsets of distinct
    scales, so that Krum's scores stay far from a tie."""
    base = init_stacked_params(model, n, seed, "cpu")
    rng = np.random.default_rng(seed)
    scale = 0.05 * (1.0 + np.arange(n) / n)

    def leaf(t):
        a = t.numpy()
        noise = rng.normal(size=a.shape).astype(np.float32)
        return (a[:1] + scale.reshape((n,) + (1,) * (a.ndim - 1)) * noise).astype(np.float32)

    return tree_map(leaf, base)


def _whole(flat, prog):
    """The whole [N, P] parameters: a rank's rows gathered over its group."""
    return (flat if prog.group is None else gather_rows(flat, prog.group)).cpu().numpy()


def _host(metrics):
    return {k: v.detach().float().cpu().numpy() for k, v in metrics.items()}


def rule_case(spec):
    """2 rounds of one rule under one exchange (``spec``: rule, exchange,
    and optionally params over RULE_PARAMS, pipeline, adaptive, rounds and
    device, which a rank of a group takes from its group) on the tiny MLP, under a 25%
    gaussian attack, from spread initial parameters.  The attack's std is
    1: at std 10 the two noise rows pull the broadcast mean, the dense
    distances' center, so far from the honest cluster that the Gram
    identity's float32 cancellation (1e-5 of the centered rows' squared
    norms) reaches the honest distances themselves, and a score summed
    over the shards in another order moves by 1e-2 of itself."""
    rule, exchange = spec["rule"], spec["exchange"]
    group = process_group()
    device = torch.device(spec.get("device", "cpu")) if group is None else group.device
    # Evidential trust reads Dirichlet alphas: the evidential head.
    model = tiny_model(evidential=rule == "evidential_trust")
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    params = {**RULE_PARAMS.get(rule, {}), **spec.get("params", {})}
    sparse_offsets = None
    if exchange == "exponential":
        topo = create_topology("exponential", N)
        sparse_offsets = tuple(topo.offsets)
        params.update(exchange_offsets=list(sparse_offsets), sparse_exchange=True)
        adj = topo.edge_mask(0)
    else:
        topo = create_topology("k-regular", N, k=4)
        adj = topo.mask()
        if exchange == "ppermute":
            params["exchange_offsets"] = topo.circulant_offsets()
    agg = build_aggregator(rule, params, model_dim=padded_dim(dim, SHARDS))
    attack = make_gaussian_attack(N, 0.25, noise_std=1.0, seed=SEED)
    if spec.get("adaptive"):
        attack = make_bisection_attack(attack)
    prog = build_round_program(
        model, agg, tiny_data(), batch_size=8, lr=0.05, total_rounds=4, seed=SEED,
        attack=attack, init_params=spread_init(model), device=device, param_shards=SHARDS,
        group=group, pipeline=spec.get("pipeline", False), sparse_offsets=sparse_offsets)
    comp = torch.from_numpy(attack.compromised.astype(np.float32)).to(device)
    adj = torch.from_numpy(adj).to(device)
    flat, state = prog.init_flat, prog.init_agg_state
    rounds = []
    for r in range(spec.get("rounds", 2)):
        flat, state, metrics = prog.train_step(
            flat, state, adj, comp, float(r), generators=round_generators(SEED, r, device))
        rounds.append(_host({**prog.eval_step(flat), **metrics}))
    return {"flat": _whole(flat, prog), "rounds": rounds, "flat_dim": prog.flat_dim,
            "model_dim": prog.model_dim}


def jax_tiny_case(spec):
    """The JAX package's tiny sharded round (``spec``'s rule, Krum by
    default, with the AGG_CASES params, the whole graph, no attack) from
    ``spec``'s initial parameters and its round key's shuffle draw ``u``."""
    model = tiny_model()
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    agg = build_aggregator(spec.get("rule", "krum"), dict(spec["agg_params"]),
                           model_dim=padded_dim(dim, SHARDS))
    prog = build_round_program(
        model, agg, tiny_data(), local_epochs=1, batch_size=8, lr=0.05, total_rounds=4,
        seed=SEED, init_params=spec["init"], device="cpu", param_shards=SHARDS,
        group=process_group())
    adj = np.ones((N, N), np.float32) - np.eye(N, dtype=np.float32)
    flat, _, metrics = prog.train_step(
        prog.init_flat, prog.init_agg_state, torch.from_numpy(adj), torch.zeros(N), 0.0,
        draws={"u": [spec["u"]]})
    return {"flat": _whole(flat, prog), "metrics": _host(metrics), "flat_dim": prog.flat_dim}


def tiny_config(**over) -> dict:
    """sharded_model.yaml's levers (faults, staleness, int8 with error
    feedback, Krum under a gaussian attack) over 8 nodes of an MLP of hidden
    width 13 (159 parameters padded to 160): int8 blocks of 8 divide the
    shard-local width (160 / 4)."""
    raw = {
        "experiment": {"name": "sharded-tiny", "seed": SEED, "rounds": 2},
        "topology": {"type": "k-regular", "num_nodes": N, "k": 4},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.25,
                   "params": {"noise_std": 5.0}},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 160, "input_shape": [6], "num_classes": 3}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 6, "hidden_dims": [13], "num_classes": 3}},
        "backend": "tpu",
        "faults": {"enabled": True, "straggler_prob": 0.3, "link_drop_prob": 0.1, "seed": 11},
        "exchange": {"max_staleness": 2, "staleness_discount": 0.5},
        "compression": {"algorithm": "int8", "block": 8, "error_feedback": True},
        "tpu": {"param_shards": SHARDS, "param_dtype": "float32"},
    }
    for k, v in over.items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) and isinstance(raw.get(k), dict) else v
    return raw


def _run_state(net):
    """The network's whole state in the snapshot layout, on the host."""
    flat, state = net._durability_params()
    if flat is None:  # a rank other than 0 of a group
        return None
    return {"flat": flat.numpy(), "state": {k: v.numpy() for k, v in state.items()},
            "history": net.history}


def network_case(spec):
    """A config through ``build_network_from_config`` and ``Network.train``
    (``spec``: the config's raw dict, rounds, rounds_per_dispatch; with
    ``resume`` the first round snapshotted, a second network restored from
    the snapshot and trained on; ``refuse_dir`` a snapshot the network must
    refuse)."""
    cfg = Config.model_validate(spec["raw"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        net = build_network_from_config(cfg, device="cpu")
        if spec.get("refuse_dir"):
            try:
                net.restore_checkpoint(spec["refuse_dir"])
                out["refused"] = None
            except ValueError as e:
                out["refused"] = str(e)
        rounds = spec.get("rounds", 2)
        chunk = spec.get("rounds_per_dispatch", 1)
        snap = spec.get("snapshot_dir") or str(Path(tmp) / "snap")
        if spec.get("resume"):
            net.train(1, checkpoint_dir=snap)
            net.train(rounds - 1)
            resumed = build_network_from_config(cfg, device="cpu")
            out["restored_round"] = resumed.restore_checkpoint(snap)
            resumed.train(rounds - 1)
            out["resumed"] = _run_state(resumed)
        else:
            net.train(rounds, rounds_per_dispatch=chunk)
        out["run"] = _run_state(net)
        group = process_group()
        if group is not None:
            out["sharded_keys"] = list(net.program.sharded_state_keys)
            out["state_cols"] = {k: tuple(net.agg_state[k].shape)
                                 for k in net.program.sharded_state_keys}
    return out


def probe_case(spec):
    """The probe forwards on one seeded input: the dense [N, N] and the
    circulant [k, N] cross-evaluations of a broadcast and the self probe of
    the own rows, each metric of evidential trust's (accuracy, vacuity,
    entropy, strength); under a group each rank hands in its column block
    of the same whole tensors."""
    model = tiny_model(evidential=True)
    template = model.init(torch.Generator().manual_seed(0), "cpu")
    _, unravel, dim, flat_dim = make_sharded_flatteners(template, SHARDS)
    data = tiny_data()
    rng = np.random.default_rng(spec.get("seed", 3))
    whole = {k: rng.normal(scale=0.5, size=(N, flat_dim)).astype(np.float32)
             for k in ("own", "bcast")}
    for v in whole.values():
        v[:, dim:] = 0.0
    group = process_group()
    if group is not None:
        group = group.bind(N, flat_dim)
    c0, c1 = (0, flat_dim) if group is None else group.cols
    own, bcast = (torch.from_numpy(whole[k][:, c0:c1].copy()) for k in ("own", "bcast"))
    ctx = AggContext(apply_fn=model.apply, unravel=unravel,
                     probe_x=torch.from_numpy(data.x[:, :8]),
                     probe_y=torch.from_numpy(data.y[:, :8].astype(np.int64)),
                     probe_mask=torch.from_numpy(data.mask[:, :8]))
    with param_group_scope(group):
        dense = pairwise_probe_eval(bcast, ctx, evidential_trust_metric)
        circ = circulant_probe_eval(bcast, [1, 3, 6], ctx, evidential_trust_metric)
        own_m = self_probe_metrics(own, ctx, evidential_trust_metric)
    return {"dense": _host(dense), "circulant": _host(circ), "self": _host(own_m)}


def _gang_state(gang):
    """The gang's whole state in the snapshot layout, on the host (rank 0's;
    None on the other ranks of a group)."""
    flat, state = gang._durability_params()
    if flat is None:
        return None
    return {"flat": flat.numpy(), "state": {k: v.numpy() for k, v in state.items()},
            "histories": gang.histories}


def _gang_rounds_with_draws(gang, draws, rounds):
    """``rounds`` gang rounds through the gang's step with injected draws
    (one dict a member a round, the JAX members' own), each evaluated and
    recorded as ``train`` records it."""
    adj = torch.from_numpy(gang.topology.mask())
    s_count, rows, p = gang.flats.shape
    n = gang.program.num_nodes
    for r in range(rounds):
        gang.flats, gang.agg_states, metrics = gang._step(gang.flats, gang.agg_states, adj, r,
                                                          draws=draws[r])
        ev = gang.program.eval_step(gang.flats.reshape(s_count * rows, p), data=gang._data,
                                    members=s_count)
        gang._record_all(r + 1, [
            {**{k: v[s * n:(s + 1) * n].numpy() for k, v in ev.items()},
             **{k: v.numpy() for k, v in metrics[s].items()}} for s in range(s_count)],
            verbose=False)
        gang.current_round = r + 1


def gang_case(spec):
    """A gang through ``build_gang_from_config`` (``spec``: the config's raw
    dict, seeds, rounds; ``init`` one initial parameter set a member and
    ``draws`` one list of member draws a round, which then run through the
    gang's step; with ``resume`` the first round snapshotted into
    ``snapshot_dir``, a second gang restored from it and trained on;
    ``refuse_dirs`` snapshots the gang must refuse)."""
    cfg = Config.model_validate(spec["raw"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        gang = build_gang_from_config(cfg, seeds=spec.get("seeds"), device="cpu",
                                      init_params=spec.get("init"))
        out["refused"] = {}
        for name, path in (spec.get("refuse_dirs") or {}).items():
            try:
                gang.restore_checkpoint(path)
                out["refused"][name] = None
            except ValueError as e:
                out["refused"][name] = str(e)
        rounds = spec.get("rounds", 2)
        snap = spec.get("snapshot_dir") or str(Path(tmp) / "snap")
        if spec.get("draws") is not None:
            _gang_rounds_with_draws(gang, spec["draws"], rounds)
        elif spec.get("resume"):
            gang.train(1, checkpoint_dir=snap)
            gang.train(rounds - 1)
            resumed = build_gang_from_config(cfg, seeds=spec.get("seeds"), device="cpu")
            out["restored_round"] = resumed.restore_checkpoint(snap)
            resumed.train(rounds - 1)
            out["resumed"] = _gang_state(resumed)
        else:
            gang.train(rounds)
        out["run"] = _gang_state(gang)
        if gang.group is not None:
            out["rows"] = tuple(gang.flats.shape)
    return out


def run_cases(cases):
    """Every (kind, spec) case in order, with this process's forbidden
    modules; what a param group's ranks run."""
    fns = {"rule": rule_case, "jax_tiny": jax_tiny_case, "network": network_case,
           "gather": gather_check, "probe": probe_case, "gang": gang_case}
    results = [fns[kind](spec) for kind, spec in cases]
    group = process_group()
    return {"results": results, "forbidden_modules": forbidden_modules(),
            "rank": None if group is None else group.rank}


def counted_cases(plan):
    """:func:`run_cases` with this process's kernel launches and plain-version
    calls."""
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    mods = (agg_kernels, candidate_kernels, sketch_kernels)
    for mod in mods:
        mod.reset_counts()
    out = run_cases(plan)
    out["launches"] = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    out["plain_calls"] = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
    return out


def gather_check(spec):
    """The collectives on uneven row blocks (7 nodes): every rank's rows and
    column blocks gathered back equal the whole tensor (True off a group)."""
    group = process_group()
    if group is None:
        return {"cols": True, "rows": True, "gather_rows": True, "gather_columns": True}
    group = group.bind(7, 12)
    whole = torch.arange(7 * 12, dtype=torch.float32).reshape(7, 12)
    lo, hi = group.rows
    c0, c1 = group.cols
    from murmura_tpu_torch.parallel.mesh import columns_to_rows, rows_to_columns

    cols = rows_to_columns(whole[lo:hi].clone(), group)
    back = columns_to_rows(cols, group)
    return {"cols": bool(torch.equal(cols, whole[:, c0:c1])),
            "rows": bool(torch.equal(back, whole[lo:hi])),
            "gather_rows": bool(torch.equal(gather_rows(whole[lo:hi], group), whole)),
            "gather_columns": bool(torch.equal(gather_columns(whole[:, c0:c1], group), whole))}


def run_cases_then_fail(cases, out_dir: str, rank: int):
    """:func:`run_cases`, its result written to ``out_dir`` as
    ``rank<r>.pkl``; then, once every rank has written, ``rank`` raises while
    the others wait in a collective that never completes."""
    import torch.distributed as dist

    result = run_cases(cases)
    group = process_group()
    with open(Path(out_dir) / f"rank{group.rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    if group.rank == rank:
        raise RuntimeError(f"deliberate failure on rank {rank}")
    dist.barrier()
