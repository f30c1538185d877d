"""The cases of the node-axis tests, run twice: in the test process, in one
process, and in the ranks of a spawned node group (``launch(...,
axis="nodes")``, murmura_tpu_torch/parallel/launch.py).  The ranks import
this module, so it imports neither JAX nor the JAX package.

Every case returns plain numpy (the whole [N, P] parameters gathered over
the group, the round metrics), so that the two runs compare directly.
"""

import tempfile
from pathlib import Path

import numpy as np
import torch

from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.rounds import build_round_program, round_generators
from murmura_tpu_torch.ops.flatten import model_dimension
from murmura_tpu_torch.parallel.launch import forbidden_modules
from murmura_tpu_torch.parallel.mesh import (
    EXCHANGE_COUNTS,
    exchange_rows,
    gather_rows,
    process_group,
    reset_exchange_counts,
)
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils.factories import build_network_from_config
from torch_sharding_cases import spread_init, tiny_data, tiny_model  # noqa: F401

N = 8
SEED = 7
WORLD = 4
RULES = ("fedavg", "krum", "median", "trimmed_mean", "geometric_median", "balance",
         "sketchguard")
# Krum selects (c = 1 < (5 - 2) / 2); Sketchguard's sketch is narrower
# than the flat vector.
RULE_PARAMS = {"krum": {"num_compromised": 1}, "sketchguard": {"sketch_size": 16},
               "geometric_median": {"max_iters": 4}}


def _whole(flat, prog):
    """The whole [N, P] parameters: a rank's rows gathered over its group."""
    return (flat if prog.group is None else gather_rows(flat, prog.group)).cpu().numpy()


def _host(metrics):
    return {k: v.detach().float().cpu().numpy() for k, v in metrics.items()}


def rule_case(spec):
    """2 rounds of one rule under one exchange (``spec``: rule, exchange
    (allgather, ppermute or exponential, the sparse exchange), optionally
    params over RULE_PARAMS and audit) on the tiny MLP under a 25% gaussian
    attack at std 1, from spread initial parameters (see
    torch_sharding_cases.rule_case for why std 1)."""
    rule, exchange = spec["rule"], spec["exchange"]
    group = process_group()
    model = tiny_model()
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
    agg = build_aggregator(rule, params, model_dim=dim)
    attack = make_gaussian_attack(N, 0.25, noise_std=1.0, seed=SEED)
    prog = build_round_program(
        model, agg, tiny_data(), batch_size=8, lr=0.05, total_rounds=4, seed=SEED,
        attack=attack, init_params=spread_init(model), device="cpu", group=group,
        sparse_offsets=sparse_offsets, audit_taps=spec.get("audit", False))
    comp = torch.from_numpy(attack.compromised.astype(np.float32))
    adj = torch.from_numpy(adj)
    flat, state = prog.init_flat, prog.init_agg_state
    rounds = []
    reset_exchange_counts()
    for r in range(2):
        flat, state, metrics = prog.train_step(flat, state, adj, comp, float(r),
                                               generators=round_generators(SEED, r, "cpu"))
        rounds.append(_host({**prog.eval_step(flat), **metrics}))
    return {"flat": _whole(flat, prog), "rounds": rounds, "exchange": dict(EXCHANGE_COUNTS),
            "rows": tuple(flat.shape)}


def jax_tiny_case(spec):
    """The JAX package's tiny rounds (``spec``'s rule with its AGG_CASES
    params, the whole graph, no attack) from ``spec``'s initial parameters:
    one round with its round key's shuffle draw ``u``, or one round a draw
    of ``u_rounds`` (JAX's fused rounds)."""
    model = tiny_model()
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    agg = build_aggregator(spec["rule"], dict(spec["agg_params"]), model_dim=dim)
    prog = build_round_program(
        model, agg, tiny_data(), local_epochs=1, batch_size=8, lr=0.05, total_rounds=4,
        seed=SEED, init_params=spec["init"], device="cpu", group=process_group())
    adj = torch.from_numpy(np.ones((N, N), np.float32) - np.eye(N, dtype=np.float32))
    flat, state, rounds = prog.init_flat, prog.init_agg_state, []
    for r, u in enumerate(spec.get("u_rounds") or [spec["u"]]):
        flat, state, metrics = prog.train_step(flat, state, adj, torch.zeros(N), float(r),
                                               draws={"u": [u]})
        rounds.append(_host(metrics))
    return {"flat": _whole(flat, prog), "metrics": rounds[0], "rounds": rounds}


def tiny_config(**over) -> dict:
    """The flagship's shape (k-regular(4), Krum under a gaussian attack,
    backend: tpu) over 8 nodes of an MLP, under chaos_churn.yaml's faults
    (crashes, dropped links, stragglers, a NaN-emitting node quarantined)."""
    raw = {
        "experiment": {"name": "node-axis-tiny", "seed": SEED, "rounds": 2},
        "topology": {"type": "k-regular", "num_nodes": N, "k": 4},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.25,
                   "params": {"noise_std": 1.0}},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 160, "input_shape": [6], "num_classes": 3}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 6, "hidden_dims": [13], "num_classes": 3}},
        "backend": "tpu",
        "faults": {"enabled": True, "seed": 777, "crash_prob": 0.2, "recovery_prob": 0.5,
                   "min_down_rounds": 1, "link_drop_prob": 0.05, "straggler_prob": 0.1,
                   "straggler_factor": 2.0, "nan_quarantine": True,
                   "nan_inject_nodes": [2], "nan_inject_from_round": 0},
        "tpu": {"param_dtype": "float32", "num_devices": WORLD},
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
    refuse).  In the test process ``tpu.num_devices`` is dropped: one
    process."""
    raw = spec["raw"]
    if process_group() is None:
        raw = {**raw, "tpu": {k: v for k, v in raw["tpu"].items() if k != "num_devices"}}
    cfg = Config.model_validate(raw)
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
        out["rows"] = tuple(net.flat.shape)
    return out


def exchange_case(spec):
    """The window exchange on a layout where rows come from ranks that are
    not neighbours (``spec``: num_nodes and offsets): each rank's rows are
    their node ids, and the rank reports the ids its window received, the
    rows the collective brought and the plan's window; under allgather the
    whole [N] ids.  Off a group the whole network's ids."""
    group = process_group()
    n, offsets = spec["num_nodes"], spec.get("offsets")
    ids = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 3)
    if group is None:
        return {"ids": ids[:, 0].tolist()}
    g = group.bind(n, offsets)
    lo, hi = g.rows
    reset_exchange_counts()
    got = exchange_rows(ids[lo:hi].clone(), g)
    return {"ids": got[:, 0].tolist(), "window": g.window_rows() if g.windowed else None,
            "counts": dict(EXCHANGE_COUNTS), "rows": (lo, hi), "describe": g.describe()}


def run_cases(cases):
    """Every (kind, spec) case in order, with this process's forbidden
    modules and kernel calls; what a node group's ranks run."""
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    fns = {"rule": rule_case, "jax_tiny": jax_tiny_case, "network": network_case,
           "exchange": exchange_case}
    mods = (agg_kernels, candidate_kernels, sketch_kernels)
    for mod in mods:
        mod.reset_counts()
    results = [fns[kind](spec) for kind, spec in cases]
    group = process_group()
    return {"results": results, "forbidden_modules": forbidden_modules(),
            "rank": None if group is None else group.rank,
            "plain_calls": {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}}
