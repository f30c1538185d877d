"""The cases of the node-axis tests of the probe rules (UBAR, evidential
trust), the row-reading attacks (ALIE, IPM, the adaptive attacks) and DMTT,
run twice: in the test process, in one process, and in the ranks of a
spawned node group (``launch(..., axis="nodes")``).  The ranks import this
module, so it imports neither JAX nor the JAX package.

Every case returns plain numpy (the whole [N, P] parameters and carried
state gathered over the group, the round metrics), so that the two runs
compare directly.
"""

import numpy as np
import torch

from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.aggregation.base import AggContext, self_probe_metrics
from murmura_tpu_torch.aggregation.probe import (
    circulant_probe_eval,
    evidential_trust_metric,
    pairwise_probe_eval,
)
from murmura_tpu_torch.attacks.adaptive import (
    make_adaptive_alie_attack,
    make_adaptive_ipm_attack,
    make_bisection_attack,
)
from murmura_tpu_torch.attacks.alie import make_alie_attack
from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
from murmura_tpu_torch.attacks.ipm import make_ipm_attack
from murmura_tpu_torch.attacks.topology_liar import make_topology_liar_attack
from murmura_tpu_torch.core import rounds as rounds_mod
from murmura_tpu_torch.core.rounds import build_round_program, round_generators
from murmura_tpu_torch.dmtt.protocol import DMTTParams
from murmura_tpu_torch.ops.flatten import model_dimension
from murmura_tpu_torch.parallel.launch import forbidden_modules
from murmura_tpu_torch.parallel.mesh import (
    COLLECTIVE_COUNTS,
    EXCHANGE_COUNTS,
    exchange_rows,
    gather_rows,
    node_block_scope,
    process_group,
    reset_exchange_counts,
)
from murmura_tpu_torch.topology.dynamic import MobilityModel
from murmura_tpu_torch.topology.generators import create_topology
from torch_node_axis_cases import N, SEED, WORLD, network_case, tiny_config  # noqa: F401
from torch_sharding_cases import spread_init, tiny_data, tiny_model

# Krum selects (c = 1 < (5 - 2) / 2).
RULE_PARAMS = {"krum": {"num_compromised": 1}}
# ALIE's z: the paper's z_max is 0 at 2 colluders of 8, where the colluders
# broadcast the honest mean and adaptive ALIE's multiplicative walk stays
# at 0.
ALIE_Z = 1.0


def make_attack(name: str, n: int = N):
    """The port's attack ``name`` at 25% of ``n`` nodes, placed by SEED."""
    gauss = lambda: make_gaussian_attack(n, 0.25, noise_std=1.0, seed=SEED)  # noqa: E731
    return {"gaussian": gauss,
            "alie": lambda: make_alie_attack(n, 0.25, z=ALIE_Z, seed=SEED),
            "ipm": lambda: make_ipm_attack(n, 0.25, seed=SEED),
            "adaptive_alie": lambda: make_adaptive_alie_attack(n, 0.25, z=ALIE_Z, seed=SEED),
            "adaptive_ipm": lambda: make_adaptive_ipm_attack(n, 0.25, seed=SEED),
            "bisection": lambda: make_bisection_attack(gauss())}[name]()


def _host(metrics):
    return {k: v.detach().float().cpu().numpy() for k, v in metrics.items()}


def _whole_state(state, prog):
    """The carried state whole: a node block's row-held keys gathered."""
    return {k: (gather_rows(v, prog.group) if k in prog.row_state_keys else v).cpu().numpy()
            for k, v in state.items()}


def _whole(flat, prog):
    return (flat if prog.group is None else gather_rows(flat, prog.group)).cpu().numpy()


def _graph(exchange, params):
    """(the round's adjacency input, the sparse offsets or None) of
    ``exchange``: the k-regular(4) graph dense or circulant (its offsets
    into ``params``), or the exponential graph's edge mask."""
    if exchange == "exponential":
        topo = create_topology("exponential", N)
        offsets = tuple(topo.offsets)
        params.update(exchange_offsets=list(offsets), sparse_exchange=True)
        return topo.edge_mask(0), offsets
    topo = create_topology("k-regular", N, k=4)
    if exchange == "ppermute":
        params["exchange_offsets"] = topo.circulant_offsets()
    return topo.mask(), None


def round_case(spec):
    """``rounds`` (2) rounds of one rule under one exchange and attack
    (``spec``: rule, exchange (allgather, ppermute or exponential, the
    sparse exchange), attack, optionally audit) on the tiny MLP (the
    evidential head for evidential trust) from spread initial parameters.
    Returns the whole parameters and carried state, each round's metrics,
    and this process's exchange and collective counts."""
    rule, exchange = spec["rule"], spec["exchange"]
    model = tiny_model(evidential=rule == "evidential_trust")
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    params = dict(RULE_PARAMS.get(rule, {}))
    adj, sparse_offsets = _graph(exchange, params)
    agg = build_aggregator(rule, params, model_dim=dim)
    attack = make_attack(spec["attack"])
    prog = build_round_program(
        model, agg, tiny_data(), batch_size=8, lr=0.05, total_rounds=4, seed=SEED,
        attack=attack, init_params=spread_init(model), device="cpu", group=process_group(),
        sparse_offsets=sparse_offsets, audit_taps=spec.get("audit", False))
    comp = torch.from_numpy(attack.compromised.astype(np.float32))
    adj = torch.from_numpy(adj)
    flat, state = prog.init_flat, prog.init_agg_state
    rounds = []
    reset_exchange_counts()
    for r in range(spec.get("rounds", 2)):
        flat, state, metrics = prog.train_step(flat, state, adj, comp, float(r),
                                               generators=round_generators(SEED, r, "cpu"))
        rounds.append(_host({**prog.eval_step(flat), **metrics}))
    counts = {"exchange": dict(EXCHANGE_COUNTS), "collectives": dict(COLLECTIVE_COUNTS)}
    return {"flat": _whole(flat, prog), "state": _whole_state(state, prog), "rounds": rounds,
            "rows": tuple(flat.shape), "dim": dim, "row_state_keys": prog.row_state_keys,
            **counts}


def jax_tiny_case(spec):
    """The JAX package's tiny round (``spec``'s rule with its AGG_CASES
    params, the whole graph, ``spec``'s attack if any, the evidential head
    if ``evidential``) from its initial parameters and shuffle draw ``u``."""
    model = tiny_model(evidential=spec.get("evidential", False))
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    agg = build_aggregator(spec["rule"], dict(spec["agg_params"]), model_dim=dim)
    attack = make_attack(spec["attack"]) if spec.get("attack") else None
    prog = build_round_program(
        model, agg, tiny_data(), local_epochs=1, batch_size=8, lr=0.05, total_rounds=4,
        seed=SEED, init_params=spec["init"], device="cpu", group=process_group(),
        attack=attack)
    adj = torch.from_numpy(np.ones((N, N), np.float32) - np.eye(N, dtype=np.float32))
    comp = torch.zeros(N) if attack is None else torch.from_numpy(
        attack.compromised.astype(np.float32))
    flat, state, metrics = prog.train_step(prog.init_flat, prog.init_agg_state, adj, comp, 0.0,
                                           draws={"u": [spec["u"]]})
    return {"flat": _whole(flat, prog), "metrics": _host(metrics),
            "state": _whole_state(state, prog)}


def probe_case(spec):
    """The probe forwards on one input: the evidential MLP's spread rows as
    the broadcast, exchanged as a round exchanges them (the whole [N, P]
    for the dense cross-evaluation, the block's window at the k-regular(4)
    offsets for the circulant one), each helper called as the rules call
    it.  Returns the whole [N, N] and [k, N] matrices and the [N] self
    probe, and the window's rows."""
    model = tiny_model(evidential=True)
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    offsets = create_topology("k-regular", N, k=4).circulant_offsets()
    agg = build_aggregator("evidential_trust", {}, model_dim=dim)
    prog = build_round_program(model, agg, tiny_data(), batch_size=8, seed=SEED,
                               init_params=spread_init(model), device="cpu",
                               group=process_group())
    ctx = AggContext(apply_fn=model.apply, unravel=prog.unravel, probe_x=prog.data["probe_x"],
                     probe_y=prog.data["probe_y"], probe_mask=prog.data["probe_mask"],
                     evidential=True)
    rows = prog.init_flat
    group = prog.group
    if group is None:
        dense = pairwise_probe_eval(rows, ctx, evidential_trust_metric)
        circ = circulant_probe_eval(rows, offsets, ctx, evidential_trust_metric)
        own = self_probe_metrics(rows, ctx, evidential_trust_metric)
        return {"dense": _host(dense), "circulant": _host(circ), "self": _host(own)}
    windowed = group.bind(N, offsets)
    whole, window = exchange_rows(rows, group), exchange_rows(rows, windowed)
    with node_block_scope(group):
        dense = {k: gather_rows(v, group)
                 for k, v in pairwise_probe_eval(whole, ctx, evidential_trust_metric).items()}
        own = {k: gather_rows(v, group)
               for k, v in self_probe_metrics(rows, ctx, evidential_trust_metric).items()}
    with node_block_scope(windowed):
        circ = {k: gather_rows(v.T.contiguous(), group).T
                for k, v in circulant_probe_eval(window, offsets, ctx,
                                                 evidential_trust_metric).items()}
    return {"dense": _host(dense), "circulant": _host(circ), "self": _host(own),
            "window_rows": window.shape[0]}


# DMTT: G^t of a mobility model whose range keeps most of Krum's
# neighbourhoods above its constraint, TopB of 5.
DMTT_MOBILITY = {"area_size": 100.0, "comm_range": 60.0, "max_speed": 5.0, "seed": 42}
DMTT_B = 5
# UBAR's stage 2 filters at rho 0.8 (ubar_attack.yaml).
DMTT_RULE_PARAMS = {**RULE_PARAMS, "ubar": {"rho": 0.8}}


def dmtt_graphs(rounds: int):
    """The rounds' G^t, [N, N] float32."""
    mob = MobilityModel(N, **DMTT_MOBILITY)
    return [mob.adjacency_at(r).astype(np.float32) for r in range(rounds)]


def make_liar(inner: bool = True):
    """The topology liar at 25%, wrapping a gaussian attack at std 1 (or
    claims only)."""
    model_attack = make_gaussian_attack(N, 0.25, noise_std=1.0, seed=SEED) if inner else None
    return make_topology_liar_attack(N, 0.25, seed=SEED, model_attack=model_attack)


class _Recorded:
    """Record each round's cross-evaluation (the rank's rows) and whole
    exchange mask by wrapping core/rounds.py's two calls."""

    def __init__(self):
        self.cross, self.exchange = [], []

    def __enter__(self):
        probe, update = rounds_mod.pairwise_probe_eval, rounds_mod.dmtt_round_update
        self._saved = probe, update

        def recording_probe(*a, **k):
            out = probe(*a, **k)
            self.cross.append({k2: v.clone() for k2, v in out.items()})
            return out

        def recording_update(*a, **k):
            out = update(*a, **k)
            self.exchange.append(out[0].clone())
            return out

        rounds_mod.pairwise_probe_eval = recording_probe
        rounds_mod.dmtt_round_update = recording_update
        return self

    def __exit__(self, *exc):
        rounds_mod.pairwise_probe_eval, rounds_mod.dmtt_round_update = self._saved

    def whole(self, group):
        """The recorded cross-evaluations gathered whole, and the masks."""
        cross = [{k: (v if group is None else gather_rows(v, group)).cpu().numpy()
                  for k, v in c.items()} for c in self.cross]
        return cross, [e.cpu().numpy() for e in self.exchange]


def _dmtt_rounds(prog, attack, graphs, draws=None, generators=True):
    """Run the program's rounds on ``graphs``; returns the final flat and
    state, each round's host metrics and the recorder."""
    dev = prog.device
    comp = torch.from_numpy(attack.compromised.astype(np.float32)).to(dev)
    flat, state = prog.init_flat, prog.init_agg_state
    rounds = []
    with _Recorded() as rec:
        for r, adj in enumerate(graphs):
            kw = ({"generators": round_generators(SEED, r, dev)} if generators
                  else {"draws": draws[r]})
            flat, state, metrics = prog.train_step(flat, state, torch.from_numpy(adj).to(dev),
                                                   comp, float(r), **kw)
            rounds.append(_host({**prog.eval_step(flat), **metrics}))
    return flat, state, rounds, rec


def dmtt_case(spec):
    """``rounds`` (2) DMTT rounds of one rule (``spec``: rule) under the
    topology liar on the mobility model's G^t, the tiny MLP from spread
    initial parameters, audit taps on.  Returns the whole parameters and
    carried state, each round's metrics, cross-evaluation and exchange
    mask, and this process's exchange and collective counts."""
    rule, device = spec["rule"], spec.get("device", "cpu")
    model = tiny_model()
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    agg = build_aggregator(rule, dict(DMTT_RULE_PARAMS.get(rule, {})), model_dim=dim)
    attack = make_liar()
    prog = build_round_program(
        model, agg, tiny_data(), batch_size=8, lr=0.05, total_rounds=4, seed=SEED,
        attack=attack, init_params=spread_init(model), device=device, group=process_group(),
        dmtt=DMTTParams(budget_B=DMTT_B), audit_taps=True)
    reset_exchange_counts()
    flat, state, rounds, rec = _dmtt_rounds(prog, attack, dmtt_graphs(spec.get("rounds", 2)))
    counts = {"exchange": dict(EXCHANGE_COUNTS), "collectives": dict(COLLECTIVE_COUNTS)}
    cross, exchange = rec.whole(prog.group)
    return {"flat": _whole(flat, prog), "state": _whole_state(state, prog), "rounds": rounds,
            "cross": cross, "masks": exchange, "rows": tuple(flat.shape), "dim": dim,
            "row_state_keys": prog.row_state_keys, **counts}


def jax_dmtt_case(spec):
    """The JAX package's tiny DMTT program (``spec``: rule, init, one shuffle
    draw ``u`` a round, the rounds' graphs ``adj``) under the topology liar
    with claims only (no noise draw), rounds chained."""
    model = tiny_model()
    dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    agg = build_aggregator(spec["rule"], dict(spec["agg_params"]), model_dim=dim)
    attack = make_liar(inner=False)
    prog = build_round_program(
        model, agg, tiny_data(), local_epochs=1, batch_size=8, lr=0.05, total_rounds=4,
        seed=SEED, init_params=spec["init"], device="cpu", group=process_group(),
        attack=attack, dmtt=DMTTParams(budget_B=spec["budget_B"]))
    flat, state, rounds, rec = _dmtt_rounds(prog, attack, spec["adj"],
                                            draws=[{"u": [u]} for u in spec["u"]],
                                            generators=False)
    cross, exchange = rec.whole(prog.group)
    return {"flat": _whole(flat, prog), "state": _whole_state(state, prog), "rounds": rounds,
            "masks": exchange, "cross": cross}


def run_cases(cases):
    """Every (kind, spec) case in order, with this process's forbidden
    modules and kernel calls; what a node group's ranks run."""
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    fns = {"round": round_case, "jax_tiny": jax_tiny_case, "probe": probe_case,
           "network": network_case, "dmtt": dmtt_case, "jax_dmtt": jax_dmtt_case}
    mods = (agg_kernels, candidate_kernels, sketch_kernels)
    for mod in mods:
        mod.reset_counts()
    results = [fns[kind](spec) for kind, spec in cases]
    group = process_group()
    return {"results": results, "forbidden_modules": forbidden_modules(),
            "rank": None if group is None else group.rank,
            "launches": {k: v for mod in mods for k, v in mod.LAUNCHES.items()},
            "plain_calls": {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}}


def join_process(process_id: int, port: int, plan, out: str) -> None:
    """Process ``process_id`` of 2 joined over tcp at 127.0.0.1:``port``,
    one rank each on cuda:0 over gloo (the one-device seam), running
    :func:`run_cases` on ``plan`` in a node group of 2; pickles what the
    join returned to ``out``/``process_id``."""
    import pickle

    from murmura_tpu_torch.parallel.launch import join

    values = join(run_cases, (plan,), coordinator=f"127.0.0.1:{port}", num_processes=2,
                  process_id=process_id, device_type="cuda", one_device=True, axis="nodes")
    with open(f"{out}/{process_id}", "wb") as f:
        pickle.dump(values, f)
