"""The FL round (the PyTorch counterpart of the serialized round of
murmura_tpu/core/rounds.py).

    train_step(flat[N, P], agg_state, adj[N, N], compromised[N], round_idx,
               generators=None, draws=None) -> (flat', agg_state', metrics)

and, for a program built with a ``FaultSpec``, the [N] alive mask as
``alive=``.

1. local training: ``local_epochs`` x masked-batch SGD on every node at
   once — per-node effective batch ``min(B, max(2, n_i))``, sample
   positions ``pos % n_i``, the update masked by ``t < steps_i`` and by the
   honest mask (compromised nodes stay frozen), the update math in float32
   cast back to the parameter dtype; the loss is masked cross-entropy, or
   the annealed evidential loss for an evidential model, with dropout masks
   per node, step and layer where the model has dropout;
2. the attack on the broadcast copy only;
2b. with a ``FaultSpec`` (faults/schedule.py), in the JAX package's order:
   the adjacency re-masked by ``alive`` both ways and dead nodes frozen in
   training; NaN rows injected from ``nan_inject_from_round``; the
   quarantine sentinel (a non-finite row is *replaced* by its pre-round
   value and its edges dropped both ways: a multiplicative mask would not
   do, 0 * NaN = NaN in every Gram path and kernel); after the attack, a
   non-finite broadcast row replaced by its sender's own row and its
   sender column dropped;
2c. with a ``CompressionSpec`` the codec on the broadcast
   (ops/compress.py), its residual and reference carried in ``agg_state``
   under keys the rule never sees;
2d. with a ``StalenessSpec`` (core/stale.py) the bounded-staleness fold:
   a disrupted sender's base-graph edges re-added at weight
   ``discount ** age`` with its cached payload, the cache and ages carried
   in ``agg_state`` under keys the rule never sees;
3. the aggregation rule over (own, bcast, adj), with each node's probe
   batch (the first ``probe_size`` samples of its shard) in the context
   for the loss-probe rules, whose forwards run in eval mode; when
   faulted, a node with no alive neighbour keeps its own state, and dead
   or quarantined nodes keep their pre-round state;
4. ``eval_step`` (run by the orchestrator on the ``eval_every`` cadence):
   per-node masked loss and accuracy over the held-out arrays, and the
   Dirichlet vacuity, entropy and strength for an evidential model.

Steps 1-2d are ``produce_exchange``, step 3 and the guards the
aggregation.  A program built with ``pipeline=True`` (core/pipeline.py)
runs them in another order: it first aggregates the exchange that round
r-1 produced and left in the buffer carried in ``agg_state``, then
produces round r's, adds the delayed displacement to round r's trained
rows and swaps the buffer (``agg_pipe_valid`` is 0 on the warm-up round).

The node-stacked flat ``[N, P]`` tensor is the one copy of the parameters;
per-node gradients come from ``torch.func.vmap(torch.func.grad(...))`` over
views into it.  The random draws (the epoch shuffle ``u``, the dropout
masks and the attack's [C, P] noise) come from per-round
``torch.Generator``s, or are injected through ``draws`` so that a test can
feed the JAX package's own draws.

The phases run inside ``torch.profiler.record_function`` ranges named as
the JAX package's ``named_scope``s (``murmura.train``,
``murmura.exchange``, ``murmura.compress``, ``murmura.stale``,
``murmura.aggregate``, ``murmura.pipeline``, ``murmura.eval``), so a
profiler trace splits a round by phase.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
# torch.func.grad imports torch._dynamo on its first call, and that import
# runs torch.fx.wrap, whose frame holds itself (torch/fx/_symbolic_trace.py,
# ``currentframe = inspect.currentframe()``): a reference cycle that keeps
# every frame below it, the first run's Network and its parameters among
# them, until the cycle collector runs.  Imported here, the cycle holds
# import frames only.
import torch._dynamo  # noqa: F401
from torch.func import grad, vmap
from torch.profiler import record_function

from murmura_tpu_torch.aggregation.base import AggContext, AggregatorDef
from murmura_tpu_torch.attacks.base import Attack
from murmura_tpu_torch.core.pipeline import (
    ADJ_KEY as PIPE_ADJ_KEY,
    BCAST_KEY as PIPE_BCAST_KEY,
    OWN_KEY as PIPE_OWN_KEY,
    VALID_KEY as PIPE_VALID_KEY,
    init_pipeline_state,
    pipeline_state_keys,
)
from murmura_tpu_torch.core.stale import (
    CACHE_KEY as STALE_CACHE_KEY,
    STALE_STATE_KEYS,
    StalenessSpec,
    init_stale_state,
    make_stale_fold,
)
from murmura_tpu_torch.data.base import FederatedArrays
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.ops.compress import (
    COMPRESS_STATE_KEYS,
    CompressionSpec,
    compress_exchange,
    init_compress_state,
)
from murmura_tpu_torch.ops.flatten import (
    make_flatteners,
    tree_leaves,
    tree_map,
    tree_to_torch,
    tree_unflatten,
)
from murmura_tpu_torch.ops.losses import (
    evidential_loss,
    masked_cross_entropy,
    uncertainty_metrics,
)


# Eval samples per chunk (the JAX package's default eval_chunk).
EVAL_CHUNK = 1024

# Weight of the evidential loss's KL term once annealed in (the JAX
# factories' lambda_weight).
EVIDENTIAL_LAMBDA = 0.1


def pin_full_float32() -> None:
    """Keep float32 math in full float32 on the card.  cuDNN runs float32
    convolutions in TF32 by default (about three decimal digits), which
    would make the float32 path disagree with the JAX package and with the
    plain versions; the matmul flag is pinned too so that the setting is
    stated rather than inherited."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class RoundProgram:
    """The round step plus the pieces needed to drive it."""

    train_step: Callable
    eval_step: Callable
    init_flat: torch.Tensor  # [N, P]
    init_agg_state: Dict[str, torch.Tensor]
    data: Dict[str, torch.Tensor]
    num_nodes: int
    model_dim: int
    unravel: Callable
    device: torch.device
    evidential: bool = False
    # Built with a FaultSpec: train_step needs the [N] ``alive`` mask.
    faulted: bool = False
    compression: Optional[CompressionSpec] = None
    # Built with pipeline=True: train_step is the pipelined round.
    pipelined: bool = False
    # The production stage alone, for core/pipeline.run_delayed_reference.
    train_flat: Optional[Callable] = None


def round_generators(seed: int, round_idx: int, device) -> Dict[str, torch.Generator]:
    """Per-round generators for the shuffle and the attack noise: a pure
    function of (seed, round), like the JAX package's fold_in(key, round)."""
    train_seed, attack_seed = np.random.SeedSequence([seed, round_idx]).generate_state(2)
    gens = {}
    for name, s in (("train", train_seed), ("attack", attack_seed)):
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        gens[name] = g
    return gens


def init_stacked_params(model: Model, n: int, seed: int, device) -> Any:
    """Initial [N, ...]-stacked params, node after node from one generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    per_node = [model.init(g, device) for _ in range(n)]
    leaves = [tree_leaves(p) for p in per_node]
    return tree_unflatten(
        per_node[0], [torch.stack(group) for group in zip(*leaves)]
    )


def build_round_program(
    model: Model,
    agg: AggregatorDef,
    data: FederatedArrays,
    *,
    local_epochs: int = 1,
    batch_size: int = 64,
    lr: float = 0.01,
    total_rounds: int = 20,
    attack: Optional[Attack] = None,
    seed: int = 42,
    probe_size: Optional[int] = None,
    param_dtype: Optional[str] = None,
    device="cuda",
    init_params: Any = None,
    faults: Optional[FaultSpec] = None,
    compression: Optional[CompressionSpec] = None,
    audit_taps: bool = False,
    staleness: Optional[StalenessSpec] = None,
    pipeline: bool = False,
) -> RoundProgram:
    """Round step for a network of ``data.num_nodes`` nodes on ``device``
    (the card unless the caller asks for the CPU; without CUDA a ``cuda``
    device raises).

    ``init_params`` (a node-stacked pytree of tensors or numpy arrays in the
    JAX package's layout) replaces the seeded initialisation — the weight
    carry-over the tests use.  ``total_rounds`` is the T of the rules'
    threshold schedules.  ``probe_size`` is the samples a node hands the
    loss-probe rules (default: the round's batch).  An evidential model's
    KL term is annealed as ``min(1, round / max(1, total_rounds // 2)) *
    EVIDENTIAL_LAMBDA``.

    ``audit_taps`` (telemetry.audit_taps): the rules that tap add their
    per-node ``tap_*`` stats and a faulted round its ``tap_quarantined``,
    ``tap_attack_scrubbed`` and ``tap_alive`` flags, all as ``agg_tap_*``
    metrics; nothing else in the round changes.  ``staleness`` arms the
    bounded-staleness fold (step 2d), which needs ``faults``.
    ``pipeline`` (exchange.pipeline) builds the pipelined round
    (core/pipeline.py): round r adds the displacement of round r-1's
    buffered aggregation to its own training, the buffer carried in
    ``agg_state``.  The JAX package refuses it with DMTT, adaptive attacks
    and population, none of which the port runs (the schema refuses the
    combinations by name).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: build_round_program runs on the card "
                "by default; pass device='cpu' to run on the CPU"
            )
        pin_full_float32()
    n = data.num_nodes
    num_classes = data.num_classes or model.num_classes
    evidential = model.evidential

    if staleness is not None:
        if faults is None:
            raise ValueError(
                "bounded staleness (exchange.max_staleness) requires the "
                "fault model (build_round_program(faults=...)): without "
                "a fault schedule nothing ever misses a round and the "
                "cache layer would be dead weight in every program"
            )
        if staleness.base_mask is None:
            raise ValueError(
                "StalenessSpec.base_mask must carry the static base "
                "exchange graph (the topology mask / all-active sparse "
                "edge mask) — re-added edges are drawn from it"
            )
        if tuple(np.shape(staleness.base_mask)) != (n, n):
            raise ValueError(
                f"staleness base mask shape "
                f"{tuple(np.shape(staleness.base_mask))} does not match "
                f"this build's exchange layout {(n, n)}"
            )
        stale_fold = make_stale_fold(staleness, audit=audit_taps, device=device)
    else:
        stale_fold = None
    # The fold and the pipeline buffer carry one decoded row a sender (a
    # fresh/stale mix, or a buffered one), so under either every rule takes
    # the receiver-side decoded broadcast.
    quantized_payload = agg.quantized_exchange and stale_fold is None and not pipeline
    reserved = set(COMPRESS_STATE_KEYS) | (set(STALE_STATE_KEYS) if stale_fold is not None else set())
    pipe_keys = pipeline_state_keys(stale=stale_fold is not None)
    pipe_reserved = reserved | set(pipe_keys)

    eff_batch_np = data.effective_batch(batch_size)
    steps_np = data.steps_per_epoch(batch_size)
    max_steps = int(steps_np.max())
    global_batch = int(eff_batch_np.max())
    annealing_rounds = max(1, total_rounds // 2)
    p_size = int(min(data.max_samples, probe_size or global_batch))

    if init_params is None:
        stacked = init_stacked_params(model, n, seed, device)
    else:
        stacked = tree_to_torch(init_params, device, torch.float32)
    template = tree_map(lambda l: l[0], stacked)
    ravel, unravel, model_dim = make_flatteners(template)
    pdt = torch.float32 if param_dtype in (None, "float32") else getattr(torch, param_dtype)
    init_flat = ravel(stacked, batch_dims=1).to(pdt).contiguous()

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    eval_x, eval_y, eval_mask = data.eval_arrays
    d = {
        "x": dev(data.x, torch.float32),
        "y": dev(data.y, torch.int64),
        "mask": dev(data.mask, torch.float32),
        "num_samples": dev(data.num_samples, torch.int64),
        "eff_batch": dev(eff_batch_np, torch.int64),
        "steps": dev(steps_np, torch.int64),
        "eval_x": dev(eval_x, torch.float32),
        "eval_y": dev(eval_y, torch.int64),
        "eval_mask": dev(eval_mask, torch.float32),
    }
    d["probe_x"] = d["x"][:, :p_size]
    d["probe_y"] = d["y"][:, :p_size]
    d["probe_mask"] = d["mask"][:, :p_size]
    nodes = torch.arange(n, device=device)

    def node_loss(params_i, xb, yb, mb, masks_i, lambda_t):
        outputs = model.apply(params_i, xb, masks_i)
        if evidential:
            return evidential_loss(outputs, yb, mb, num_classes, lambda_t)
        loss, _ = masked_cross_entropy(outputs, yb, mb)
        return loss

    grad_fn = vmap(grad(node_loss), in_dims=(0, 0, 0, 0, 0, None))
    keep = 1.0 - model.dropout

    def dropout_masks(generator, injected):
        """This step's masks, one bool [N, B, width] a dropout layer."""
        if injected is not None:
            return [torch.as_tensor(np.asarray(m), dtype=torch.bool).to(device)
                    for m in injected]
        return [
            torch.rand((n, global_batch, w), generator=generator, device=device) < keep
            for w in model.dropout_widths
        ]

    def local_training(flat, train_mask, generator, u_draws, mask_draws, lambda_t):
        """local_epochs x masked-batch SGD; updates ``flat`` in place."""
        j = torch.arange(global_batch, device=device)
        batch_mask = (j[None, :] < d["eff_batch"][:, None]).to(torch.float32)
        samples = torch.clamp(d["num_samples"], min=1)[:, None]
        params = unravel(flat)
        for epoch in range(local_epochs):
            if u_draws is not None:
                u = torch.as_tensor(u_draws[epoch], dtype=torch.float32).to(device)
            else:
                u = torch.rand(
                    d["mask"].shape, generator=generator, device=device,
                    dtype=torch.float32,
                )
            # Shuffle valid samples to the front: invalid slots sort last.
            perm = torch.argsort(u + (1.0 - d["mask"]) * 10.0, dim=1, stable=True)
            for t in range(max_steps):
                pos = (t * d["eff_batch"][:, None] + j[None, :]) % samples
                idx = torch.gather(perm, 1, pos)  # [N, B]
                xb = d["x"][nodes[:, None], idx]
                yb = d["y"][nodes[:, None], idx]
                masks = []
                if model.dropout_widths:
                    masks = dropout_masks(
                        generator, None if mask_draws is None else mask_draws[epoch][t]
                    )
                grads = grad_fn(params, xb, yb, batch_mask, masks, lambda_t)
                update = train_mask * (t < d["steps"]).to(torch.float32)  # [N]
                with torch.no_grad():
                    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                        ub = update.reshape((n,) + (1,) * (p.dim() - 1))
                        p.copy_((p - (lr * ub) * g.to(torch.float32)).to(p.dtype))
        return flat

    ctx = AggContext(
        apply_fn=model.apply,
        unravel=unravel,
        probe_x=d["probe_x"],
        probe_y=d["probe_y"],
        probe_mask=d["probe_mask"],
        evidential=evidential,
        num_classes=num_classes,
        total_rounds=total_rounds,
        audit=audit_taps,
    )

    if faults is not None and faults.nan_inject_nodes:
        inject_rows = torch.zeros(n, dtype=torch.bool, device=device)
        inject_rows[list(faults.nan_inject_nodes)] = True
    else:
        inject_rows = None

    def both_ways(adj, flags):
        """Drop the edges whose receiver or sender has flag 0."""
        return adj * flags[:, None] * flags[None, :]

    def produce_exchange(flat, agg_state, adj, compromised, alive, round_idx, generators,
                         draws):
        """Steps 1-2d of the round, the production of its exchange: local
        training, the sentinels, the attack, the codec and the stale fold,
        shared by the serialized and pipelined rounds and by ``train_flat``.
        ``alive`` is None on an unfaulted program.  ``draws`` injects what
        the generators would draw: ``u`` one [N, S] uniform shuffle key an
        epoch; ``noise`` the attack's [C, P] normal draws; ``dropout`` the
        keep masks, indexed ``[epoch][step][layer]``, each a bool [N, B,
        width_l] (node, batch slot, unit) for the layers of
        ``model.dropout_widths``.  Returns the post-scrub ``own_flat``,
        ``bcast`` and ``adj`` as the serialized aggregation consumes them,
        ``pre_flat`` and ``finite`` (the quarantine bookkeeping), the
        updated ``agg_state`` and the stage stats."""
        generators = generators or {}
        draws = draws or {}
        lambda_t = min(1.0, round_idx / max(1, annealing_rounds)) * EVIDENTIAL_LAMBDA
        honest = 1.0 - compromised
        train_mask = (
            torch.ones_like(honest)
            if attack is not None and attack.trains_locally
            else honest
        )
        pre_flat = None
        if alive is not None:
            # Dead nodes freeze like compromised ones.  The adjacency is
            # re-masked by alive here even though the schedule's masked
            # adjacency folds it in already (alive * alive == alive).
            adj = both_ways(adj, alive)
            train_mask = train_mask * alive
            pre_flat = flat
        with record_function("murmura.train"):
            own_flat = local_training(
                flat.clone(), train_mask, generators.get("train"), draws.get("u"),
                draws.get("dropout"), lambda_t,
            )
        fault_stats = {}
        if inject_rows is not None and round_idx >= faults.nan_inject_from_round:
            own_flat = torch.where(
                inject_rows[:, None], torch.full_like(own_flat, float("nan")), own_flat
            )
        finite = None
        if faults is not None and faults.nan_quarantine:
            # A non-finite update quarantines the node for the round: its
            # row is replaced, not masked, before any rule math.
            finite = torch.isfinite(own_flat).all(dim=1)
            alive_f = alive if alive is not None else torch.ones_like(compromised)
            fault_stats["quarantined"] = ((1.0 - finite.to(torch.float32)) * alive_f).sum()
            if audit_taps:
                # Which node diverged, not just how many.
                fault_stats["tap_quarantined"] = (1.0 - finite.to(torch.float32)) * alive_f
            own_flat = torch.where(finite[:, None], own_flat, pre_flat)
            adj = both_ways(adj, finite.to(adj.dtype))
        bfin = None
        if attack is not None:
            noise = draws.get("noise")
            if noise is not None:
                noise = torch.as_tensor(np.asarray(noise)).to(device)
            with record_function("murmura.exchange"):
                bcast = attack.apply(
                    own_flat, compromised, generators.get("attack"), noise=noise
                )
            if finite is not None:
                # An attack that overflows to inf/NaN: its broadcast row is
                # replaced by the sender's own row and dropped from every
                # receiver; the sender's own state is untouched.
                bfin = torch.isfinite(bcast).all(dim=1)
                bcast = torch.where(bfin[:, None], bcast, own_flat)
                adj = adj * bfin.to(adj.dtype)[None, :]
                fault_stats["attack_scrubbed"] = (1.0 - bfin.to(torch.float32)).sum()
                if audit_taps:
                    fault_stats["tap_attack_scrubbed"] = 1.0 - bfin.to(torch.float32)
        else:
            bcast = own_flat
        compress_stats = {}
        if compression is not None:
            with record_function("murmura.compress"):
                bcast, _, updates, compress_stats = compress_exchange(
                    compression, bcast, agg_state, quantized_payload
                )
            agg_state = {**agg_state, **updates}
        stale_stats = {}
        if stale_fold is not None:
            # Between the codec and the rule: the sentinels' verdicts gate
            # the senders (a caught row's cached copy is withheld), alive
            # and finite the receivers (their fresh edges were zeroed both
            # ways); an attack-scrubbed sender still receives.
            scrub_ok = torch.ones_like(compromised)
            if finite is not None:
                scrub_ok = scrub_ok * finite.to(torch.float32)
            if bfin is not None:
                scrub_ok = scrub_ok * bfin.to(torch.float32)
            recv_ok = alive
            if finite is not None:
                recv_ok = recv_ok * finite.to(torch.float32)
            with record_function("murmura.stale"):
                bcast, adj, updates, stale_stats = stale_fold(
                    bcast, adj, {k: agg_state[k] for k in STALE_STATE_KEYS}, recv_ok,
                    scrub_ok,
                )
            agg_state = {**agg_state, **updates}
        return {
            "own_flat": own_flat, "bcast": bcast, "adj": adj, "pre_flat": pre_flat,
            "finite": finite, "agg_state": agg_state, "fault_stats": fault_stats,
            "compress_stats": compress_stats, "stale_stats": stale_stats,
        }

    def stats_metrics(agg_stats, prod):
        metrics = {f"agg_{k}": v for k, v in agg_stats.items()}
        for group in ("fault_stats", "compress_stats", "stale_stats"):
            metrics.update({f"agg_{k}": v for k, v in prod[group].items()})
        return metrics

    def round_body(flat, agg_state, adj, compromised, alive, round_idx, generators, draws):
        """One serialized round: produce the exchange, aggregate it, then
        the fault guards."""
        prod = produce_exchange(flat, agg_state, adj, compromised, alive, round_idx,
                                generators, draws)
        own_flat, adj, agg_state = prod["own_flat"], prod["adj"], prod["agg_state"]
        rule_state = {k: v for k, v in agg_state.items() if k not in reserved}
        with record_function("murmura.aggregate"):
            new_flat, rule_state, agg_stats = agg.aggregate(
                own_flat, prod["bcast"], adj, round_idx, rule_state, ctx
            )
        agg_state = {**agg_state, **rule_state}
        if alive is not None:
            # No alive neighbour: the node keeps its own state.  Dead nodes
            # freeze at the pre-round value, quarantined ones roll back.
            deg = adj.sum(dim=1)
            new_flat = torch.where((deg > 0)[:, None], new_flat, own_flat)
            keep = alive > 0
            if prod["finite"] is not None:
                keep = keep & prod["finite"]
            new_flat = torch.where(keep[:, None], new_flat, prod["pre_flat"])
            prod["fault_stats"]["alive"] = alive.sum()
            if audit_taps:
                prod["fault_stats"]["tap_alive"] = alive
        return new_flat, agg_state, stats_metrics(agg_stats, prod)

    def round_body_pipelined(flat, agg_state, adj, compromised, alive, round_idx, generators,
                             draws):
        """One pipelined round (core/pipeline.py): stage A aggregates the
        buffered round r-1 exchange, stage B produces round r's, stage C
        adds the delayed displacement and swaps the buffer.  Stage A comes
        first in program order, so that it can later run beside training."""
        # ---- stage A: the delayed aggregation of the buffer ----
        valid = agg_state[PIPE_VALID_KEY]
        buf_own = agg_state[PIPE_OWN_KEY]
        if stale_fold is not None:
            # The stale cache is the post-fold broadcast of round r-1: read
            # it before stage B advances it to round r's.
            buf_bcast = agg_state[STALE_CACHE_KEY].to(buf_own.dtype)
        else:
            buf_bcast = agg_state[PIPE_BCAST_KEY]
        buf_adj = agg_state[PIPE_ADJ_KEY]
        rule_state = {k: v for k, v in agg_state.items() if k not in pipe_reserved}
        with record_function("murmura.aggregate"):
            # The buffer belongs to round r-1; round 0's is the invalid
            # placeholder, whose output and state are discarded below.
            agg_out, rule_state_new, agg_stats = agg.aggregate(
                buf_own, buf_bcast, buf_adj, max(round_idx - 1.0, 0.0), rule_state, ctx
            )
        if alive is not None:
            # The zero-alive-neighbour guard at the buffered graph.
            deg_b = buf_adj.sum(dim=1)
            agg_out = torch.where((deg_b > 0)[:, None], agg_out, buf_own)
        # where, not multiply: a non-finite placeholder output is dropped.
        disp = torch.where(valid > 0, agg_out - buf_own, torch.zeros_like(buf_own))
        del agg_out  # not held through stage B's training
        rule_state = {
            k: torch.where(valid > 0, v, rule_state[k]) if k in rule_state else v
            for k, v in rule_state_new.items()
        }
        # ---- stage B: the production of round r's exchange ----
        prod = produce_exchange(flat, agg_state, adj, compromised, alive, round_idx,
                                generators, draws)
        own_flat, agg_state = prod["own_flat"], prod["agg_state"]
        # ---- stage C: combine and swap the buffer ----
        with record_function("murmura.pipeline"):
            new_flat = own_flat + disp.to(own_flat.dtype)
            if alive is not None:
                # Dead and quarantined rows: own_flat already equals the
                # pre-round rows there, so the keep-mask discards the
                # displacement.
                keep = alive > 0
                if prod["finite"] is not None:
                    keep = keep & prod["finite"]
                new_flat = torch.where(keep[:, None], new_flat, prod["pre_flat"])
                prod["fault_stats"]["alive"] = alive.sum()
                if audit_taps:
                    prod["fault_stats"]["tap_alive"] = alive
        buffer = {PIPE_OWN_KEY: own_flat, PIPE_ADJ_KEY: prod["adj"],
                  PIPE_VALID_KEY: torch.ones_like(valid)}
        if stale_fold is None:
            buffer[PIPE_BCAST_KEY] = prod["bcast"]
        agg_state = {**agg_state, **rule_state, **buffer}
        metrics = stats_metrics(agg_stats, prod)
        # 0 on the warm-up round: its agg_* stats describe the placeholder.
        metrics["agg_pipe_valid"] = valid
        return new_flat, agg_state, metrics

    body = round_body_pipelined if pipeline else round_body

    def check_alive(alive):
        if faults is not None and alive is None:
            raise ValueError("a faulted round program needs the [N] alive mask")
        if faults is None and alive is not None:
            raise ValueError("an alive mask was given to a round program built without faults")

    def train_step(
        flat: torch.Tensor,
        agg_state: Dict[str, torch.Tensor],
        adj: torch.Tensor,
        compromised: torch.Tensor,
        round_idx: float,
        generators: Optional[Dict[str, torch.Generator]] = None,
        draws: Optional[Dict[str, Any]] = None,
        alive: Optional[torch.Tensor] = None,
    ):
        """One round (round_body, or round_body_pipelined on a pipelined
        program); a faulted program needs ``alive``."""
        check_alive(alive)
        return body(flat, agg_state, adj, compromised, alive, round_idx, generators, draws)

    def train_flat(flat, agg_state, adj, compromised, round_idx, generators=None, draws=None,
                   alive=None):
        """The production stage alone (for core/pipeline.run_delayed_reference):
        (the trained post-scrub [N, P] rows, [N] 1 where the node's update
        was finite)."""
        check_alive(alive)
        prod = produce_exchange(flat, agg_state, adj, compromised, alive, round_idx,
                                generators, draws)
        ok = (prod["finite"].to(torch.float32) if prod["finite"] is not None
              else torch.ones_like(compromised))
        return prod["own_flat"], ok

    apply_nodes = vmap(model.apply)

    @torch.no_grad()
    @record_function("murmura.eval")
    def eval_step(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, y, mask = d["eval_x"], d["eval_y"], d["eval_mask"]
        params = unravel(flat)
        s = x.shape[1]
        chunk = max(1, min(EVAL_CHUNK, s))
        names = ("loss", "accuracy") + (
            ("vacuity", "entropy", "strength") if evidential else ())
        sums = {k: torch.zeros(n, device=device) for k in names}
        count = torch.zeros(n, device=device)
        for c0 in range(0, s, chunk):
            xc, yc, mc = x[:, c0:c0 + chunk], y[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
            outputs = apply_nodes(params, xc)  # [N, c, K]
            if evidential:
                unc = uncertainty_metrics(outputs)
                p_y = torch.gather(unc["probs"], -1, yc[..., None])[..., 0]
                nll = -torch.log(p_y + 1e-10)
                for k in ("vacuity", "entropy", "strength"):
                    sums[k] += (unc[k] * mc).sum(dim=1)
            else:
                logp = torch.log_softmax(outputs, dim=-1)
                nll = -torch.gather(logp, -1, yc[..., None])[..., 0]
            sums["loss"] += (nll * mc).sum(dim=1)
            sums["accuracy"] += (
                (torch.argmax(outputs, -1) == yc).to(torch.float32) * mc).sum(dim=1)
            count += mc.sum(dim=1)
        total = torch.clamp(count, min=1.0)
        return {k: v / total for k, v in sums.items()}

    init_agg_state = {
        k: torch.as_tensor(np.asarray(v)).to(device) for k, v in agg.init_state(n).items()
    }
    if compression is not None:
        clash = set(COMPRESS_STATE_KEYS) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the compressed exchange"
            )
        # The top-k reference starts at the initial broadcast, which a
        # deployment sends in full once at set-up.
        init_agg_state.update(init_compress_state(compression, init_flat))
    if staleness is not None:
        clash = set(STALE_STATE_KEYS) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the bounded-staleness exchange"
            )
        init_agg_state.update(
            init_stale_state(staleness, n, model_dim, init_flat.dtype, device))
    if pipeline:
        clash = set(pipe_keys) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the pipelined exchange"
            )
        init_agg_state.update(init_pipeline_state(
            n, model_dim, init_flat.dtype, stale=staleness is not None, device=device))
    return RoundProgram(
        train_step=train_step,
        eval_step=eval_step,
        init_flat=init_flat,
        init_agg_state=init_agg_state,
        data=d,
        num_nodes=n,
        model_dim=model_dim,
        unravel=unravel,
        device=device,
        evidential=evidential,
        faulted=faults is not None,
        compression=compression,
        pipelined=pipeline,
        train_flat=train_flat,
    )


def build_multi_round(program: RoundProgram, chunk: int, eval_every: int) -> Callable:
    """Fuse ``chunk`` rounds into one call (the counterpart of the JAX
    package's ``build_multi_round``, a ``lax.scan`` there, the rounds'
    launches queued back to back here):

        multi_round(flat, agg_state, seed, adj_stack[chunk, N, N],
                    compromised, round0, alive_stack=None)
            -> (flat', agg_state', rows)

    Round ``round0 + i`` takes ``adj_stack[i]`` (and, on a faulted program,
    ``alive_stack[i]``, which it then requires) and its generators from
    (seed, round), so the history does not
    depend on the chunking.  ``rows`` holds one (round number, metrics) pair
    per round on the ``eval_every`` cadence, the eval and ``agg_*`` metrics
    left on the device.  Nothing here synchronises with the host.
    """

    def multi_round(flat, agg_state, seed, adj_stack, compromised, round0, alive_stack=None):
        rows = []
        for i in range(chunk):
            r = round0 + i
            flat, agg_state, metrics = program.train_step(
                flat, agg_state, adj_stack[i], compromised, float(r),
                generators=round_generators(seed, r, program.device),
                alive=None if alive_stack is None else alive_stack[i],
            )
            if (r + 1) % eval_every == 0:
                rows.append((r + 1, {**program.eval_step(flat), **metrics}))
        return flat, agg_state, rows

    return multi_round

