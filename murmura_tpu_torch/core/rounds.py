"""The FL round (the PyTorch counterpart of the serialized round of
murmura_tpu/core/rounds.py).

    train_step(flat[N, P], agg_state, adj[N, N], compromised[N], round_idx,
               generators=None, draws=None) -> (flat', agg_state', metrics)

and, for a program built with a ``FaultSpec``, the [N] alive mask as
``alive=``.  A program built with ``sparse_offsets`` (a sparse topology,
topology/sparse.py) takes the [k, N] per-offset edge mask where the dense
one takes the [N, N] adjacency: ``adj[j, i]`` is the edge ``i <- (i +
offsets[j]) % N``, and every adjacency fold below runs on it through rolls
of [N] node flags, so nothing O(N^2) is built.

1. local training: ``local_epochs`` x masked-batch SGD on every node at
   once — per-node effective batch ``min(B, max(2, n_i))``, sample
   positions ``pos % n_i``, the update masked by ``t < steps_i`` and by the
   honest mask (compromised nodes stay frozen), the update math in float32
   cast back to the parameter dtype; the loss is masked cross-entropy, or
   the annealed evidential loss for an evidential model, with dropout masks
   per node, step and layer where the model has dropout;
2. the attack on the broadcast copy only (an adaptive attack at the
   strength its state in ``agg_state`` sets, attacks/adaptive.py);
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
2e. with ``DMTTParams`` (dmtt/protocol.py) the trust protocol, between the
   production and the aggregation: the topology claims (a liar's
   ``claims_fn``, else the true graph), the dense [N, N] probe
   cross-evaluation of the broadcast (``probe.combined_probe_metric``),
   ``dmtt_round_update``, whose exchange mask becomes the rule's adjacency,
   and the cross-evaluation handed to the probe rules as
   ``ctx.probe_cross``; the trust state carried in ``agg_state`` under
   ``DMTT_STATE_KEYS``, which the rule never sees;
3. the aggregation rule over (own, bcast, adj), with each node's probe
   batch (the first ``probe_size`` samples of its shard) in the context
   for the loss-probe rules, whose forwards run in eval mode; when
   faulted, a node with no alive neighbour keeps its own state, and dead
   or quarantined nodes keep their pre-round state; between the rule and
   those guards an adaptive attack reads the rule's audit taps and updates
   its state;
4. ``eval_step`` (run by the orchestrator on the ``eval_every`` cadence):
   per-node masked loss and accuracy over the held-out arrays, and the
   Dirichlet vacuity, entropy and strength for an evidential model.

A program built with ``param_shards`` > 1 pads the flat vector to a
multiple of the shard count (``flat_dim``, the pad columns exact zeros,
zeroed again after every round as the JAX package's ravel does).  Built
with a ``group`` (parallel/mesh.py) it is one rank of a param group:
``flat`` is the rank's own node rows ``[R_r, flat_dim]``, local training
and eval run on them (the draws taken whole and cut to the rows, so that
every draw keeps the unsharded run's bits), ``rows_to_columns`` turns the
trained rows into the rank's ``[N, flat_dim / W]`` column block, the whole
aggregation side (steps 2-3, the carried [N, P] state included) runs on
column blocks under ``param_group_scope``, and ``columns_to_rows`` returns
the new rows; eval's per-node metrics are gathered over the group.

``train_step(..., data=)`` runs the round on other rows of the data
arrays than the program's own (the population engine's cohort, whose
slots train, probe and evaluate on their users' shards), the program's
data left as it is.

Steps 1-2d are ``produce_exchange``, step 2e the DMTT gate (serialized
rounds only), step 3 and the guards the aggregation.  A program built with ``pipeline=True`` (core/pipeline.py)
runs them in another order: it first aggregates the exchange that round
r-1 produced and left in the buffer carried in ``agg_state``, then
produces round r's, adds the delayed displacement to round r's trained
rows and swaps the buffer (``agg_pipe_valid`` is 0 on the warm-up round).

The node-stacked flat ``[N, P]`` tensor is the one copy of the parameters;
per-node gradients come from ``torch.func.vmap(torch.func.grad(...))`` over
views into it.  Local training and eval take any stack of rows
(``RoundProgram.train_rows`` and ``eval_step(flat, data=...)``): a gang
(core/gang.py) passes its S members' N rows each as one [S*N, P] stack,
each member's draws from that member's own generators, and then hands each
member's trained rows to its ``train_step(..., trained=rows)``, which skips
local training and runs the rest of the round.  The random draws (the
epoch shuffle ``u``, the dropout masks and the attack's [C, P] noise) come
from per-round
``torch.Generator``s, or are injected through ``draws`` so that a test can
feed the JAX package's own draws.

The phases run inside ``torch.profiler.record_function`` ranges named as
the JAX package's ``named_scope``s (``murmura.train``,
``murmura.exchange`` (the attack, and DMTT's claims, cross-evaluation and
trust update), ``murmura.compress``, ``murmura.stale``,
``murmura.aggregate``, ``murmura.pipeline``, ``murmura.eval``), so a
profiler trace splits a round by phase.
"""

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
from murmura_tpu_torch.aggregation.probe import combined_probe_metric, pairwise_probe_eval
from murmura_tpu_torch.attacks.adaptive import AdaptiveAttack, acceptance_feedback
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
from murmura_tpu_torch.dmtt.protocol import DMTTParams, dmtt_round_update, init_dmtt_state
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.levers import refusal_reason
from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.ops.compress import (
    COMPRESS_STATE_KEYS,
    CompressionSpec,
    compress_exchange,
    init_compress_state,
)
from murmura_tpu_torch.ops.flatten import (
    make_flatteners,
    make_sharded_flatteners,
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
from murmura_tpu_torch.parallel.mesh import (
    ParamGroup,
    all_columns,
    block,
    columns_to_rows,
    gather_rows,
    param_group_scope,
    rows_to_columns,
)


# Eval samples per chunk (the JAX package's default eval_chunk).
EVAL_CHUNK = 1024

# The per-node data a round trains on and evaluates on: what a gang stacks
# over its members (core/gang.py).
TRAIN_DATA_KEYS = ("x", "y", "mask", "num_samples", "eff_batch", "steps")
EVAL_DATA_KEYS = ("eval_x", "eval_y", "eval_mask")

# The rules whose probe forwards need whole neighbour rows: not run over a
# param group.
PROBE_RULES = ("ubar", "evidential_trust")

# Weight of the evidential loss's KL term once annealed in (the JAX
# factories' lambda_weight).
EVIDENTIAL_LAMBDA = 0.1


def evidential_lambda(round_idx, annealing_rounds: int) -> float:
    """The evidential KL weight of round ``round_idx``: annealed in linearly
    over ``annealing_rounds`` up to ``EVIDENTIAL_LAMBDA``."""
    return min(1.0, round_idx / max(1, annealing_rounds)) * EVIDENTIAL_LAMBDA

# The DMTT trust state carried in agg_state (dmtt/protocol.py), which the
# rule never sees.
DMTT_STATE_KEYS = (
    "dmtt_c_hat",
    "dmtt_alpha",
    "dmtt_beta",
    "dmtt_collab",
    "dmtt_selected",
)


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
    # Local training over any stack of rows (a gang's members folded into
    # the node axis): train_rows(flat_rows, train_mask_rows, round_idx,
    # generators, data=None, step_lr=None, draws=None) -> trained rows.
    train_rows: Optional[Callable] = None
    # The [N] training mask of a round: honest (or everyone, for an attack
    # that trains locally) and, on a faulted program, alive.
    training_mask: Optional[Callable] = None
    # The circulant offsets of a sparse program (its adjacency input is the
    # [k, N] edge mask); () for the dense [N, N] adjacency.
    sparse_offsets: Tuple[int, ...] = ()
    # The DMTT parameters of a program that runs the trust protocol.
    dmtt: Optional[DMTTParams] = None
    # Param-axis sharding: the shard count the flat vector is padded for,
    # its padded width (== model_dim unless padded), the rank's bound group
    # (None: one process) and the agg_state keys held as [N, flat_dim / W]
    # column blocks under a group.
    param_shards: int = 1
    flat_dim: int = 0
    group: Optional[ParamGroup] = None
    sharded_state_keys: Tuple[str, ...] = ()

    @property
    def sparse(self) -> bool:
        return bool(self.sparse_offsets)


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


def init_stacked_params(model: Model, n: int, seed: int, device,
                        rows: Optional[Tuple[int, int]] = None) -> Any:
    """Initial [N, ...]-stacked params, node after node from one generator;
    ``rows`` keeps the nodes [lo, hi) of that stream only."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lo, hi = (0, n) if rows is None else rows
    per_node = []
    for i in range(hi):
        params = model.init(g, device)
        if i >= lo:
            per_node.append(params)
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
    sparse_offsets: Optional[Sequence[int]] = None,
    attack_scale: Optional[float] = None,
    dmtt: Optional[DMTTParams] = None,
    param_shards: int = 1,
    group: Optional[ParamGroup] = None,
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
    ``agg_state``.  It does not compose with DMTT (refused here) nor with
    population (refused by the schema).

    ``sparse_offsets`` (a sparse topology's offsets) makes the adjacency
    input the [k, N] edge mask.  ``attack_scale`` (a gang member's
    ``attack_scale``, the JAX package's ``hp_attack_scale``) scales the
    perturbation the attack added to the broadcast, in float32, before the
    sentinel scrub; None leaves the broadcast as the attack made it.
    ``dmtt`` runs the trust protocol (step 2e) on the dense exchange; it
    refuses the sparse exchange, compression, staleness and pipelining, as
    the JAX package does.

    ``param_shards`` (tpu.param_shards) pads the flat vector to a multiple
    of the shard count; with it DMTT, top-k compression and an int8 block
    that does not divide the shard-local width are refused in the JAX
    package's words.  ``group`` (a rank's ParamGroup, its world the shard
    count or a divisor of it, as the layout's fallback picks) builds that
    rank's program (module docstring); it also refuses
    a gang's trained rows, another ``data=`` and the probe rules (UBAR and
    evidential trust, whose probe forwards need whole neighbour rows).

    An adaptive ``attack`` (attacks/adaptive.py) turns ``audit_taps`` on:
    the taps are its feedback.  Its state rides ``agg_state`` under its
    ``state_keys``, which the rule never sees; after the rule,
    ``acceptance_feedback`` and ``update_attack_state`` write the next
    round's state, and the metrics gain ``agg_atk_*`` (the state masked to
    the compromised rows) and ``agg_atk_accept``.  It refuses DMTT and the
    pipelined round.
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
    sparse_offsets = tuple(int(o) for o in sparse_offsets) if sparse_offsets else ()
    sparse = bool(sparse_offsets)
    if attack_scale is not None and attack is None:
        raise ValueError(
            "attack_scale was given but no attack is configured: there is no "
            "broadcast perturbation to scale"
        )
    if dmtt is not None:
        for clash, why in (
            (sparse, "sparse exchange mode does not compose with DMTT (claim "
                     "verification needs the dense per-round exchange graph)"),
            (compression is not None,
             "compressed exchange does not compose with DMTT (the claim "
             "cross-evaluation consumes the uncompressed broadcast)"),
            (staleness is not None,
             "bounded staleness does not compose with DMTT (the exchange graph "
             "is trust-gated per round; serving a cached row would bypass the "
             "round's claim verification)"),
            (pipeline, "pipelined rounds do not compose with DMTT (the claim "
                       "exchange and trust gate run between production and "
                       "aggregation every round; delaying the aggregation would "
                       "verify claims against a different round's graph)"),
        ):
            if clash:
                raise ValueError(why)
    param_shards = int(param_shards)
    if param_shards < 1:
        raise ValueError(f"param_shards must be >= 1, got {param_shards}")
    if group is not None and param_shards % group.world:
        raise ValueError(
            f"the param group's {group.world} ranks do not divide the program's "
            f"param_shards={param_shards}")
    if group is not None and group.world > n:
        raise ValueError(
            f"a param group of {group.world} ranks needs at least {group.world} nodes "
            f"(each rank trains its own node rows), but there are {n}: lower "
            f"tpu.param_shards (or tpu.num_devices) to at most {n}")
    if param_shards > 1:
        if dmtt is not None:
            raise ValueError(
                "param-axis sharding does not compose with DMTT (the "
                "N x N claim cross-evaluation unravels every broadcast "
                "row into a full model per pair — there is no sharded "
                "formulation of that sweep)"
            )
        if compression is not None and compression.algorithm == "topk":
            raise ValueError(
                "param-axis sharding does not compose with topk "
                "compression: the per-row global top-k needs the full "
                "[P] row resident on one device, defeating the shard — "
                "use the int8 codec (its per-block scales shard with P)"
            )
    if group is not None and agg.name in PROBE_RULES:
        raise ValueError(
            f"param-axis sharding over a process group does not run {agg.name} yet: "
            "its probe forwards (aggregation/probe.py) need whole neighbour rows, "
            "which a rank holds only as a column block")
    claims_fn = attack.claims_fn if attack is not None else None
    adaptive = isinstance(attack, AdaptiveAttack)
    if adaptive:
        if dmtt is not None:
            raise ValueError(refusal_reason("adaptive", "dmtt"))
        if pipeline:
            raise ValueError(refusal_reason("adaptive", "pipeline"))
        audit_taps = True

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
        expect = (len(sparse_offsets), n) if sparse else (n, n)
        if tuple(np.shape(staleness.base_mask)) != expect:
            raise ValueError(
                f"staleness base mask shape "
                f"{tuple(np.shape(staleness.base_mask))} does not match "
                f"this build's exchange layout {expect}"
            )
        stale_fold = make_stale_fold(staleness, sparse_offsets=sparse_offsets,
                                     audit=audit_taps, device=device)
    else:
        stale_fold = None
    # The fold and the pipeline buffer carry one decoded row a sender (a
    # fresh/stale mix, or a buffered one), so under either every rule takes
    # the receiver-side decoded broadcast.
    quantized_payload = agg.quantized_exchange and stale_fold is None and not pipeline
    reserved = (set(COMPRESS_STATE_KEYS) | set(DMTT_STATE_KEYS)
                | (set(STALE_STATE_KEYS) if stale_fold is not None else set())
                | (set(attack.state_keys) if adaptive else set()))
    pipe_keys = pipeline_state_keys(stale=stale_fold is not None)
    pipe_reserved = reserved | set(pipe_keys)

    eff_batch_np = data.effective_batch(batch_size)
    steps_np = data.steps_per_epoch(batch_size)
    max_steps = int(steps_np.max())
    global_batch = int(eff_batch_np.max())
    annealing_rounds = max(1, total_rounds // 2)
    p_size = int(min(data.max_samples, probe_size or global_batch))

    rows = None if group is None else block(n, group.world, group.rank)
    if init_params is None and rows is None:
        stacked = init_stacked_params(model, n, seed, device)
    elif init_params is None:
        stacked = init_stacked_params(model, n, seed, device, rows=rows)
    else:
        stacked = tree_to_torch(init_params, device, torch.float32)
        if rows is not None:
            stacked = tree_map(lambda l: l[rows[0]:rows[1]].contiguous(), stacked)
    template = tree_map(lambda l: l[0], stacked)
    if param_shards > 1:
        ravel, unravel, model_dim, flat_dim = make_sharded_flatteners(template, param_shards)
    else:
        ravel, unravel, model_dim = make_flatteners(template)
        flat_dim = model_dim
    if group is not None:
        group = group.bind(n, flat_dim)
    if param_shards > 1 and compression is not None:
        # int8 per-block scales must shard with the payload: a block that
        # straddled a shard boundary would take its scale across shards.
        local = flat_dim // param_shards
        if local % compression.block:
            raise ValueError(
                f"compression.block={compression.block} does not divide "
                f"the shard-local flat width {local} (flat_dim "
                f"{flat_dim} over {param_shards} param shards) — a quant "
                "block straddling a shard boundary would compute its "
                "scale across shards; pick a block dividing "
                f"{local} (or adjust tpu.param_shards)"
            )
    # The width of every carried [N, P] tensor: a column block under a group.
    state_width = flat_dim if group is None else group.local_cols
    pdt = torch.float32 if param_dtype in (None, "float32") else getattr(torch, param_dtype)
    init_flat = ravel(stacked, batch_dims=1).to(pdt).contiguous()

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    def dev_inputs(a):
        """Model inputs: integer tokens stay integer (int64, what an
        embedding lookup takes), anything else becomes float32."""
        a = np.asarray(a)
        return dev(a, torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32)

    eval_x, eval_y, eval_mask = data.eval_arrays
    d = {
        "x": dev_inputs(data.x),
        "y": dev(data.y, torch.int64),
        "mask": dev(data.mask, torch.float32),
        "num_samples": dev(data.num_samples, torch.int64),
        "eff_batch": dev(eff_batch_np, torch.int64),
        "steps": dev(steps_np, torch.int64),
        "eval_x": dev_inputs(eval_x),
        "eval_y": dev(eval_y, torch.int64),
        "eval_mask": dev(eval_mask, torch.float32),
    }
    d["probe_x"] = d["x"][:, :p_size]
    d["probe_y"] = d["y"][:, :p_size]
    d["probe_mask"] = d["mask"][:, :p_size]
    # The rows a rank trains and evaluates (all of them in one process).
    own_rows = slice(0, n) if group is None else slice(*group.rows)
    d_own = d if group is None else {
        k: d[k][own_rows] for k in TRAIN_DATA_KEYS + EVAL_DATA_KEYS}

    def node_loss(params_i, xb, yb, mb, masks_i, lambda_t):
        outputs = model.apply(params_i, xb, masks_i)
        if evidential:
            return evidential_loss(outputs, yb, mb, num_classes, lambda_t)
        loss, _ = masked_cross_entropy(outputs, yb, mb)
        return loss

    grad_fn = vmap(grad(node_loss), in_dims=(0, 0, 0, 0, 0, None))
    keep = 1.0 - model.dropout

    def member_draws(generators, draw):
        """One draw a member from its own generator, stacked on the row
        axis in member order: each member's rows get exactly the values its
        single run would draw (a single run's one draw is taken as is)."""
        parts = [draw(g) for g in generators]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def dropout_masks(generators, rows_each, injected):
        """This step's masks, one bool [rows, B, width] a dropout layer."""
        if injected is not None:
            return [torch.as_tensor(np.asarray(m), dtype=torch.bool).to(device)
                    for m in injected]
        return [
            member_draws(generators, lambda g: torch.rand(
                (rows_each, global_batch, w), generator=g, device=device) < keep)
            for w in model.dropout_widths
        ]

    def local_training(flat, dd, train_mask, generators, u_draws, mask_draws, lambda_t,
                       step_lr):
        """local_epochs x masked-batch SGD over the rows of ``flat`` (a
        member's N, or a gang's S*N, with the matching rows of the data
        ``dd``); updates ``flat`` in place.  ``generators``: one "train"
        generator a member, in row order; ``step_lr`` the learning rate, a
        float or one value a row."""
        rows = flat.shape[0]
        rows_each, cut = rows // len(generators), None
        if group is not None:
            # Each draw is the whole network's, cut to this rank's rows, so
            # that it keeps the unsharded run's bits.
            rows_each, cut = n, own_rows
        rows_idx = torch.arange(rows, device=device)
        j = torch.arange(global_batch, device=device)
        batch_mask = (j[None, :] < dd["eff_batch"][:, None]).to(torch.float32)
        samples = torch.clamp(dd["num_samples"], min=1)[:, None]
        params = unravel(flat)
        for epoch in range(local_epochs):
            if u_draws is not None:
                u = torch.as_tensor(u_draws[epoch], dtype=torch.float32).to(device)
            else:
                u = member_draws(generators, lambda g: torch.rand(
                    (rows_each,) + tuple(dd["mask"].shape[1:]), generator=g,
                    device=device, dtype=torch.float32,
                ))
            if cut is not None:
                u = u[cut]
            # Shuffle valid samples to the front: invalid slots sort last.
            perm = torch.argsort(u + (1.0 - dd["mask"]) * 10.0, dim=1, stable=True)
            for t in range(max_steps):
                pos = (t * dd["eff_batch"][:, None] + j[None, :]) % samples
                idx = torch.gather(perm, 1, pos)  # [rows, B]
                xb = dd["x"][rows_idx[:, None], idx]
                yb = dd["y"][rows_idx[:, None], idx]
                masks = []
                if model.dropout_widths:
                    masks = dropout_masks(
                        generators, rows_each,
                        None if mask_draws is None else mask_draws[epoch][t],
                    )
                    if cut is not None:
                        masks = [m[cut] for m in masks]
                grads = grad_fn(params, xb, yb, batch_mask, masks, lambda_t)
                update = train_mask * (t < dd["steps"]).to(torch.float32)  # [rows]
                lr_update = step_lr * update
                with torch.no_grad():
                    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                        lr_ub = lr_update.reshape((rows,) + (1,) * (p.dim() - 1))
                        p.copy_((p - lr_ub * g.to(torch.float32)).to(p.dtype))
        return flat

    def train_rows(flat, train_mask, round_idx, generators, data=None, step_lr=None,
                   draws=None):
        """Local training of the rows of ``flat`` in place (RoundProgram.
        train_rows): ``data`` the matching rows of the training arrays
        (default: this program's), ``generators`` one per member of the
        stack, ``step_lr`` a float or an [rows] tensor (default: lr)."""
        draws = draws or {}
        return local_training(
            flat, d_own if data is None else data, train_mask, list(generators),
            draws.get("u"), draws.get("dropout"),
            evidential_lambda(round_idx, annealing_rounds),
            lr if step_lr is None else step_lr,
        )

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

    def sender_view(vec):
        """[k, N] sender-side view of an [N] node flag: row j holds
        vec[(i + offsets[j]) % N] at column i."""
        return torch.stack([torch.roll(vec, -o) for o in sparse_offsets])

    def both_ways(adj, flags):
        """Drop the edges whose receiver or sender has flag 0."""
        if sparse:
            return adj * flags[None, :] * sender_view(flags)
        return adj * flags[:, None] * flags[None, :]

    def drop_senders(adj, flags):
        """Drop the edges whose sender has flag 0."""
        if sparse:
            return adj * sender_view(flags)
        return adj * flags[None, :]

    def in_degree(adj):
        """[N] live in-edges of each receiver."""
        return adj.sum(dim=0) if sparse else adj.sum(dim=1)

    def training_mask(compromised, alive):
        """The round's [N] training mask: honest nodes (every node under an
        attack that trains locally), alive ones on a faulted program."""
        honest = 1.0 - compromised
        train_mask = (
            torch.ones_like(honest)
            if attack is not None and attack.trains_locally
            else honest
        )
        if alive is not None:
            train_mask = train_mask * alive
        return train_mask

    def produce_exchange(flat, agg_state, adj, compromised, alive, round_idx, generators,
                         draws, trained=None, data=None, scale=None):
        """Steps 1-2d of the round, the production of its exchange: local
        training, the sentinels, the attack, the codec and the stale fold,
        shared by the serialized and pipelined rounds and by ``train_flat``.
        ``alive`` is None on an unfaulted program.  ``draws`` injects what
        the generators would draw: ``u`` one [N, S] uniform shuffle key an
        epoch; ``noise`` the attack's [C, P] normal draws; ``dropout`` the
        keep masks, indexed ``[epoch][step][layer]``, each a bool [N, B,
        width_l] (node, batch slot, unit) for the layers of
        ``model.dropout_widths``.  ``trained`` (a gang's member rows,
        trained by ``train_rows`` with the others) replaces local training;
        ``data`` (train_step's) the rows of the training arrays it trains on.
        ``scale``: the attack scale of this call (default: the build's).
        Returns the post-scrub ``own_flat``,
        ``bcast`` and ``adj`` as the serialized aggregation consumes them,
        ``pre_flat`` and ``finite`` (the quarantine bookkeeping), the
        updated ``agg_state``, the stage stats and an adaptive attack's
        state of this round."""
        generators = generators or {}
        draws = draws or {}
        train_mask = training_mask(compromised, alive)
        pre_flat = None
        if alive is not None:
            # Dead nodes freeze like compromised ones.  The adjacency is
            # re-masked by alive here even though the schedule's masked
            # adjacency folds it in already (alive * alive == alive).
            adj = both_ways(adj, alive)
            pre_flat = flat
        if trained is not None:
            own_flat = trained
        else:
            with record_function("murmura.train"):
                own_flat = train_rows(flat.clone(), train_mask[own_rows], round_idx,
                                      [generators.get("train")], data=data, draws=draws)
        if group is not None:
            # The trained rows (and the pre-round ones, for the guards) turn
            # into this rank's column block of every node.
            own_flat = rows_to_columns(own_flat, group)
            if pre_flat is not None:
                pre_flat = rows_to_columns(pre_flat, group)
        fault_stats = {}
        if inject_rows is not None and round_idx >= faults.nan_inject_from_round:
            own_flat = torch.where(
                inject_rows[:, None], torch.full_like(own_flat, float("nan")), own_flat
            )
        finite = None
        if faults is not None and faults.nan_quarantine:
            # A non-finite update quarantines the node for the round: its
            # row is replaced, not masked, before any rule math.
            finite = all_columns(torch.isfinite(own_flat).all(dim=1))
            alive_f = alive if alive is not None else torch.ones_like(compromised)
            fault_stats["quarantined"] = ((1.0 - finite.to(torch.float32)) * alive_f).sum()
            if audit_taps:
                # Which node diverged, not just how many.
                fault_stats["tap_quarantined"] = (1.0 - finite.to(torch.float32)) * alive_f
            own_flat = torch.where(finite[:, None], own_flat, pre_flat)
            adj = both_ways(adj, finite.to(adj.dtype))
        bfin = None
        attack_state = None
        if scale is None:
            scale = attack_scale
        if attack is not None:
            noise = draws.get("noise")
            if noise is not None:
                noise = torch.as_tensor(np.asarray(noise)).to(device)
            with record_function("murmura.exchange"):
                if adaptive:
                    # Last round's state (the feedback after the rule wrote
                    # it) sets this round's strength a compromised row.
                    attack_state = {k: agg_state[k] for k in attack.state_keys}
                    bcast = attack.apply_adaptive(
                        own_flat, compromised, generators.get("attack"), attack_state,
                        noise=noise,
                    )
                else:
                    bcast = attack.apply(
                        own_flat, compromised, generators.get("attack"), noise=noise
                    )
            if scale is not None:
                # A gang member's attack intensity: the perturbation the
                # attack added, scaled in float32 (0 turns it off); before the
                # scrub, so an amplified-to-inf row is still caught.
                bcast = (own_flat.to(torch.float32) + scale
                         * (bcast - own_flat).to(torch.float32)).to(own_flat.dtype)
            if finite is not None:
                # An attack that overflows to inf/NaN: its broadcast row is
                # replaced by the sender's own row and dropped from every
                # receiver; the sender's own state is untouched.
                bfin = all_columns(torch.isfinite(bcast).all(dim=1))
                bcast = torch.where(bfin[:, None], bcast, own_flat)
                adj = drop_senders(adj, bfin.to(adj.dtype))
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
            "attack_state": attack_state,
        }

    def stats_metrics(agg_stats, prod, dmtt_stats=None, attack_stats=None):
        metrics = {f"agg_{k}": v for k, v in agg_stats.items()}
        metrics.update({f"agg_{k}": v for k, v in (dmtt_stats or {}).items()})
        for group in ("fault_stats", "compress_stats", "stale_stats"):
            metrics.update({f"agg_{k}": v for k, v in prod[group].items()})
        metrics.update({f"agg_{k}": v for k, v in (attack_stats or {}).items()})
        return metrics

    def step_ctx(data):
        """The rules' context for rows of ``data`` (their probe batches), or
        the program's own."""
        if data is None:
            return ctx
        return replace(ctx, probe_x=data["probe_x"], probe_y=data["probe_y"],
                       probe_mask=data["probe_mask"])

    def dmtt_exchange(bcast, adj, compromised, agg_state, rule_ctx):
        """Step 2e: (the exchange mask, agg_state with the new trust state,
        the context with the shared cross-evaluation, the dmtt stats)."""
        with record_function("murmura.exchange"):
            claims = claims_fn(adj, compromised) if claims_fn is not None else adj
            cross = pairwise_probe_eval(bcast, rule_ctx, combined_probe_metric(evidential))
            exchange, dmtt_state, dmtt_stats = dmtt_round_update(
                {k: agg_state[k] for k in DMTT_STATE_KEYS}, adj, claims,
                cross["accuracy"], cross["vacuity"], dmtt)
        return exchange, {**agg_state, **dmtt_state}, replace(rule_ctx, probe_cross=cross), \
            dmtt_stats

    def round_body(flat, agg_state, adj, compromised, alive, round_idx, generators, draws,
                   trained, data, scale):
        """One serialized round: produce the exchange, the DMTT gate,
        aggregate, an adaptive attack's feedback, then the fault guards."""
        prod = produce_exchange(flat, agg_state, adj, compromised, alive, round_idx,
                                generators, draws, trained, data, scale)
        own_flat, adj, agg_state = prod["own_flat"], prod["adj"], prod["agg_state"]
        rule_ctx = step_ctx(data)
        dmtt_stats = None
        if dmtt is not None:
            adj, agg_state, rule_ctx, dmtt_stats = dmtt_exchange(
                prod["bcast"], adj, compromised, agg_state, rule_ctx)
        rule_state = {k: v for k, v in agg_state.items() if k not in reserved}
        with record_function("murmura.aggregate"):
            new_flat, rule_state, agg_stats = agg.aggregate(
                own_flat, prod["bcast"], adj, round_idx, rule_state, rule_ctx
            )
        agg_state = {**agg_state, **rule_state}
        attack_stats = None
        if adaptive:
            # The attacker reads the taps the rule just emitted for its rows
            # (a scrub or quarantine is a rejection, a dead row no
            # observation) and writes next round's state.
            accept, observed = acceptance_feedback(agg_stats, prod["fault_stats"],
                                                   in_degree(adj), alive)
            attack_state = attack.update_attack_state(prod["attack_state"], accept, observed,
                                                      compromised)
            agg_state = {**agg_state, **attack_state}
            attack_stats = dict(attack.strength_stats(attack_state, compromised))
            attack_stats["atk_accept"] = accept * compromised
        if alive is not None:
            # No alive neighbour: the node keeps its own state.  Dead nodes
            # freeze at the pre-round value, quarantined ones roll back.
            deg = in_degree(adj)
            new_flat = torch.where((deg > 0)[:, None], new_flat, own_flat)
            keep = alive > 0
            if prod["finite"] is not None:
                keep = keep & prod["finite"]
            new_flat = torch.where(keep[:, None], new_flat, prod["pre_flat"])
            prod["fault_stats"]["alive"] = alive.sum()
            if audit_taps:
                prod["fault_stats"]["tap_alive"] = alive
        return new_flat, agg_state, stats_metrics(agg_stats, prod, dmtt_stats, attack_stats)

    def round_body_pipelined(flat, agg_state, adj, compromised, alive, round_idx, generators,
                             draws, trained, data, scale):
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
        if sparse:
            # Stored node-leading [N, k]; the rules take [k, N].
            buf_adj = buf_adj.T
        rule_state = {k: v for k, v in agg_state.items() if k not in pipe_reserved}
        with record_function("murmura.aggregate"):
            # The buffer belongs to round r-1; round 0's is the invalid
            # placeholder, whose output and state are discarded below.
            agg_out, rule_state_new, agg_stats = agg.aggregate(
                buf_own, buf_bcast, buf_adj, max(round_idx - 1.0, 0.0), rule_state,
                step_ctx(data)
            )
        if alive is not None:
            # The zero-alive-neighbour guard at the buffered graph.
            deg_b = in_degree(buf_adj)
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
                                generators, draws, trained, data, scale)
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
        buffer = {PIPE_OWN_KEY: own_flat,
                  PIPE_ADJ_KEY: prod["adj"].T if sparse else prod["adj"],
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
        trained: Optional[torch.Tensor] = None,
        data: Optional[Dict[str, torch.Tensor]] = None,
        attack_scale: Optional[float] = None,
    ):
        """One round (round_body, or round_body_pipelined on a pipelined
        program); a faulted program needs ``alive``.  ``trained`` (a gang's
        member rows, trained by ``train_rows``) replaces local training.
        ``data``: rows of the data arrays (every key of ``RoundProgram.data``)
        to train and probe on instead of the program's own.
        ``attack_scale``: this round's attack scale in place of the build's
        (a gang member's, which a stage reset changes).  Under a group
        ``flat`` and the returned parameters are the rank's own rows."""
        check_alive(alive)
        if attack_scale is not None and attack is None:
            raise ValueError("attack_scale was given but no attack is configured")
        if group is not None and (trained is not None or data is not None):
            raise ValueError(
                "a param group's round trains its own rows of its own data: a gang's "
                "trained rows and another data= are not run sharded")
        with param_group_scope(group):
            new_flat, agg_state, metrics = body(flat, agg_state, adj, compromised, alive,
                                                round_idx, generators, draws, trained, data,
                                                attack_scale)
        if group is not None:
            new_flat = columns_to_rows(new_flat, group)
        if flat_dim > model_dim:
            # The pad stays exact zeros, as the JAX package's ravel remakes
            # it every round (a picked broadcast row carries its attack's pad).
            new_flat[:, model_dim:] = 0
        return new_flat, agg_state, metrics

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
    def eval_step(flat: torch.Tensor, data=None) -> Dict[str, torch.Tensor]:
        """Per-row eval metrics of ``flat``'s rows against the matching rows
        of ``data``'s eval arrays (default: this program's).  Under a group
        each rank evaluates its own rows and every rank gets all N."""
        metrics = eval_rows(flat, d_own if data is None else data)
        if group is None:
            return metrics
        return {k: gather_rows(v, group) for k, v in metrics.items()}

    def eval_rows(flat: torch.Tensor, dd) -> Dict[str, torch.Tensor]:
        x, y, mask = dd["eval_x"], dd["eval_y"], dd["eval_mask"]
        n = flat.shape[0]
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
    if dmtt is not None:
        init_agg_state.update(init_dmtt_state(n, device))
    if compression is not None:
        clash = set(COMPRESS_STATE_KEYS) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the compressed exchange"
            )
        # The top-k reference starts at the initial broadcast, which a
        # deployment sends in full once at set-up.
        init_agg_state.update(init_compress_state(
            compression, init_flat if group is None else
            torch.zeros((n, state_width), dtype=init_flat.dtype, device=device)))
    if staleness is not None:
        clash = set(STALE_STATE_KEYS) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the bounded-staleness exchange"
            )
        init_agg_state.update(
            init_stale_state(staleness, n, state_width, init_flat.dtype, device))
    if adaptive:
        clash = set(attack.state_keys) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the adaptive attack"
            )
        init_agg_state.update({
            k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in attack.init_attack_state(n).items()
        })
    if pipeline:
        clash = set(pipe_keys) & set(init_agg_state)
        if clash:
            raise ValueError(
                f"aggregator '{agg.name}' carries state keys {sorted(clash)} "
                "reserved for the pipelined exchange"
            )
        init_agg_state.update(init_pipeline_state(
            n, state_width, init_flat.dtype, sparse_offsets=sparse_offsets,
            stale=staleness is not None, device=device))
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
        # Under a group the production stage ends in a column block.
        train_flat=train_flat if group is None else None,
        train_rows=train_rows,
        training_mask=training_mask,
        sparse_offsets=sparse_offsets,
        dmtt=dmtt,
        param_shards=param_shards,
        flat_dim=flat_dim,
        group=group,
        sharded_state_keys=() if group is None else tuple(sorted(
            k for k in (*COMPRESS_STATE_KEYS, STALE_CACHE_KEY, PIPE_OWN_KEY, PIPE_BCAST_KEY)
            if k in init_agg_state)),
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

