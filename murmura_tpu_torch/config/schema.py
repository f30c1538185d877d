# Copy of murmura_tpu/config/schema.py: the port imports nothing from the JAX package.
"""Pydantic configuration schema.

Byte-compatible with the reference YAML surface (reference:
murmura/config/schema.py:7-203) plus the new ``backend: tpu`` enum and an
optional ``tpu:`` section controlling mesh layout / precision / exchange
strategy.  ``extra = "forbid"`` everywhere, like the reference
(murmura/config/schema.py:200-202).
"""

from typing import Any, Dict, List, Literal, Optional

from pydantic import BaseModel, ConfigDict, Field, model_validator

from murmura_tpu_torch.levers import refusal_reason


class _Strict(BaseModel):
    model_config = ConfigDict(extra="forbid")


class ExperimentConfig(_Strict):
    """Experiment-level settings (reference: murmura/config/schema.py:54-59)."""

    name: str = Field(description="Experiment name")
    seed: int = Field(default=42, description="Random seed for reproducibility")
    rounds: int = Field(default=20, description="Number of training rounds")
    verbose: bool = Field(default=False, description="Enable verbose logging")


class TopologyConfig(_Strict):
    """Static graph topology (reference: murmura/config/schema.py:62-70).

    ``exponential`` and ``one_peer`` are *sparse* families
    (topology/sparse.py; docs/SCALING.md): offset-list circulants whose
    round programs take a [k, N] edge mask instead of a dense [N, N]
    adjacency — the large-N path (4096+ nodes on one chip)."""

    type: Literal[
        "ring", "fully", "erdos", "k-regular",
        # Sparse offset-list families (degree O(log N), never [N, N]):
        "exponential", "one_peer",
    ] = Field(description="Topology type")
    num_nodes: int = Field(description="Number of nodes in the network")
    p: Optional[float] = Field(default=None, description="Edge probability (erdos)")
    k: Optional[int] = Field(default=None, description="Degree (k-regular)")
    seed: int = Field(default=12345, description="Topology generation seed")


class AggregationConfig(_Strict):
    """Aggregation rule selection (reference: murmura/config/schema.py:73-81)."""

    algorithm: Literal[
        "fedavg", "krum", "balance", "sketchguard", "ubar", "evidential_trust",
        # Beyond reference parity (coordinate-wise robust statistics):
        "median", "trimmed_mean", "geometric_median",
    ] = Field(description="Aggregation algorithm")
    params: Dict[str, Any] = Field(
        default_factory=dict, description="Algorithm-specific parameters"
    )


class AdaptiveAttackConfig(_Strict):
    """In-jit closed-loop attack adaptation (attacks/adaptive.py;
    docs/ROBUSTNESS.md "Adaptive adversaries").

    With ``enabled``, the configured attack tunes its own strength each
    round against the audit-tap acceptance signal inside the compiled
    round program: ``type: alie`` becomes adaptive ALIE (the deviation
    factor z walks the defense's selection margin); ``type: ipm``
    becomes adaptive IPM (the negation factor epsilon walks the same
    signal as carried state — the paper's own strength axis); every
    other broadcast attack (gaussian/directed_deviation) is wrapped in
    the generic scale bisection ("largest strength still accepted").  The
    adaptation state rides ``agg_state`` under the reserved
    ATTACK_STATE_KEYS, so durability snapshots resume a mid-bisection
    attacker byte-identically (MUR901's adaptive cell).  Default off =>
    byte-identical programs and histories.
    """

    enabled: bool = Field(
        default=False, description="Enable closed-loop adaptation"
    )
    ema_beta: float = Field(
        default=0.5, gt=0.0, le=1.0,
        description="Acceptance-EMA smoothing factor",
    )
    accept_target: float = Field(
        default=0.0, ge=0.0, lt=1.0,
        description=(
            "Acceptance fraction STRICTLY above which a round counts as "
            "accepted (0 = some peer selected/accepted the row — the "
            "right reading for single-winner rules like krum)"
        ),
    )
    eta: float = Field(
        default=0.25, gt=0.0, lt=1.0,
        description="Adaptive-ALIE multiplicative z step (1 +/- eta)",
    )
    scale_init: float = Field(
        default=1.0, gt=0.0,
        description="Bisection wrapper: first probed strength multiplier",
    )
    scale_max: float = Field(
        default=8.0, gt=0.0,
        description="Bisection wrapper: strength cap / growth-phase limit",
    )
    growth: float = Field(
        default=2.0, gt=1.0,
        description=(
            "Bisection wrapper: growth factor while no rejection has "
            "been observed"
        ),
    )
    z_min: float = Field(
        default=0.05, gt=0.0, description="Adaptive-ALIE z floor"
    )
    z_cap: Optional[float] = Field(
        default=None, gt=0.0,
        description="Adaptive-ALIE z ceiling (default: max(4*z0, 4))",
    )

    @model_validator(mode="after")
    def _bracket_sane(self):
        if self.scale_init > self.scale_max:
            raise ValueError(
                f"adaptive.scale_init={self.scale_init} > "
                f"scale_max={self.scale_max} — the first probe would "
                "start outside the bracket"
            )
        return self


class AttackConfig(_Strict):
    """Byzantine attack scenario (reference: murmura/config/schema.py:84-94)."""

    enabled: bool = Field(default=False, description="Enable Byzantine attacks")
    type: Optional[Literal[
        "gaussian", "directed_deviation", "topology_liar", "alie", "ipm",
        "label_flip",
    ]] = Field(
        default=None, description="Attack type"
    )
    percentage: float = Field(default=0.0, description="Fraction of nodes compromised")
    params: Dict[str, Any] = Field(
        default_factory=dict, description="Attack-specific parameters"
    )
    adaptive: AdaptiveAttackConfig = Field(
        default_factory=AdaptiveAttackConfig,
        description=(
            "In-jit closed-loop adaptation (docs/ROBUSTNESS.md); default "
            "off => byte-identical to no adaptive block"
        ),
    )


class MobilityConfig(_Strict):
    """Random-walk mobility model G^t (reference: murmura/config/schema.py:97-111)."""

    area_size: float = Field(default=100.0, description="2-D arena side length")
    comm_range: float = Field(
        default=30.0, description="Edge (i,j) in G^t iff torus-dist < comm_range"
    )
    max_speed: float = Field(default=5.0, description="Max displacement per round")
    seed: int = Field(default=42, description="RNG seed for positions and movement")
    ensure_connected: bool = Field(
        default=True, description="Attach isolated nodes to their nearest peer"
    )


class DMTTConfig(_Strict):
    """DMTT trust-protocol hyperparameters (reference: murmura/config/schema.py:114-139)."""

    budget_B: int = Field(default=5, description="Max collaborators per round")
    rho: float = Field(default=0.1, description="Link-reliability EMA factor")
    lambda_forget: float = Field(default=0.9, description="Beta-evidence forgetting")
    w_d: float = Field(default=1.0, description="Direct confirmation evidence weight")
    w_c: float = Field(default=0.5, description="Corroboration evidence weight")
    w_x: float = Field(default=1.0, description="Contradiction evidence weight")
    tau_U: float = Field(default=0.3, description="Uncertainty tolerance threshold")
    eta: float = Field(default=5.0, description="Uncertainty penalty scale")
    w_a: float = Field(default=0.7, description="Accuracy weight in model score")
    tau_u: float = Field(default=0.5, description="Uncertainty threshold, model score")
    lambda1: float = Field(default=0.4, description="Model compatibility weight")
    lambda2: float = Field(default=0.3, description="Topology trust weight")
    lambda3: float = Field(default=0.2, description="Link reliability weight")
    lambda4: float = Field(default=0.1, description="Communication cost weight")
    allow_static: bool = Field(
        default=False,
        description=(
            "Permit DMTT without a mobility section: claim verification uses "
            "the static topology as ground truth G^t.  Off by default so a "
            "missing mobility block is an explicit choice, not a silent "
            "fallback (murmura_tpu extension; the reference accepts it "
            "silently — murmura/dmtt/node_process.py:247)"
        ),
    )


class FaultsConfig(_Strict):
    """Operational fault model: churn, link drops, stragglers, NaN
    quarantine (murmura_tpu extension; no reference counterpart — the
    reference's only degradation path is the ZMQ deadline).

    Default off => byte-identical behavior to a config without this block:
    the compiled round program, history arrays, and random streams are
    untouched unless ``enabled`` is true.  See docs/ROBUSTNESS.md.
    """

    enabled: bool = Field(default=False, description="Enable the fault model")
    seed: int = Field(
        default=777,
        description=(
            "Fault-schedule seed; every process reconstructs the identical "
            "schedule from it (crash/recovery churn, link drops, stragglers)"
        ),
    )
    crash_prob: float = Field(
        default=0.0, ge=0.0, le=1.0,
        description="Per-round P(alive node crashes)",
    )
    recovery_prob: float = Field(
        default=0.0, ge=0.0, le=1.0,
        description=(
            "Per-round P(crashed node recovers), after min_down_rounds"
        ),
    )
    min_down_rounds: int = Field(
        default=1, ge=1,
        description="Minimum rounds a crashed node stays down",
    )
    link_drop_prob: float = Field(
        default=0.0, ge=0.0, le=1.0,
        description="Per-round per-undirected-edge drop probability",
    )
    straggler_prob: float = Field(
        default=0.0, ge=0.0, le=1.0,
        description=(
            "Per-round P(node straggles): its update misses the delivery "
            "deadline (jitted backends: outgoing contributions masked; "
            "distributed: the node actually sleeps).  With "
            "exchange.max_staleness >= 1 a straggle becomes a bounded "
            "DELAY instead of a drop: receivers aggregate the "
            "straggler's last delivered payload until the age bound "
            "expires (docs/ROBUSTNESS.md 'Bounded staleness')"
        ),
    )
    straggler_factor: float = Field(
        default=2.0, ge=1.0,
        description=(
            "Training-time multiplier a straggle simulates on the "
            "distributed backend (sleep of (factor-1) x training time, "
            "capped at the round window)"
        ),
    )
    nan_quarantine: bool = Field(
        default=True,
        description=(
            "In-jit numerical sentinel: after local training, nodes whose "
            "flattened update contains non-finite values are quarantined "
            "for the round — masked out of the exchange, params rolled "
            "back to the pre-round value — instead of poisoning the fleet"
        ),
    )
    nan_inject_nodes: List[int] = Field(
        default_factory=list,
        description=(
            "Deterministic divergence injection for chaos testing: these "
            "nodes emit NaN updates from nan_inject_from_round on"
        ),
    )
    nan_inject_from_round: int = Field(
        default=0, ge=0,
        description="First round nan_inject_nodes emit NaNs",
    )


class ExchangeConfig(_Strict):
    """Exchange-layer semantics: bounded-staleness gossip (
    docs/ROBUSTNESS.md "Bounded staleness") and pipelined rounds
    (docs/PERFORMANCE.md "Pipelined rounds"); PAPERS.md:
    asynchronous quantized decentralized SGD arXiv:1910.12308, delayed
    averaging arXiv:2002.01119.

    With ``max_staleness`` >= 1 the round program carries a per-sender
    payload cache + integer age stamp in ``agg_state`` (reserved
    ``STALE_STATE_KEYS``, core/stale.py): when the fault model disrupts a
    sender — a straggler, a crashed node, a link-isolated one — its
    base-graph edges are re-added with the last *delivered* payload
    instead of being dropped, as long as that payload's age stays within
    the bound.  Quarantined/attack-scrubbed rows are withheld from the
    cache path exactly like the fresh path (the MUR1103 replay-hole
    contract), and ages past the bound degrade to today's drop-the-edge
    behavior.

    Default (``max_staleness: 0``, ``pipeline: false``) => byte-identical
    behavior to a config without this block: the compiled round program,
    histories, and random streams are untouched.
    """

    max_staleness: int = Field(
        default=0, ge=0,
        description=(
            "Maximum rounds a cached neighbor payload may be served after "
            "its sender last delivered (0 = off: disrupted edges drop, "
            "today's strict-synchronous behavior)"
        ),
    )
    staleness_discount: float = Field(
        default=1.0, gt=0.0, le=1.0,
        description=(
            "Per-round-of-age multiplier on a re-added stale edge's "
            "adjacency weight (weight = discount ** age).  Mean-family "
            "rules honor the fraction; selection rules (krum/median/"
            "trimmed) treat any positive weight as a full candidate"
        ),
    )
    pipeline: bool = Field(
        default=False,
        description=(
            "Pipelined rounds (docs/PERFORMANCE.md 'Pipelined "
            "rounds'): overlap round r's local training with round "
            "r-1's exchange + aggregation through a double-buffered "
            "pipeline stage riding agg_state (one-round-delayed "
            "averaging, arXiv:2002.01119).  Round r's params then "
            "contain round r's local step plus round r-1's aggregation "
            "displacement.  Composes with compression, faults, "
            "staleness, sparse topologies and gang sweeps; default off "
            "=> byte-identical programs and histories"
        ),
    )


class CompressionConfig(_Strict):
    """Compressed neighbor exchange (murmura_tpu extension;
    docs/PERFORMANCE.md, PAPERS.md: quantized decentralized SGD,
    arXiv:1910.12308).

    The round's exchanged [N, P] broadcast is quantized in-jit — per-block
    int8, or top-k of the round-over-round delta — the exchange moves the
    compressed representation, and receivers dequantize before rule math.
    ``error_feedback`` carries the quantization residual in the aggregation
    state and adds it back to the next round's transmission, the condition
    under which compressed decentralized SGD converges like full precision.

    Default (``algorithm: none``) => byte-identical behavior to a config
    without this block: the compiled round program, histories, and random
    streams are untouched.
    """

    algorithm: Literal["none", "int8", "topk"] = Field(
        default="none",
        description=(
            "Exchange codec: none (full-precision, the default), int8 "
            "(per-block symmetric 8-bit quantization of the broadcast), or "
            "topk (sparse top-k delta against a carried reference estimate)"
        ),
    )
    error_feedback: bool = Field(
        default=False,
        description=(
            "Carry the quantization residual (update - dequant(quant)) in "
            "agg_state and add it back to next round's transmission, so "
            "compression error telescopes instead of accumulating"
        ),
    )
    block: int = Field(
        default=256, ge=8,
        description=(
            "int8 quantization block along the parameter axis (one f32 "
            "scale per block; smaller blocks = finer scales, more scale "
            "bytes)"
        ),
    )
    topk_ratio: float = Field(
        default=0.05, gt=0.0, le=1.0,
        description=(
            "Fraction of the [P] coordinates the topk codec transmits per "
            "round (values + int32 indices)"
        ),
    )


class DurabilityConfig(_Strict):
    """Run-level durability (murmura_tpu extension;
    docs/ROBUSTNESS.md "Run durability").

    Crash-equivalent checkpoint/resume for the jitted backends (single
    runs, gangs, population streaming) plus the elastic dispatch
    envelope: transient-error retries with exponential backoff and the
    ``require_tpu`` hard-fail replacing the silent CPU fallback.  CLI
    flags (``--checkpoint-dir``/``--resume``/``--require-tpu``/
    ``--retries``) override these; the block makes a run's durability
    posture part of its committed config.

    Default (no checkpoint_dir, retries 0, require_tpu off) =>
    byte-identical behavior to a config without this block.
    """

    checkpoint_dir: Optional[str] = Field(
        default=None,
        description=(
            "Snapshot the complete run state here every checkpoint_every "
            "rounds through the fsync'd durable-replace path "
            "(durability/snapshot.py); None disables checkpointing"
        ),
    )
    checkpoint_every: int = Field(
        default=5, ge=1,
        description="Rounds between snapshots (with checkpoint_dir)",
    )
    resume: bool = Field(
        default=False,
        description=(
            "Resume from checkpoint_dir when a snapshot exists (the CLI "
            "--resume twin); the telemetry event stream appends instead "
            "of rotating, and continuation is byte-identical to the "
            "uninterrupted run (MUR901)"
        ),
    )
    require_tpu: bool = Field(
        default=False,
        description=(
            "Hard-fail (BackendRequirementError) unless the default JAX "
            "backend is a TPU — replaces the silent CPU fallback.  Env "
            "twin: MURMURA_REQUIRE_TPU=1"
        ),
    )
    retries: int = Field(
        default=0, ge=0,
        description=(
            "Transient-error retries for the training dispatch: on a "
            "classified-transient failure (device/tunnel/transport — "
            "durability/dispatch.py) the run restores from its last "
            "snapshot and retries with exponential backoff + jitter.  "
            "Requires checkpoint_dir (retrying consumed/donated buffers "
            "without a restore is never safe)"
        ),
    )
    retry_base_delay_s: float = Field(
        default=1.0, ge=0.0,
        description="First backoff delay; doubles per retry",
    )
    retry_max_delay_s: float = Field(
        default=60.0, ge=0.0, description="Backoff delay ceiling",
    )


class TelemetryConfig(_Strict):
    """Unified runtime telemetry (murmura_tpu extension;
    docs/OBSERVABILITY.md).

    One versioned run manifest + JSONL event stream every backend emits
    through (telemetry/writer.py), rendered by ``murmura report``.
    Default off => byte-identical behavior to a config without this block:
    the compiled round program, histories, and random streams are
    untouched unless ``enabled`` is true.
    """

    enabled: bool = Field(default=False, description="Enable the telemetry run manifest")
    dir: Optional[str] = Field(
        default=None,
        description=(
            "Run directory for manifest.json + events.jsonl "
            "(default: murmura_runs/<experiment.name>)"
        ),
    )
    audit_taps: bool = Field(
        default=False,
        description=(
            "In-jit aggregator audit taps: per-node decision tensors "
            "(krum/ubar/balance acceptance masks, evidential trust scores, "
            "quarantine/scrub flags) ride the round program's history "
            "output as agg_tap_* arrays.  Guaranteed collective- and "
            "recompile-clean (check --ir MUR400/MUR402)."
        ),
    )
    phase_times: bool = Field(
        default=True,
        description=(
            "Per-round phase_times events (per-round wall times; fused "
            "dispatch records elapsed/k amortized per round — the "
            "round_times semantics, now in one schema)"
        ),
    )
    memory_stats: bool = Field(
        default=False,
        description=(
            "Sample device memory_stats() into a per-round memory event "
            "(no-op on platforms that expose none)"
        ),
    )
    profile_dir: Optional[str] = Field(
        default=None,
        description=(
            "Profiler trace output dir for the round-window capture "
            "(default: <dir>/trace).  The whole-train trace remains "
            "tpu.profile_dir."
        ),
    )
    profile_start_round: int = Field(
        default=0, ge=0,
        description="First round of the profiler capture window",
    )
    profile_rounds: int = Field(
        default=0, ge=0,
        description=(
            "Rounds to capture a perfetto/xprof trace for, starting at "
            "profile_start_round (0 = no window capture; murmura run "
            "--profile sets this to the whole run when unset)"
        ),
    )


class PopulationConfig(_Strict):
    """Sampled-cohort streaming over a virtual population (murmura_tpu
    extension; docs/SCALING.md).

    Teleportation-style sampled activation (arXiv:2501.15259): every round
    runs over a ``topology.num_nodes``-sized *cohort* drawn from a much
    larger virtual population.  Per-user model rows persist in a host-side
    state bank (``population/bank.py``: memory-mapped, lazily initialized);
    the active cohort is device-resident, and the next cohort's rows are
    staged while the current round computes.  Cohort draws are a pure
    function of ``(seed, draw_index)`` so distributed processes agree with
    zero communication, and cohort membership reaches the compiled round
    program as input *values* — one compile covers the whole population
    (the faults-subsystem mechanism, MUR302).

    Default off => byte-identical behavior to a config without this block.
    """

    enabled: bool = Field(default=False, description="Enable cohort streaming")
    virtual_size: int = Field(
        default=0, ge=0,
        description="Virtual population size U (users; >= topology.num_nodes)",
    )
    cohort_size: Optional[int] = Field(
        default=None,
        description=(
            "Resident cohort size; must equal topology.num_nodes (the "
            "compiled round program's node axis) — present for config "
            "legibility, defaulted from the topology when omitted"
        ),
    )
    sampler: Literal["uniform", "stratified"] = Field(
        default="uniform",
        description=(
            "Cohort sampler: uniform (without replacement over all users) "
            "or stratified (the user id space is split into cohort_size "
            "contiguous strata, one draw per stratum — every region of the "
            "population is touched every round)"
        ),
    )
    seed: int = Field(
        default=1234,
        description=(
            "Cohort-draw seed; draws are a pure function of (seed, "
            "draw_index), identical in every process"
        ),
    )
    rounds_per_cohort: int = Field(
        default=1, ge=1,
        description="Rounds a cohort stays resident before the next swap",
    )
    data_binding: Literal["user", "slot"] = Field(
        default="user",
        description=(
            "user: a user's data shard follows them (shard user_id mod N, "
            "re-staged at each swap); slot: shards stay bound to cohort "
            "slots (no data restaging — params-only streaming)"
        ),
    )
    inherit: Literal["teleport", "slot_init"] = Field(
        default="teleport",
        description=(
            "First-activation model for a user with no banked row: "
            "teleport (arXiv:2501.15259) adopts the OUTGOING cohort's "
            "trained slot model, so learning accumulates across cohorts "
            "even when re-activation is rare; slot_init starts fresh from "
            "the slot's seed init (isolated per-user models)"
        ),
    )
    bank_dir: Optional[str] = Field(
        default=None,
        description=(
            "Directory for the memory-mapped state bank (default: a "
            "TemporaryDirectory; small populations stay in RAM)"
        ),
    )


class SweepMemberConfig(_Strict):
    """One gang member's overrides (core/gang.py; docs/PERFORMANCE.md).

    A member is the base experiment with a different seed and optionally
    different *traced-scalar* hyperparameters — values the compiled round
    program takes as inputs, so every member rides one jit.  Shape-affecting
    knobs (num_nodes, batch_size, krum's num_compromised selection count,
    model size) cannot vary inside a gang: they change the traced program
    and belong in separate sweeps.
    """

    seed: Optional[int] = Field(
        default=None,
        description="Member experiment seed (default: experiment.seed)",
    )
    lr: Optional[float] = Field(
        default=None, gt=0.0,
        description="Member learning-rate override (default: training.lr)",
    )
    attack_scale: Optional[float] = Field(
        default=None, ge=0.0,
        description=(
            "Multiplier on the attack's broadcast perturbation "
            "(bcast = own + scale * (attacked - own)); 1.0 = the configured "
            "attack, 0.0 = attack off for this member"
        ),
    )
    noise_std: Optional[float] = Field(
        default=None, ge=0.0,
        description=(
            "Gaussian-attack noise std override — sugar for attack_scale = "
            "noise_std / attack.params.noise_std (gaussian attacks only)"
        ),
    )


class SweepConfig(_Strict):
    """Gang-batched multi-seed execution (murmura_tpu extension;
    docs/PERFORMANCE.md).

    Stacks S independent experiments — differing in seed and optionally in
    traced scalar hyperparameters — into leading-axis-[S, ...] inputs and
    ``jax.vmap``s the round program over that axis: one XLA compile and one
    saturated device program cover the whole sweep instead of S compiles +
    S underfilled executions.  ``sweep:`` absent => byte-identical behavior
    to today; with it, each member's history is byte-identical on CPU to
    the single run with that member's seed (gang-parity contract,
    tests/test_gang.py).
    """

    seeds: Optional[List[int]] = Field(
        default=None,
        description="Explicit member seeds (one gang member per entry)",
    )
    num_seeds: Optional[int] = Field(
        default=None, ge=1,
        description=(
            "Sugar for seeds = [experiment.seed, experiment.seed + 1, ...]"
        ),
    )
    members: Optional[List[SweepMemberConfig]] = Field(
        default=None,
        description=(
            "Explicit member list with per-member hyperparameter overrides "
            "(mutually exclusive with seeds/num_seeds)"
        ),
    )
    bucket: bool = Field(
        default=True,
        description=(
            "Pad the gang to the next power-of-two size so growing S within "
            "a bucket reuses the compiled program (zero recompiles — check "
            "--ir MUR501); padding members replicate member 0 and are "
            "never recorded"
        ),
    )

    @model_validator(mode="after")
    def _exactly_one_member_source(self):
        sources = [
            s for s in (self.seeds, self.num_seeds, self.members)
            if s is not None
        ]
        if len(sources) != 1:
            raise ValueError(
                "sweep needs exactly one of seeds / num_seeds / members"
            )
        if self.seeds is not None and len(self.seeds) != len(set(self.seeds)):
            raise ValueError("sweep.seeds must be distinct")
        if self.seeds is not None and not self.seeds:
            raise ValueError("sweep.seeds must be non-empty")
        if self.members is not None and not self.members:
            raise ValueError("sweep.members must be non-empty")
        return self


class FrontierConfig(_Strict):
    """`murmura frontier <yaml>`: gang-powered adversarial search for each
    rule's empirical breaking point (docs/ROBUSTNESS.md "The robustness
    frontier").

    For every (rule x attack x topology) cell the frontier search stacks an
    attack-strength x seed grid into ONE compile-compatible gang bucket
    (per-member ``attack_scale`` — the sweep plumbing — padded to the
    next power of two), trains it, and runs an outer successive-halving
    loop that re-aims the strength grid at the honest-accuracy cliff
    WITHOUT recompiling (strengths are traced inputs; the gang is reset
    value-only between stages).  The committed ``frontier.json`` charts
    honest accuracy vs strength per cell plus each bounded rule's MUR800
    declared influence bound next to its empirical breaking point.
    """

    rules: List[str] = Field(
        default=["krum", "median", "trimmed_mean", "balance"],
        description="Aggregation rules to chart",
    )
    attacks: List[Literal["alie", "gaussian"]] = Field(
        default=["alie", "gaussian"],
        description=(
            "Adaptive attacks per cell: 'alie' = adaptive ALIE, "
            "'gaussian' = bisection-wrapped gaussian"
        ),
    )
    topologies: List[Literal["dense", "sparse"]] = Field(
        default=["dense", "sparse"],
        description=(
            "'dense' = the config's own (dense) topology; 'sparse' = the "
            "degree-log(N) exponential graph (arXiv:2110.13363)"
        ),
    )
    strength_lo: float = Field(
        default=0.25, gt=0.0,
        description="Initial strength grid lower edge (attack_scale units)",
    )
    strength_hi: float = Field(
        default=4.0, gt=0.0,
        description="Initial strength grid upper edge",
    )
    points: int = Field(
        default=4, ge=2,
        description=(
            "Nonzero strengths per stage (a 0-strength benign reference "
            "member is always added)"
        ),
    )
    seeds: Optional[List[int]] = Field(
        default=None,
        description="Member seeds per strength (default: [experiment.seed])",
    )
    percentages: Optional[List[float]] = Field(
        default=None,
        description=(
            "Sweep axis over attack.percentage — the BREAKDOWN-POINT "
            "axis: each value runs the full strength x seed successive-"
            "halving search with that fraction of nodes compromised, as "
            "its own compile-compatible gang bucket (the compromised set "
            "is a trace-time attack closure, so percentages cannot share "
            "a bucket the way strengths do).  None (default) = the base "
            "config's attack.percentage only"
        ),
    )
    stages: int = Field(
        default=2, ge=1,
        description="Successive-halving refinement stages per cell",
    )
    rounds: Optional[int] = Field(
        default=None, ge=1,
        description="Training rounds per stage (default: experiment.rounds)",
    )
    break_fraction: float = Field(
        default=0.5, gt=0.0, le=1.0,
        description=(
            "A strength is 'broken' when mean honest accuracy falls "
            "below break_fraction * the 0-strength benign accuracy"
        ),
    )

    @model_validator(mode="after")
    def _grid_sane(self):
        if self.strength_lo >= self.strength_hi:
            raise ValueError(
                f"frontier.strength_lo={self.strength_lo} must be < "
                f"strength_hi={self.strength_hi}"
            )
        for fieldname in ("rules", "attacks", "topologies"):
            vals = getattr(self, fieldname)
            if not vals:
                raise ValueError(f"frontier.{fieldname} must be non-empty")
            if len(vals) != len(set(vals)):
                raise ValueError(
                    f"frontier.{fieldname} has duplicates: {vals}"
                )
        if self.seeds is not None:
            if not self.seeds:
                raise ValueError("frontier.seeds must be non-empty")
            if len(self.seeds) != len(set(self.seeds)):
                raise ValueError("frontier.seeds must be distinct")
        if self.percentages is not None:
            if not self.percentages:
                raise ValueError("frontier.percentages must be non-empty")
            if len(self.percentages) != len(set(self.percentages)):
                raise ValueError("frontier.percentages must be distinct")
            bad = [p for p in self.percentages if not 0.0 < p < 1.0]
            if bad:
                raise ValueError(
                    f"frontier.percentages must be in (0, 1), got {bad}"
                )
        return self


class GridConfig(_Strict):
    """`murmura grid <yaml>`: the compile-compatible grid scheduler
    (serve/scheduler.py; docs/ROBUSTNESS.md "Serving").

    Expands a rule x attack x topology x strength x seed cell set and
    partitions it into **buckets keyed by the traced round program's
    jaxpr skeleton** (analysis/ir.py ``jaxpr_signature`` — the MUR203/
    MUR500 structural-equality machinery): cells whose programs are
    structurally equal share ONE gang bucket and therefore ONE compile;
    strength and seed ride as traced inputs (``attack_scale`` / the RNG
    lane) inside a bucket.  The full grid executes back-to-back off the
    warm compile cache and emits one cross-cell manifest for
    ``murmura report --grid``.
    """

    rules: List[str] = Field(
        default=["krum", "median", "trimmed_mean", "balance", "fedavg"],
        description="Aggregation rules (one bucket per rule, typically)",
    )
    attacks: List[Literal["gaussian", "alie", "ipm", "none"]] = Field(
        default=["gaussian"],
        description=(
            "Attack types per cell; 'none' runs benign cells (their "
            "program has no perturbation ops, so they bucket separately)"
        ),
    )
    topologies: List[Literal["dense", "sparse"]] = Field(
        default=["dense"],
        description=(
            "'dense' = the config's own (dense) topology; 'sparse' = the "
            "degree-log(N) exponential graph"
        ),
    )
    strengths: List[float] = Field(
        default=[0.0, 0.5, 1.0, 2.0, 4.0],
        description=(
            "Attack-strength axis (attack_scale units; 0.0 = the benign "
            "reference member).  A traced input — strengths share a "
            "bucket's single compile.  Ignored for attacks: ['none']"
        ),
    )
    seeds: Optional[List[int]] = Field(
        default=None,
        description=(
            "Member seeds per strength (default: [experiment.seed, "
            "experiment.seed + 1])"
        ),
    )
    rounds: Optional[int] = Field(
        default=None, ge=1,
        description="Training rounds per cell (default: experiment.rounds)",
    )

    @model_validator(mode="after")
    def _grid_sane(self):
        for fieldname in ("rules", "attacks", "topologies", "strengths"):
            vals = getattr(self, fieldname)
            if not vals:
                raise ValueError(f"grid.{fieldname} must be non-empty")
            if len(vals) != len(set(vals)):
                raise ValueError(f"grid.{fieldname} has duplicates: {vals}")
        if self.seeds is not None:
            if not self.seeds:
                raise ValueError("grid.seeds must be non-empty")
            if len(self.seeds) != len(set(self.seeds)):
                raise ValueError("grid.seeds must be distinct")
        bad = [g for g in self.strengths if g < 0.0]
        if bad:
            raise ValueError(f"grid.strengths must be >= 0, got {bad}")
        return self


class ServeConfig(_Strict):
    """`murmura serve <yaml>`: the crash-surviving multi-tenant daemon
    (serve/daemon.py; docs/ROBUSTNESS.md "Serving").

    The daemon accepts experiment submissions over a local socket and
    admits them into **warm gang buckets** keyed by the submission's
    structural fingerprint: tenants whose configs differ only in
    ``experiment.seed`` / ``experiment.name`` / ``training.lr`` (traced
    inputs) share one compiled bucket, admitted generation-by-generation
    via value-only ``GangNetwork.reset_run`` — zero recompiles
    (MUR1601).  Every bucket is built at ``capacity`` lanes up front
    (the power-of-two ``next_bucket`` shape), so admission never changes
    the compile shape; the queue simply waits for the next generation
    when more than ``capacity`` tenants target one bucket.  All daemon
    state (the submission ledger, generation records, gang snapshots on
    ``checkpoint_every`` cadence) lives under ``state_dir`` through the
    fsync'd durable-replace path, so a SIGKILL'd daemon restarts and
    resumes every in-flight run byte-identically (MUR1603).
    """

    state_dir: str = Field(
        description=(
            "Daemon state root: submission ledger + generation records + "
            "per-bucket gang snapshots (all fsync'd durable writes)"
        ),
    )
    socket: Optional[str] = Field(
        default=None,
        description=(
            "Unix-domain socket path for submissions (default: "
            "<state_dir>/daemon.sock)"
        ),
    )
    capacity: int = Field(
        default=4, ge=1,
        description=(
            "Gang lanes per bucket (power of two — the next_bucket "
            "compile shape).  Buckets are built at full capacity so "
            "within-capacity admission is value-only; a larger tenant "
            "backlog waits for the next generation instead of growing "
            "the compiled shape"
        ),
    )
    checkpoint_every: int = Field(
        default=1, ge=1,
        description=(
            "Gang snapshot cadence in rounds (durability/snapshot.py) — "
            "the resume granularity after a daemon SIGKILL"
        ),
    )
    poll_interval_s: float = Field(
        default=0.05, gt=0.0,
        description="Scheduler idle-poll interval between generations",
    )

    @model_validator(mode="after")
    def _capacity_is_bucket(self):
        c = self.capacity
        if c & (c - 1):
            raise ValueError(
                f"serve.capacity={c} must be a power of two — it IS the "
                "gang's next_bucket compile shape"
            )
        return self


class TrainingConfig(_Strict):
    """Local training hyperparameters (reference: murmura/config/schema.py:142-150)."""

    local_epochs: int = Field(default=1, description="Local epochs per round")
    batch_size: int = Field(default=64, description="Training batch size")
    lr: float = Field(default=0.01, description="Learning rate")
    max_samples: Optional[int] = Field(
        default=None, description="Max samples per client (None for all)"
    )


class DataConfig(_Strict):
    """Dataset selection (reference: murmura/config/schema.py:153-159)."""

    adapter: str = Field(description="Dataset adapter id (e.g. 'leaf.femnist')")
    params: Dict[str, Any] = Field(
        default_factory=dict, description="Dataset-specific parameters"
    )


class ModelConfig(_Strict):
    """Model selection (reference: murmura/config/schema.py:162-168)."""

    factory: str = Field(description="Model factory identifier")
    params: Dict[str, Any] = Field(
        default_factory=dict, description="Model-specific parameters"
    )


class DistributedConfig(_Strict):
    """ZeroMQ distributed backend (reference: murmura/config/schema.py:7-51)."""

    transport: Literal["ipc", "tcp"] = Field(
        default="ipc", description="ipc (single machine) or tcp (multi-machine)"
    )
    ipc_dir: str = Field(
        default="/tmp/murmura_tpu", description="Base dir for IPC socket files"
    )
    host: str = Field(default="127.0.0.1", description="Coordinator host (tcp)")
    coordinator_pub_port: int = Field(default=5500, description="Coordinator PUB port")
    coordinator_pull_port: int = Field(default=5501, description="Coordinator PULL port")
    base_port: int = Field(
        default=5550, description="Node i binds its PULL socket on base_port + i"
    )
    node_hosts: Optional[Dict[int, str]] = Field(
        default=None, description="Per-node host overrides for tcp: {node_id: host}"
    )
    round_duration_s: float = Field(
        default=60.0, description="Wall-clock budget per round in seconds"
    )
    startup_grace_s: float = Field(
        default=5.0, description="Seconds between launch and the first round start"
    )


class TPUConfig(_Strict):
    """TPU backend settings — new in murmura_tpu (no reference counterpart).

    Controls how the ``nodes`` axis of the stacked network state is laid out
    over a :class:`jax.sharding.Mesh` and how the per-round neighbor exchange
    is realized as XLA collectives.
    """

    num_devices: Optional[int] = Field(
        default=None,
        description="Devices in the mesh (None = all available devices)",
    )
    multihost: bool = Field(
        default=False,
        description=(
            "Initialize jax.distributed before building the mesh so the "
            "node axis spans all hosts of a multi-host TPU slice (ICI "
            "within a slice, DCN across slices). Coordinator settings come "
            "from the standard JAX env vars unless given below."
        ),
    )
    coordinator_address: Optional[str] = Field(
        default=None, description="host:port of process 0 (multihost)"
    )
    num_processes: Optional[int] = Field(
        default=None, description="Total JAX processes (multihost)"
    )
    process_id: Optional[int] = Field(
        default=None, description="This process's id (multihost)"
    )
    exchange: Literal["allgather", "ppermute"] = Field(
        default="allgather",
        description=(
            "Neighbor exchange strategy: allgather (every node sees [N,P]; "
            "O(N) memory, right for dense graphs) or ppermute (ring shifts, "
            "O(degree); right for ring/k-regular at large N)"
        ),
    )
    param_shards: int = Field(
        default=1,
        ge=1,
        description=(
            "Param-axis sharding (docs/PERFORMANCE.md 'Param-axis "
            "sharding'): split the flattened parameter vector over a "
            "third ('seed', 'nodes', 'param') mesh axis so every [N, P] "
            "round tensor — broadcast, stale cache, pipeline buffers, EF "
            "residual, the aggregation output — is resident at "
            "N x P/shards per device (ZeRO-style, arXiv:2004.13336).  "
            "The flat vector zero-pads to a multiple of the shard count; "
            "1 (default) is byte-identical to the unsharded program.  "
            "Largest-dividing-factor fallback picks the actual mesh axis "
            "when the device count cannot honor the full request."
        ),
    )
    param_dtype: Optional[Literal["float32", "bfloat16"]] = Field(
        default=None,
        description=(
            "Resident model-parameter dtype. None = auto: bfloat16 at "
            "num_nodes >= 64 (the documented large-N setting — halves the "
            "[N, P] state and the SGD update's HBM traffic; bench_sgd_micro "
            "measures the lever), float32 below. Set explicitly to pin."
        ),
    )
    conv_impl: Literal["direct", "im2col"] = Field(
        default="direct",
        description=(
            "CNN conv lowering: direct (lax.conv) or im2col (patch "
            "extraction + batched GEMM — the other bench_sgd_micro "
            "local-SGD lever candidate; same HWIO params, checkpoints "
            "interchangeable). Chip-measurement-gated: flip per run."
        ),
    )
    compute_dtype: Literal["float32", "bfloat16"] = Field(
        default="bfloat16", description="Matmul/conv compute dtype (MXU-friendly)"
    )
    donate_state: bool = Field(
        default=True, description="Donate round-step input buffers to XLA"
    )
    compilation_cache_dir: Optional[str] = Field(
        default=None,
        description=(
            "Enable JAX's persistent compilation cache at this path: "
            "recompiles of an identical round program (across runs and "
            "processes) become disk hits instead of 10-60s XLA compiles."
        ),
    )
    rounds_per_dispatch: int = Field(
        default=1,
        ge=1,
        description=(
            "Fuse this many FL rounds into one lax.scan program (device-"
            "resident round loop; one dispatch + one metrics fetch per "
            "chunk). Eval keeps the eval_every cadence via lax.cond."
        ),
    )
    profile_dir: Optional[str] = Field(
        default=None, description="If set, write a jax.profiler trace here"
    )
    pallas_agg: bool = Field(
        default=False,
        description=(
            "Route the aggregation hot loop's distance/selection passes "
            "through the fused Pallas TPU kernels (ops/pallas_agg.py): one "
            "streamed read of the [N, P] broadcast instead of one per "
            "offset/candidate.  Interpreted (and parity-tested) on CPU; "
            "ignored on a sharded node axis (pallas_call does not "
            "decompose under GSPMD).  Env twin: MURMURA_PALLAS_AGG=1."
        ),
    )
    recompile_guard: bool = Field(
        default=False,
        description=(
            "Runtime sanitizer: count XLA compilations per round and fail "
            "the run (analysis.sanitizers.RecompileError) if any occur "
            "after a program's warmup execution — post-warmup compiles "
            "mean the round signature is unstable and each one stalls the "
            "device for a full XLA build. Works on every backend."
        ),
    )
    transfer_guard: bool = Field(
        default=False,
        description=(
            "Runtime sanitizer: run the round loop under "
            "jax.transfer_guard('disallow') so implicit host<->device "
            "transfers raise instead of silently serializing the hot "
            "path (explicit jnp.asarray/device_get traffic still passes)."
        ),
    )


class Config(_Strict):
    """Top-level config object (reference: murmura/config/schema.py:171-198)."""

    experiment: ExperimentConfig
    topology: TopologyConfig
    aggregation: AggregationConfig
    attack: AttackConfig = Field(default_factory=AttackConfig)
    training: TrainingConfig
    data: DataConfig
    model: ModelConfig
    backend: Literal["simulation", "distributed", "tpu"] = Field(
        default="simulation",
        description=(
            "Execution backend: simulation (single-device vmap), distributed "
            "(ZMQ multi-process), or tpu (node axis sharded over a device mesh)"
        ),
    )
    distributed: DistributedConfig = Field(
        default_factory=DistributedConfig,
        description="ZMQ backend settings (used when backend=distributed)",
    )
    tpu: TPUConfig = Field(
        default_factory=TPUConfig,
        description="TPU backend settings (used when backend=tpu)",
    )
    mobility: Optional[MobilityConfig] = Field(
        default=None,
        description="Mobility model; if set, topology varies per round via G^t",
    )
    dmtt: Optional[DMTTConfig] = Field(
        default=None,
        description="DMTT protocol settings; requires mobility to also be set",
    )
    faults: FaultsConfig = Field(
        default_factory=FaultsConfig,
        description=(
            "Operational fault model (churn/link drops/stragglers/NaN "
            "quarantine); default off => byte-identical to no faults block"
        ),
    )
    telemetry: TelemetryConfig = Field(
        default_factory=TelemetryConfig,
        description=(
            "Unified telemetry (run manifest + event stream + audit taps); "
            "default off => byte-identical to no telemetry block"
        ),
    )
    compression: CompressionConfig = Field(
        default_factory=CompressionConfig,
        description=(
            "Compressed neighbor exchange (int8/topk with error feedback); "
            "default (none) => byte-identical to no compression block"
        ),
    )
    exchange: ExchangeConfig = Field(
        default_factory=ExchangeConfig,
        description=(
            "Exchange-layer semantics: bounded-staleness gossip "
            "(stale-tolerant cache + age-bounded re-delivery under "
            "faults; docs/ROBUSTNESS.md) and pipelined rounds (delayed "
            "aggregation overlapping local training; "
            "docs/PERFORMANCE.md); default (max_staleness 0, pipeline "
            "false) => byte-identical to no exchange block"
        ),
    )
    sweep: Optional[SweepConfig] = Field(
        default=None,
        description=(
            "Gang-batched multi-seed execution (`murmura sweep`): vmap the "
            "round program over an [S] experiment axis — one compile, one "
            "saturated dispatch for the whole sweep; absent => byte-"
            "identical behavior to today"
        ),
    )
    population: Optional[PopulationConfig] = Field(
        default=None,
        description=(
            "Sampled-cohort streaming over a virtual population "
            "(docs/SCALING.md); absent or disabled => byte-identical "
            "behavior to today"
        ),
    )
    durability: DurabilityConfig = Field(
        default_factory=DurabilityConfig,
        description=(
            "Run-level durability: crash-equivalent checkpoint/resume + "
            "retry/backoff dispatch envelope + require-tpu hard-fail; "
            "default off => byte-identical to no durability block"
        ),
    )
    frontier: Optional[FrontierConfig] = Field(
        default=None,
        description=(
            "`murmura frontier` adversarial-search grid (rule x adaptive "
            "attack x topology breaking-point curves; docs/ROBUSTNESS.md); "
            "absent => byte-identical behavior (only the frontier command "
            "reads it)"
        ),
    )
    grid: Optional[GridConfig] = Field(
        default=None,
        description=(
            "`murmura grid` compile-compatible scheduler grid (rule x "
            "attack x topology cells partitioned into jaxpr-skeleton "
            "buckets; docs/ROBUSTNESS.md \"Serving\"); absent => "
            "byte-identical behavior (only the grid command reads it)"
        ),
    )
    serve: Optional[ServeConfig] = Field(
        default=None,
        description=(
            "`murmura serve` multi-tenant daemon settings (state dir, "
            "socket, bucket capacity, checkpoint cadence; "
            "docs/ROBUSTNESS.md \"Serving\"); absent => byte-identical "
            "behavior (only the serve command reads it)"
        ),
    )

    @model_validator(mode="after")
    def _adaptive_attack_is_wirable(self):
        a = self.attack
        if not a.adaptive.enabled:
            return self
        if not a.enabled or a.type is None:
            # Same fail-loud discipline as the telemetry sub-settings: an
            # adaptive block without an attack would silently run benign.
            raise ValueError(
                "attack.adaptive.enabled requires attack.enabled: true "
                "and an attack.type — there is no attack to adapt"
            )
        if a.type in ("label_flip", "topology_liar"):
            raise ValueError(
                f"attack.adaptive does not support attack.type "
                f"'{a.type}': label_flip poisons data (no broadcast "
                "perturbation to scale) and topology_liar's claims "
                "channel is not modeled by the adaptation state; use "
                "gaussian/directed_deviation (bisection), alie "
                "(adaptive ALIE) or ipm (adaptive IPM)"
            )
        if self.backend == "distributed":
            raise ValueError(
                "adaptive attacks close the feedback loop inside the "
                "jitted round program; backend: distributed trains in "
                "per-node OS processes — use backend: simulation or tpu"
            )
        if self.dmtt is not None:
            raise ValueError(refusal_reason("adaptive", "dmtt"))
        return self

    @model_validator(mode="after")
    def _telemetry_requires_enabled(self):
        t = self.telemetry
        if not t.enabled and (
            t.audit_taps or t.memory_stats or t.profile_rounds
            or t.profile_start_round or t.dir is not None
            or t.profile_dir is not None
        ):
            # A sub-feature without the master switch would silently record
            # nothing — the experiment would *look* instrumented.  Fail loud.
            raise ValueError(
                "telemetry sub-settings (audit_taps/memory_stats/"
                "profile_rounds/profile_start_round/profile_dir/dir) "
                "require telemetry.enabled: true"
            )
        return self

    @model_validator(mode="after")
    def _sweep_is_wirable(self):
        if self.sweep is None:
            return self
        if self.backend == "distributed":
            raise ValueError(
                "sweep (gang-batched execution) runs the vmapped round "
                "program in one process; backend: distributed trains in "
                "per-node OS processes — use backend: simulation or tpu"
            )
        for i, m in enumerate(self.sweep.members or []):
            if m.noise_std is not None:
                if not (
                    self.attack.enabled and self.attack.type == "gaussian"
                ):
                    raise ValueError(
                        f"sweep.members[{i}].noise_std requires an enabled "
                        "gaussian attack (it rescales the gaussian "
                        "perturbation); use attack_scale for other attacks"
                    )
                if m.attack_scale is not None:
                    raise ValueError(
                        f"sweep.members[{i}] sets both noise_std and "
                        "attack_scale — they are two spellings of the same "
                        "multiplier; pick one"
                    )
            if (
                m.attack_scale is not None or m.noise_std is not None
            ) and not self.attack.enabled:
                raise ValueError(
                    f"sweep.members[{i}] overrides the attack but "
                    "attack.enabled is false — there is no perturbation "
                    "to scale"
                )
        return self

    @model_validator(mode="after")
    def _faults_injection_in_range(self):
        if self.faults.enabled and self.faults.nan_inject_nodes:
            bad = [
                i for i in self.faults.nan_inject_nodes
                if not 0 <= i < self.topology.num_nodes
            ]
            if bad:
                raise ValueError(
                    f"faults.nan_inject_nodes {bad} out of range for "
                    f"topology.num_nodes={self.topology.num_nodes}"
                )
        return self

    @model_validator(mode="after")
    def _sparse_topology_is_wirable(self):
        if self.topology.type not in ("exponential", "one_peer"):
            return self
        if self.backend == "distributed":
            raise ValueError(
                "sparse topologies (exponential/one_peer) run the [k, N] "
                "edge-mask exchange engine, which lives in the jitted "
                "backends; backend: distributed is not wired for it — use "
                "backend: simulation or tpu"
            )
        if self.mobility is not None:
            raise ValueError(refusal_reason("mobility", "sparse"))
        if self.dmtt is not None:
            raise ValueError(refusal_reason("dmtt", "sparse"))
        return self

    @model_validator(mode="after")
    def _population_is_wirable(self):
        p = self.population
        if p is None:
            return self
        if not p.enabled:
            if p.virtual_size or p.cohort_size is not None:
                # Same fail-loud discipline as the telemetry sub-settings:
                # a sized population without the master switch would
                # silently run as a plain N-node experiment.
                raise ValueError(
                    "population.virtual_size/cohort_size require "
                    "population.enabled: true"
                )
            return self
        n = self.topology.num_nodes
        if p.cohort_size is not None and p.cohort_size != n:
            raise ValueError(
                f"population.cohort_size={p.cohort_size} must equal "
                f"topology.num_nodes={n} — the cohort IS the compiled "
                "round program's node axis"
            )
        if p.virtual_size < n:
            raise ValueError(
                f"population.virtual_size={p.virtual_size} must be >= "
                f"topology.num_nodes={n} (the cohort is drawn without "
                "replacement)"
            )
        if self.backend == "distributed":
            raise ValueError(
                "population (cohort streaming) swaps device-resident "
                "state between rounds; backend: distributed keeps state "
                "in per-node OS processes — use backend: simulation or tpu"
            )
        if self.sweep is not None:
            raise ValueError(refusal_reason("population", "sweep"))
        if self.dmtt is not None:
            raise ValueError(refusal_reason("dmtt", "population"))
        return self

    @model_validator(mode="after")
    def _compression_is_wirable(self):
        c = self.compression
        if c.algorithm == "none":
            if c.error_feedback:
                # Same fail-loud discipline as the telemetry sub-settings:
                # error feedback without a codec would silently run an
                # uncompressed exchange while the config *looks* compressed.
                raise ValueError(
                    "compression.error_feedback requires a codec "
                    "(compression.algorithm: int8 or topk)"
                )
            return self
        if self.backend == "distributed":
            raise ValueError(
                "compressed exchange runs inside the jitted round program; "
                "backend: distributed exchanges full states over ZMQ — use "
                "backend: simulation or tpu"
            )
        if self.dmtt is not None:
            raise ValueError(refusal_reason("compression", "dmtt"))
        if self.population is not None and self.population.enabled:
            if c.error_feedback or c.algorithm == "topk":
                # Both the error-feedback residual and the topk reference
                # estimate are per-slot [N, P] state; cohort swaps reassign
                # slots to different users, so the carried state would be
                # fed into the wrong user's stream.  Stateless int8 is fine.
                raise ValueError(
                    refusal_reason("compression", "population", "carried_state")
                )
        return self

    @model_validator(mode="after")
    def _exchange_is_wirable(self):
        e = self.exchange
        if e.max_staleness == 0:
            if e.staleness_discount != 1.0:
                # Same fail-loud discipline as the telemetry sub-settings:
                # a discount without the staleness bound would silently
                # run strict-synchronous while the config *looks* stale-
                # tolerant.
                raise ValueError(
                    "exchange.staleness_discount requires "
                    "exchange.max_staleness >= 1 (there is no stale edge "
                    "to discount)"
                )
            return self
        if not self.faults.enabled:
            raise ValueError(
                refusal_reason("faults", "staleness", "requires_faults")
            )
        if self.backend == "distributed":
            raise ValueError(
                "bounded staleness runs inside the jitted round program "
                "(the cache rides the scan carry); backend: distributed "
                "realizes deadlines physically over ZMQ — use backend: "
                "simulation or tpu"
            )
        if self.dmtt is not None:
            raise ValueError(refusal_reason("dmtt", "staleness"))
        if self.mobility is not None:
            raise ValueError(refusal_reason("mobility", "staleness"))
        if self.topology.type == "one_peer":
            raise ValueError(
                refusal_reason("sparse", "staleness", "one_peer")
            )
        if self.population is not None and self.population.enabled:
            raise ValueError(refusal_reason("population", "staleness"))
        return self

    @model_validator(mode="after")
    def _pipeline_is_wirable(self):
        if not self.exchange.pipeline:
            return self
        if self.backend == "distributed":
            raise ValueError(
                "exchange.pipeline runs the delayed aggregation inside "
                "the jitted round program (the buffer rides the scan "
                "carry); backend: distributed exchanges full states over "
                "ZMQ per round — use backend: simulation or tpu"
            )
        if self.dmtt is not None:
            raise ValueError(refusal_reason("dmtt", "pipeline"))
        if self.attack.adaptive.enabled:
            raise ValueError(refusal_reason("adaptive", "pipeline"))
        if self.population is not None and self.population.enabled:
            raise ValueError(refusal_reason("pipeline", "population"))
        return self

    @model_validator(mode="after")
    def _param_shards_are_wirable(self):
        s = self.tpu.param_shards
        if s == 1:
            return self
        if self.backend != "tpu":
            raise ValueError(
                "tpu.param_shards > 1 requires backend: tpu — the param "
                "axis is a mesh axis; the simulation backend has no mesh "
                "to shard over"
            )
        if self.dmtt is not None:
            raise ValueError(refusal_reason("dmtt", "sharding"))
        if self.compression.algorithm == "topk":
            raise ValueError(
                refusal_reason("compression", "sharding", "topk")
            )
        # sweep x sharding LIFTED: the gang mesh grew a
        # "param" role — make_gang_param_mesh lays ("seed", "nodes",
        # "param") and the [S, N, P] stacked state shards on it.
        if self.population is not None and self.population.enabled:
            raise ValueError(refusal_reason("population", "sharding"))
        return self

    @model_validator(mode="after")
    def _durability_is_wirable(self):
        d = self.durability
        if d.checkpoint_dir is None and (d.resume or d.retries):
            # Same fail-loud discipline as the telemetry sub-settings: a
            # resume/retry posture without a snapshot location would
            # silently run non-durable while the config *looks* durable.
            raise ValueError(
                "durability.resume/retries require durability."
                "checkpoint_dir (there is nothing to restore from)"
            )
        if d.retry_max_delay_s < d.retry_base_delay_s:
            raise ValueError(
                f"durability.retry_max_delay_s={d.retry_max_delay_s} < "
                f"retry_base_delay_s={d.retry_base_delay_s}"
            )
        if d.checkpoint_dir is not None and self.backend == "distributed":
            raise ValueError(
                "durability.checkpoint_dir is not supported with "
                "backend: distributed — run state lives in per-node "
                "processes, which keep their own per-node fsync'd "
                "checkpoints (faults.enabled crash recovery)"
            )
        return self

    @model_validator(mode="after")
    def _dmtt_requires_mobility(self):
        if self.dmtt is not None and self.mobility is None and not self.dmtt.allow_static:
            raise ValueError(
                refusal_reason("dmtt", "mobility", "requires_mobility")
            )
        return self
