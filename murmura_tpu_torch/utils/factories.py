"""Config -> object wiring (the PyTorch counterpart of the plain path of
murmura_tpu/utils/factories.py).

``build_network_from_config`` builds data, model, topology, the mobility
model, the attack (with its label poison, or a topology liar's claims), the
aggregation rule, the fault schedule and spec, the compression and
staleness specs, the DMTT parameters, the telemetry writer and the round
program (pipelined under ``exchange.pipeline``; on the [k, N] edge mask
for a sparse topology), and a PopulationNetwork where ``population`` is
enabled; it refuses by name every part of the configuration surface the
port does not run yet — a refused section is an error, never a silent
fallback.  The ``frontier:``, ``grid:`` and ``serve:`` blocks are read only
by their drivers (frontier.py, serve/); ``run`` runs the base experiment.
With ``tpu.param_shards`` > 1 the round program pads the flat vector for
the shard count; in a rank of a param group (parallel/launch.py sets the
process's group) it is that rank's sharded program, and only rank 0 gets
the telemetry writer and the profiler directory.
``build_gang_from_config`` builds the same per member of a gang
(core/gang.py): data, initial parameters and draws from each member's
seed, one attack placement, topology, mobility model and fault schedule
for all (each member its own DMTT trust state);
``build_gang_member_programs`` builds a generation's member programs alone,
for a warm gang to admit.
"""

import os
from typing import List, Optional

import numpy as np
import torch

from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.attacks import ATTACKS
from murmura_tpu_torch.attacks.adaptive import (
    make_adaptive_alie_attack,
    make_adaptive_ipm_attack,
    make_bisection_attack,
)
from murmura_tpu_torch.attacks.base import Attack, select_compromised
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.core.rounds import PROBE_RULES, build_round_program
from murmura_tpu_torch.core.stale import StalenessSpec
from murmura_tpu_torch.levers import refusal_reason
from murmura_tpu_torch.data.registry import build_federated_data
from murmura_tpu_torch.dmtt.protocol import DMTTParams
from murmura_tpu_torch.faults.schedule import FaultSchedule, FaultSpec
from murmura_tpu_torch.models.registry import build_model
from murmura_tpu_torch.ops.compress import CompressionSpec
from murmura_tpu_torch.ops.flatten import model_dimension, padded_dim
from murmura_tpu_torch.parallel.mesh import process_group
from murmura_tpu_torch.population import PopulationNetwork, PopulationSpec
from murmura_tpu_torch.topology.dynamic import MobilityModel
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.topology.sparse import SparseTopology
from murmura_tpu_torch.utils.checkpoint import has_checkpoint


class ConfigError(ValueError):
    """The config validated but asks for something the port cannot run
    (an unported lever, an unsupported exchange mode, a data/model
    mismatch).  The CLI renders these as messages, not tracebacks."""


# What param-axis sharding does not run yet (ROADMAP Queue A).
SHARDING_UNPORTED = {
    "sweep": "sweep with tpu.param_shards > 1 (a gang over a param group)",
    "probe_rules": "aggregation.algorithm: {} with tpu.param_shards > 1 (its probe forwards "
                   "need whole neighbour rows)",
}


def unported_sections(config: Config) -> List[str]:
    """Every enabled part of the config the port does not run yet."""
    out = []
    if config.tpu.param_shards > 1:
        if config.sweep is not None:
            out.append(SHARDING_UNPORTED["sweep"])
        if config.aggregation.algorithm in PROBE_RULES:
            out.append(SHARDING_UNPORTED["probe_rules"].format(config.aggregation.algorithm))
    if config.tpu.multihost:
        out.append("tpu.multihost")
    a = config.attack
    if a.enabled and a.type is not None and a.type not in ATTACKS:
        out.append(f"attack.type: {a.type}")
    return out


def resolved_param_dtype(config: Config) -> Optional[str]:
    """tpu.param_dtype with the JAX package's auto default: bfloat16 from 64
    nodes up, float32 below, an explicit setting always wins."""
    if config.backend != "tpu":
        return None
    if config.tpu.param_dtype is not None:
        return config.tpu.param_dtype
    return "bfloat16" if config.topology.num_nodes >= 64 else "float32"


def build_fault_schedule(config: Config) -> Optional[FaultSchedule]:
    """FaultSchedule from config.faults, or None when the model is off."""
    f = config.faults
    if not f.enabled:
        return None
    return FaultSchedule(
        config.topology.num_nodes,
        crash_prob=f.crash_prob,
        recovery_prob=f.recovery_prob,
        min_down_rounds=f.min_down_rounds,
        link_drop_prob=f.link_drop_prob,
        straggler_prob=f.straggler_prob,
        straggler_factor=f.straggler_factor,
        seed=f.seed,
    )


def build_fault_spec(config: Config) -> Optional[FaultSpec]:
    """The round program's FaultSpec from config.faults, or None when off."""
    f = config.faults
    if not f.enabled:
        return None
    return FaultSpec(
        nan_quarantine=f.nan_quarantine,
        nan_inject_nodes=tuple(f.nan_inject_nodes),
        nan_inject_from_round=f.nan_inject_from_round,
    )


def build_compression_spec(config: Config) -> Optional[CompressionSpec]:
    """CompressionSpec from config.compression, or None when off."""
    c = config.compression
    if c.algorithm == "none":
        return None
    return CompressionSpec(
        algorithm=c.algorithm,
        block=c.block,
        topk_ratio=c.topk_ratio,
        error_feedback=c.error_feedback,
    )


def build_mobility(config: Config) -> Optional[MobilityModel]:
    """MobilityModel from config.mobility, or None without one."""
    m = config.mobility
    if m is None:
        return None
    return MobilityModel(
        num_nodes=config.topology.num_nodes,
        area_size=m.area_size,
        comm_range=m.comm_range,
        max_speed=m.max_speed,
        seed=m.seed,
        ensure_connected=m.ensure_connected,
    )


def build_dmtt_params(config: Config) -> Optional[DMTTParams]:
    """DMTTParams from config.dmtt, or None without it."""
    if config.dmtt is None:
        return None
    return DMTTParams(**config.dmtt.model_dump(exclude={"allow_static"}))


def build_population_spec(config: Config) -> Optional[PopulationSpec]:
    """PopulationSpec from config.population, or None when off."""
    p = config.population
    if p is None or not p.enabled:
        return None
    return PopulationSpec(
        virtual_size=p.virtual_size,
        sampler=p.sampler,
        seed=p.seed,
        rounds_per_cohort=p.rounds_per_cohort,
        data_binding=p.data_binding,
        bank_dir=p.bank_dir,
        inherit=p.inherit,
    )


def build_staleness_spec(config: Config, topology) -> Optional[StalenessSpec]:
    """StalenessSpec from config.exchange, or None when off.  The base mask
    is the unfaulted graph re-added stale edges are drawn from: the
    topology's static [N, N] mask, or the all-active [k, N] edge mask of a
    sparse topology (one_peer's round-varying mask is refused by the
    schema)."""
    e = config.exchange
    if e.max_staleness <= 0:
        return None
    if isinstance(topology, SparseTopology):
        base = np.ones((len(topology.offsets), topology.num_nodes), np.float32)
    else:
        base = np.asarray(topology.mask(), dtype=np.float32)
    return StalenessSpec(
        max_staleness=e.max_staleness,
        discount=e.staleness_discount,
        base_mask=base,
    )


def sparse_offsets_of(topology):
    """A sparse topology's offsets (its round program takes the [k, N] edge
    mask), else None."""
    return tuple(topology.offsets) if isinstance(topology, SparseTopology) else None


def default_telemetry_dir(config: Config) -> str:
    """The run directory of a telemetry-enabled config when
    ``telemetry.dir`` is unset: ``murmura_runs/<experiment name>``."""
    return config.telemetry.dir or os.path.join("murmura_runs", config.experiment.name)


def build_telemetry_writer(config: Config, resume: bool = False, run_id=None):
    """TelemetryWriter from config.telemetry, or None when off (and on a
    param group's ranks other than 0).  ``resume``: the run continues from
    its snapshot, so the writer appends to the run dir's stream instead of
    rotating it.  ``run_id``: the manifest's run id (the distributed
    Monitor passes its run's), else generated."""
    t = config.telemetry
    group = process_group()
    if not t.enabled or (group is not None and group.rank != 0):
        return None
    from murmura_tpu_torch.telemetry.writer import TelemetryWriter

    return TelemetryWriter(
        default_telemetry_dir(config),
        run_id=run_id,
        config=config,
        phase_times=t.phase_times,
        memory_stats=t.memory_stats,
        profile_dir=t.profile_dir,
        profile_start_round=t.profile_start_round,
        profile_rounds=t.profile_rounds,
        resume=resume,
    )


def select_compromised_count(n: int, pct: float, seed: int) -> int:
    """Size of the compromised set a (n, pct, seed) selection yields."""
    return int(select_compromised(n, pct, seed).sum())


def build_attack(config: Config) -> Optional[Attack]:
    """The configured attack.  Its seed is attack.params.seed, else the
    experiment seed; each type reads its own params as the JAX factories
    do (gaussian ``noise_std`` or ``std``, directed ``lambda_param``, ALIE
    ``z`` and ``estimator``, IPM ``epsilon``, label flip
    ``flip_fraction``; a topology liar's ``model_attack_type``, gaussian or
    directed_deviation with their params, or none for claims only).

    With ``attack.adaptive.enabled`` the attack becomes its closed-loop
    twin (attacks/adaptive.py): ALIE adaptive ALIE, IPM adaptive IPM, and
    gaussian and directed deviation the scale bisection around them."""
    if not config.attack.enabled or not config.attack.type:
        return None
    n = config.topology.num_nodes
    pct = config.attack.percentage
    p = config.attack.params
    seed = int(p.get("seed", config.experiment.seed))
    kind = config.attack.type
    ad = config.attack.adaptive
    if ad.enabled and config.backend == "distributed":
        # The schema refuses this too; a config built in code gets the same.
        raise ConfigError("adaptive attacks are not wired into backend: distributed")

    def bisect(inner: Attack) -> Attack:
        if not ad.enabled:
            return inner
        return make_bisection_attack(inner, scale_init=ad.scale_init, scale_max=ad.scale_max,
                                     growth=ad.growth, accept_target=ad.accept_target,
                                     ema_beta=ad.ema_beta)

    if kind == "gaussian":
        return bisect(ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                                    noise_std=float(p.get("noise_std", p.get("std", 10.0)))))
    if kind == "directed_deviation":
        return bisect(ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                                    lambda_param=float(p.get("lambda_param", -5.0))))
    if kind in ("alie", "ipm") and config.backend == "distributed" and config.dmtt is not None:
        # The DMTT node process has no coalition branch: a colluding attack
        # would silently run no attack (the JAX factories' refusal).
        raise ConfigError(
            f"attack type '{kind}' is not wired into the DMTT distributed round "
            "protocol; use backend: simulation/tpu, or a different attack on the "
            "distributed backend"
        )
    if kind == "alie":
        estimator = str(p.get("estimator", "omniscient"))
        if estimator not in ("omniscient", "coalition"):
            raise ConfigError(
                f"attack.params.estimator must be 'omniscient' or 'coalition', "
                f"got {estimator!r}"
            )
        if ((config.backend == "distributed" or estimator == "coalition")
                and select_compromised_count(n, pct, seed) < 2):
            # With one colluder sigma is 0 and mu - z*sigma is its own benign
            # state: a run labelled ALIE that attacks nothing.  The ZMQ
            # backend always takes the coalition estimator.
            raise ConfigError(
                "the ALIE coalition estimator needs at least 2 compromised nodes "
                "(mu/sigma over the coalition sample is degenerate with 1); raise "
                "attack.percentage, or use the omniscient estimator on backend: "
                "simulation/tpu"
            )
        if ad.enabled:
            return make_adaptive_alie_attack(
                num_nodes=n, attack_percentage=pct, z=p.get("z"), seed=seed,
                estimator=estimator, eta=ad.eta, accept_target=ad.accept_target,
                ema_beta=ad.ema_beta, z_min=ad.z_min, z_cap=ad.z_cap)
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             z=p.get("z"), estimator=estimator)
    if kind == "ipm":
        if ad.enabled:
            # IPM walks its own knob (epsilon), not the generic bisection.
            return make_adaptive_ipm_attack(
                num_nodes=n, attack_percentage=pct, epsilon=p.get("epsilon"), seed=seed,
                eta=ad.eta, accept_target=ad.accept_target, ema_beta=ad.ema_beta)
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             epsilon=p.get("epsilon"))
    if kind == "label_flip":
        if config.backend == "distributed":
            # The node processes build their shards without the poison: an
            # identity state attack over clean data would be a silent
            # no-attack run (the JAX factories' refusal).
            raise ConfigError(
                "attack type 'label_flip' is not wired into the ZMQ distributed "
                "backend (per-process data is built without the poison transform); "
                "use backend: simulation/tpu"
            )
        ff = float(p.get("flip_fraction", 1.0))
        if not 0.0 < ff <= 1.0:
            raise ConfigError(f"attack.params.flip_fraction must be in (0, 1], got {ff}")
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             flip_fraction=ff)
    if kind == "topology_liar":
        inner = None
        inner_type = p.get("model_attack_type")
        if inner_type == "gaussian":
            inner = ATTACKS["gaussian"](num_nodes=n, attack_percentage=pct, seed=seed,
                                        noise_std=float(p.get("noise_std", 10.0)))
        elif inner_type == "directed_deviation":
            inner = ATTACKS["directed_deviation"](num_nodes=n, attack_percentage=pct,
                                                  seed=seed,
                                                  lambda_param=float(p.get("lambda_param", -5.0)))
        elif inner_type is not None:
            # A typo must not degrade to topology lies only: the run would
            # measure another threat model.
            raise ConfigError(
                f"topology_liar model_attack_type '{inner_type}' is not supported; use "
                "'gaussian' or 'directed_deviation' (or omit for topology lies only)"
            )
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             model_attack=inner)
    raise ConfigError(f"attack.type: {kind} is not ported")


def resolve_model(config: Config, data):
    """Build the model with the data/model shape check.  A wearable model
    takes its input width from the data (window parameters change it)
    unless the config pins ``input_dim``; its other widths default to the
    kind's (models/registry.py)."""
    import numpy as np

    model_params = dict(config.model.params)
    if config.backend == "tpu":
        model_params.setdefault("compute_dtype", config.tpu.compute_dtype)
        factory_lc = config.model.factory.lower()
        if config.tpu.conv_impl != "direct" and (
            "femnist" in factory_lc or "celeba" in factory_lc
        ):
            # A CNN-only lever: the other models have no im2col form.
            model_params.setdefault("conv_impl", config.tpu.conv_impl)
    if (
        "wearables." in config.model.factory
        and "input_dim" not in model_params
        and data.x.ndim == 3
    ):
        model_params["input_dim"] = int(data.x.shape[-1])
    try:
        model = build_model(config.model.factory, model_params)
    except ValueError as e:
        raise ConfigError(str(e)) from None
    sample_shape = tuple(data.x.shape[2:])
    if (
        model.input_shape
        and sample_shape
        and int(np.prod(sample_shape)) != int(np.prod(model.input_shape))
    ):
        raise ConfigError(
            f"data/model mismatch: adapter '{config.data.adapter}' yields "
            f"samples of shape {sample_shape} but model factory "
            f"'{config.model.factory}' expects input_shape "
            f"{tuple(model.input_shape)}"
        )
    return model


def build_rule(config: Config, model, topology):
    """The aggregation rule of ``config`` for ``topology`` and its probe
    size: a sparse topology always runs the [k, N] edge-mask exchange (the
    circulant paths under the edge mask, whatever ``tpu.exchange`` says),
    ``tpu.exchange: ppermute`` the circulant paths of a circulant topology.
    ``tpu.pallas_agg`` selects nothing here: on the card the distance
    kernels are the implementation, with no alternative path to opt out to."""
    agg_params = dict(config.aggregation.params)
    sparse = isinstance(topology, SparseTopology)
    if sparse:
        agg_params["exchange_offsets"] = list(topology.offsets)
        agg_params["sparse_exchange"] = True
    elif config.backend == "tpu" and config.tpu.exchange == "ppermute":
        if config.mobility is not None or config.dmtt is not None:
            raise ConfigError(
                "tpu.exchange: ppermute requires a static circulant topology "
                "(mobility/dmtt graphs change per round)"
            )
        offsets = topology.circulant_offsets()
        if offsets is None:
            raise ConfigError(
                f"tpu.exchange: ppermute requires a circulant topology "
                f"(ring/k-regular); '{config.topology.type}' is not"
            )
        agg_params["exchange_offsets"] = offsets
    if (config.aggregation.algorithm in ("krum", "median", "trimmed_mean", "geometric_median")
            and not sparse and config.mobility is None and config.dmtt is None):
        # Static graph: bound the per-node candidate block at max-degree + 1.
        # A mobility or DMTT graph changes every round: no static bound.
        agg_params.setdefault(
            "max_candidates", int(topology.mask().sum(axis=1).max()) + 1
        )
    # Evidential trust probes max_eval_samples a node; UBAR one batch.
    if config.aggregation.algorithm == "evidential_trust":
        probe_size = int(agg_params.get("max_eval_samples", 100))
    else:
        probe_size = config.training.batch_size
    model_dim = 0
    if config.aggregation.algorithm == "sketchguard":
        # Only Sketchguard's tables need the model dimension up front: the
        # padded width its [N, P] operands have.
        model_dim = padded_dim(model_dimension(model.init(torch.Generator().manual_seed(0),
                                                          "cpu")),
                               param_shards_of(config))
    try:
        agg = build_aggregator(config.aggregation.algorithm, agg_params, model_dim=model_dim)
    except ValueError as e:
        raise ConfigError(str(e)) from None
    return agg, probe_size


def param_shards_of(config: Config) -> int:
    """tpu.param_shards where it applies (backend: tpu), else 1."""
    return config.tpu.param_shards if config.backend == "tpu" else 1


def build_topology(config: Config):
    """The config's topology: dense, or a SparseTopology (exponential,
    one_peer)."""
    return create_topology(
        config.topology.type,
        num_nodes=config.topology.num_nodes,
        p=config.topology.p,
        k=config.topology.k,
        seed=config.topology.seed,
    )


def build_program(config: Config, topology, attack, seed: int, device, rule=None,
                  lr: Optional[float] = None, attack_scale: Optional[float] = None):
    """The round program of one run (a single run, or one gang member):
    data from ``seed`` with the attack's label poison, and the model and
    rule (``rule``: a (model, agg, probe_size) already built for this
    config, else built here from the data).  Returns (program, rule)."""
    try:
        data = build_federated_data(
            config.data.adapter,
            config.data.params,
            num_nodes=config.topology.num_nodes,
            seed=seed,
            max_samples=config.training.max_samples,
        )
    except ValueError as e:
        raise ConfigError(str(e)) from None
    if attack is not None and attack.data_poison_fn is not None:
        if data.x_test is None:
            # Without a held-out split the evaluation reads the training
            # shard, flipped labels included: the metric would measure the
            # poison, not its damage.
            raise ConfigError(
                "data-poisoning attacks need a clean eval split: this "
                "adapter/config evaluates on the training shard "
                "(holdout_fraction: 0.0); set holdout_fraction > 0 or "
                "use an adapter with test shards"
            )
        # Before the round program copies the labels: the probe batches
        # see the poisoned labels too.
        data.y = attack.data_poison_fn(data.y, data.mask, data.num_classes)
    if rule is None:
        model = resolve_model(config, data)
        rule = (model, *build_rule(config, model, topology))
    model, agg, probe_size = rule
    try:
        program = build_round_program(
            model,
            agg,
            data,
            local_epochs=config.training.local_epochs,
            batch_size=config.training.batch_size,
            lr=config.training.lr if lr is None else lr,
            total_rounds=config.experiment.rounds,
            attack=attack,
            seed=seed,
            probe_size=probe_size,
            param_dtype=resolved_param_dtype(config),
            device=device,
            faults=build_fault_spec(config),
            compression=build_compression_spec(config),
            audit_taps=config.telemetry.audit_taps,
            staleness=build_staleness_spec(config, topology),
            pipeline=config.exchange.pipeline,
            sparse_offsets=sparse_offsets_of(topology),
            attack_scale=attack_scale,
            dmtt=build_dmtt_params(config),
            param_shards=param_shards_of(config),
            group=process_group(),
        )
    except ValueError as e:
        # The round program's refusals (an int8 block straddling a shard,
        # a group wider than the nodes, ...) render as config messages.
        raise ConfigError(str(e)) from None
    return program, rule


def refuse_unported(config: Config) -> None:
    """Raise ConfigError naming every section the port does not run yet."""
    refused = unported_sections(config)
    if refused:
        raise ConfigError(
            "the PyTorch port does not run these config sections yet: "
            + "; ".join(refused)
        )


def build_network_from_config(config: Config, device="cuda", checkpoint_dir=None) -> Network:
    """Full wiring: data + model + aggregator + attack -> Network on ``device``
    (a PopulationNetwork when ``population`` is enabled).

    ``checkpoint_dir``: the snapshot directory this run will resume from,
    when given; the telemetry writer then appends to its stream exactly
    when a snapshot exists there (a resume with no snapshot yet is a fresh
    run).  The caller restores the snapshot (Network.restore_checkpoint)."""
    refuse_unported(config)
    if config.backend == "distributed":
        # An in-process Network would be another backend than the config
        # asks for (the JAX factories build one silently).
        raise ConfigError(
            "backend: distributed runs one OS process per node "
            "(distributed/runner.py DistributedRunner, through the run command); "
            "build_network_from_config builds the in-process backends only"
        )
    seed = config.experiment.seed
    topology = build_topology(config)
    attack = build_attack(config)
    program, _ = build_program(config, topology, attack, seed, torch.device(device))
    resume = checkpoint_dir is not None and has_checkpoint(checkpoint_dir)
    group = process_group()
    kwargs = dict(attack=attack, seed=seed, fault_schedule=build_fault_schedule(config),
                  telemetry=build_telemetry_writer(config, resume=resume),
                  profile_dir=(config.tpu.profile_dir
                               if group is None or group.rank == 0 else None),
                  transfer_guard=config.tpu.transfer_guard,
                  recompile_guard=config.tpu.recompile_guard,
                  mobility=build_mobility(config))
    spec = build_population_spec(config)
    if spec is not None:
        try:
            return PopulationNetwork(program, topology, population=spec, **kwargs)
        except ValueError as e:
            # A bank file of another size under population.bank_dir.
            raise ConfigError(str(e)) from None
    return Network(program, topology, **kwargs)


def _gang_members_and_programs(config: Config, device, seeds=None, members=None):
    """The checks a gang's wiring shares with an admission, and the member
    programs: (members, topology, attack, programs)."""
    from murmura_tpu_torch.core.gang import gang_hp_inputs, resolve_members

    if config.backend == "distributed":
        raise ConfigError(
            "gang-batched sweeps need the jitted backends; backend: "
            "distributed trains in per-node OS processes (run seeds as "
            "separate invocations there)"
        )
    if config.population is not None and config.population.enabled:
        # The CLI's --seeds reaches here with sweep unset, so the schema's
        # population x sweep check never saw this pair.
        raise ConfigError(refusal_reason("population", "sweep"))
    refuse_unported(config)
    if param_shards_of(config) > 1:
        # The CLI's --seeds reaches here with sweep unset.
        raise ConfigError("the PyTorch port does not run these config sections yet: "
                          + SHARDING_UNPORTED["sweep"])
    if members is None:
        try:
            members = resolve_members(config, seeds)
        except ValueError as e:
            raise ConfigError(str(e)) from None
    topology = build_topology(config)
    if isinstance(topology, SparseTopology) and config.backend == "tpu":
        raise ConfigError(refusal_reason("sparse", "sweep", "tpu_backend"))
    attack = build_attack(config)
    hp = gang_hp_inputs(members)
    programs, rule = [], None
    for member in members:
        scale = None
        if "attack_scale" in hp:
            scale = member.attack_scale if member.attack_scale is not None else 1.0
        program, rule = build_program(config, topology, attack, member.seed,
                                      torch.device(device), rule=rule, lr=member.lr,
                                      attack_scale=scale)
        programs.append(program)
    return members, topology, attack, programs


def build_gang_member_programs(config: Config, members, device="cuda"):
    """One generation's member programs (the serve daemon's admission path):
    each member's data, initial parameters and learning rate from its seed,
    exactly as :func:`build_gang_from_config` builds them, without a gang.
    They are value sources for a warm gang
    (``GangNetwork.reset_run(member_programs=...)``), so they must come from
    a config whose structural fingerprint is the gang's
    (serve/scheduler.py)."""
    if config.backend == "distributed":
        raise ConfigError(
            "gang-batched serving needs the jitted backends; backend: "
            "distributed trains in per-node OS processes"
        )
    return _gang_members_and_programs(config, device, members=list(members))[3]


def build_gang_from_config(config: Config, seeds=None, device="cuda", checkpoint_dir=None,
                           retain_init=False, min_batch=1):
    """Gang wiring (core/gang.py): the ``sweep`` and ``run --seeds`` path,
    each frontier cell's and grid bucket's gang, and each serve bucket's.

    As :func:`build_network_from_config`, except that the data, the initial
    parameters and the draws come from each member's seed, and a member's
    ``lr`` and ``attack_scale`` overrides reach its training and attack.
    The attack's placement (seeded by ``attack.params.seed``, else the base
    experiment seed), the topology, the mobility model, the model and rule
    and the fault schedule are the gang's; under DMTT each member's program
    carries its own trust state.  ``seeds``: an explicit member seed list (the
    CLI's ``--seeds``), else ``config.sweep`` defines the members.
    ``checkpoint_dir``: as there, for each member's telemetry stream.
    ``retain_init``: keep host copies of the round-0 state, which
    ``GangNetwork.reset_run`` (the frontier's stage reset) restores.
    ``min_batch``: the lane count the gang reports and admits up to (the
    serve daemon's capacity)."""
    from murmura_tpu_torch.core.gang import GangNetwork

    members, topology, attack, programs = _gang_members_and_programs(config, device, seeds)
    writers = None
    if config.telemetry.enabled:
        # One run dir a member, <run dir>/<member label>, each of which
        # ``report`` reads as a single run's.
        resume = checkpoint_dir is not None and has_checkpoint(checkpoint_dir)
        base_dir = default_telemetry_dir(config)
        writers = []
        for member in members:
            mcfg = config.model_copy(deep=True)
            mcfg.experiment.seed = member.seed
            mcfg.telemetry.dir = os.path.join(base_dir, member.label)
            writers.append(build_telemetry_writer(mcfg, resume=resume))
    bucket = config.sweep.bucket if config.sweep is not None else True
    try:
        return GangNetwork(programs, members, topology, attack=attack,
                           fault_schedule=build_fault_schedule(config),
                           base_lr=config.training.lr,
                           transfer_guard=config.tpu.transfer_guard,
                           recompile_guard=config.tpu.recompile_guard,
                           telemetry_writers=writers, retain_init=retain_init,
                           min_batch=min_batch, bucket=bucket,
                           mobility=build_mobility(config))
    except ValueError as e:
        # Members that cannot train as one stack (ragged shards).
        raise ConfigError(str(e)) from None
