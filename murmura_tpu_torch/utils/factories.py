"""Config -> object wiring (the PyTorch counterpart of the plain path of
murmura_tpu/utils/factories.py).

``build_network_from_config`` builds data, model, topology, the attack
(with its label poison), the aggregation rule, the fault schedule and
spec, the compression and staleness specs, the telemetry writer and the
round program (pipelined under ``exchange.pipeline``), and refuses by name
every part of the configuration surface the port does not run yet — a
refused section is an error, never a silent fallback.
"""

import os
from typing import List, Optional

import numpy as np
import torch

from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.attacks import ATTACKS
from murmura_tpu_torch.attacks.base import Attack, select_compromised
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.core.stale import StalenessSpec
from murmura_tpu_torch.data.registry import build_federated_data
from murmura_tpu_torch.faults.schedule import FaultSchedule, FaultSpec
from murmura_tpu_torch.models.registry import build_model
from murmura_tpu_torch.ops.compress import CompressionSpec
from murmura_tpu_torch.ops.flatten import model_dimension
from murmura_tpu_torch.topology.generators import create_topology
from murmura_tpu_torch.utils.checkpoint import has_checkpoint


class ConfigError(ValueError):
    """The config validated but asks for something the port cannot run
    (an unported lever, an unsupported exchange mode, a data/model
    mismatch).  The CLI renders these as messages, not tracebacks."""


def unported_sections(config: Config) -> List[str]:
    """Every enabled part of the config the port does not run yet."""
    out = []
    if config.backend == "distributed":
        out.append("backend: distributed (the ZMQ multi-process backend)")
    if config.topology.type in ("exponential", "one_peer"):
        out.append(f"topology.type: {config.topology.type} (sparse topologies)")
    if config.mobility is not None:
        out.append("mobility")
    if config.dmtt is not None:
        out.append("dmtt")
    if config.population is not None and config.population.enabled:
        out.append("population (cohort streaming)")
    if config.sweep is not None:
        out.append("sweep (gang-batched seeds)")
    if config.frontier is not None:
        out.append("frontier (the robustness frontier search)")
    if config.grid is not None:
        out.append("grid (the multi-tenant grid)")
    if config.serve is not None:
        out.append("serve (the daemon)")
    if config.tpu.param_shards > 1:
        out.append("tpu.param_shards > 1 (param-axis sharding)")
    if config.tpu.multihost:
        out.append("tpu.multihost")
    a = config.attack
    if a.enabled and a.type is not None and a.type not in ATTACKS:
        out.append(f"attack.type: {a.type}")
    if a.adaptive.enabled:
        out.append("attack.adaptive (closed-loop attacks)")
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


def build_staleness_spec(config: Config, topology) -> Optional[StalenessSpec]:
    """StalenessSpec from config.exchange, or None when off.  The base mask
    is the topology's static [N, N] mask, the unfaulted graph re-added
    stale edges are drawn from (the sparse topologies are not ported)."""
    e = config.exchange
    if e.max_staleness <= 0:
        return None
    return StalenessSpec(
        max_staleness=e.max_staleness,
        discount=e.staleness_discount,
        base_mask=np.asarray(topology.mask(), dtype=np.float32),
    )


def default_telemetry_dir(config: Config) -> str:
    """The run directory of a telemetry-enabled config when
    ``telemetry.dir`` is unset: ``murmura_runs/<experiment name>``."""
    return config.telemetry.dir or os.path.join("murmura_runs", config.experiment.name)


def build_telemetry_writer(config: Config, resume: bool = False):
    """TelemetryWriter from config.telemetry, or None when off.  ``resume``:
    the run continues from its snapshot, so the writer appends to the run
    dir's stream instead of rotating it."""
    t = config.telemetry
    if not t.enabled:
        return None
    from murmura_tpu_torch.telemetry.writer import TelemetryWriter

    return TelemetryWriter(
        default_telemetry_dir(config),
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
    ``flip_fraction``)."""
    if not config.attack.enabled or not config.attack.type:
        return None
    n = config.topology.num_nodes
    pct = config.attack.percentage
    p = config.attack.params
    seed = int(p.get("seed", config.experiment.seed))
    kind = config.attack.type
    if kind == "gaussian":
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             noise_std=float(p.get("noise_std", p.get("std", 10.0))))
    if kind == "directed_deviation":
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             lambda_param=float(p.get("lambda_param", -5.0)))
    if kind == "alie":
        estimator = str(p.get("estimator", "omniscient"))
        if estimator not in ("omniscient", "coalition"):
            raise ConfigError(
                f"attack.params.estimator must be 'omniscient' or 'coalition', "
                f"got {estimator!r}"
            )
        if estimator == "coalition" and select_compromised_count(n, pct, seed) < 2:
            # With one colluder sigma is 0 and mu - z*sigma is its own benign
            # state: a run labelled ALIE that attacks nothing.
            raise ConfigError(
                "the ALIE coalition estimator needs at least 2 compromised nodes "
                "(mu/sigma over the coalition sample is degenerate with 1); raise "
                "attack.percentage, or use the omniscient estimator"
            )
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             z=p.get("z"), estimator=estimator)
    if kind == "ipm":
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             epsilon=p.get("epsilon"))
    if kind == "label_flip":
        ff = float(p.get("flip_fraction", 1.0))
        if not 0.0 < ff <= 1.0:
            raise ConfigError(f"attack.params.flip_fraction must be in (0, 1], got {ff}")
        return ATTACKS[kind](num_nodes=n, attack_percentage=pct, seed=seed,
                             flip_fraction=ff)
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
        if config.tpu.conv_impl != "direct" and "femnist" in factory_lc:
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


def build_network_from_config(config: Config, device="cuda", checkpoint_dir=None) -> Network:
    """Full wiring: data + model + aggregator + attack -> Network on ``device``.

    ``checkpoint_dir``: the snapshot directory this run will resume from,
    when given; the telemetry writer then appends to its stream exactly
    when a snapshot exists there (a resume with no snapshot yet is a fresh
    run).  The caller restores the snapshot (Network.restore_checkpoint)."""
    refused = unported_sections(config)
    if refused:
        raise ConfigError(
            "the PyTorch port does not run these config sections yet: "
            + "; ".join(refused)
        )
    device = torch.device(device)
    n = config.topology.num_nodes
    seed = config.experiment.seed

    try:
        data = build_federated_data(
            config.data.adapter,
            config.data.params,
            num_nodes=n,
            seed=seed,
            max_samples=config.training.max_samples,
        )
    except ValueError as e:
        raise ConfigError(str(e)) from None
    model = resolve_model(config, data)
    topology = create_topology(
        config.topology.type,
        num_nodes=n,
        p=config.topology.p,
        k=config.topology.k,
        seed=config.topology.seed,
    )
    attack = build_attack(config)
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

    # tpu.pallas_agg selects nothing here: on the card the distance kernels
    # are the implementation, with no alternative path to opt out to.
    agg_params = dict(config.aggregation.params)
    if config.backend == "tpu" and config.tpu.exchange == "ppermute":
        offsets = topology.circulant_offsets()
        if offsets is None:
            raise ConfigError(
                f"tpu.exchange: ppermute requires a circulant topology "
                f"(ring/k-regular); '{config.topology.type}' is not"
            )
        agg_params["exchange_offsets"] = offsets
    if config.aggregation.algorithm in ("krum", "median", "trimmed_mean", "geometric_median"):
        # Static graph: bound the per-node candidate block at max-degree + 1.
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
        # Only Sketchguard's tables need the model dimension up front.
        model_dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
    try:
        agg = build_aggregator(config.aggregation.algorithm, agg_params, model_dim=model_dim)
    except ValueError as e:
        raise ConfigError(str(e)) from None

    program = build_round_program(
        model,
        agg,
        data,
        local_epochs=config.training.local_epochs,
        batch_size=config.training.batch_size,
        lr=config.training.lr,
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
    )
    resume = checkpoint_dir is not None and has_checkpoint(checkpoint_dir)
    return Network(program, topology, attack=attack, seed=seed,
                   fault_schedule=build_fault_schedule(config),
                   telemetry=build_telemetry_writer(config, resume=resume),
                   profile_dir=config.tpu.profile_dir,
                   transfer_guard=config.tpu.transfer_guard,
                   recompile_guard=config.tpu.recompile_guard)
