"""Config -> object wiring (the PyTorch counterpart of the plain path of
murmura_tpu/utils/factories.py).

``build_network_from_config`` builds data, model, topology, the gaussian
attack, Krum and the round program, and refuses by name every part of the
configuration surface the port does not run yet — a refused section is an
error, never a silent fallback.
"""

from typing import List, Optional

import torch

from murmura_tpu_torch.aggregation import build_aggregator
from murmura_tpu_torch.attacks import ATTACKS
from murmura_tpu_torch.attacks.base import Attack
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.network import Network
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.data.registry import build_federated_data
from murmura_tpu_torch.models.registry import build_model
from murmura_tpu_torch.topology.generators import create_topology


class ConfigError(ValueError):
    """The config validated but asks for something the port cannot run
    (an unported lever, an unsupported exchange mode, a data/model
    mismatch).  The CLI renders these as messages, not tracebacks."""


def unported_sections(config: Config) -> List[str]:
    """Every enabled part of the config the port does not run yet."""
    out = []
    if config.backend == "distributed":
        out.append("backend: distributed (the ZMQ multi-process backend)")
    if config.faults.enabled:
        out.append("faults (the operational fault model)")
    if config.compression.algorithm != "none":
        out.append(f"compression.algorithm: {config.compression.algorithm}")
    if config.exchange.max_staleness > 0:
        out.append("exchange.max_staleness (bounded-staleness gossip)")
    if config.exchange.pipeline:
        out.append("exchange.pipeline (pipelined rounds)")
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
    d = config.durability
    if d.checkpoint_dir is not None or d.resume or d.retries or d.require_tpu:
        out.append("durability (checkpoint/resume/retries/require_tpu)")
    if config.telemetry.enabled:
        out.append("telemetry")
    if config.tpu.rounds_per_dispatch > 1:
        out.append("tpu.rounds_per_dispatch > 1 (fused multi-round dispatch)")
    if config.tpu.param_shards > 1:
        out.append("tpu.param_shards > 1 (param-axis sharding)")
    if config.tpu.multihost:
        out.append("tpu.multihost")
    if config.tpu.profile_dir is not None:
        out.append("tpu.profile_dir (the JAX profiler trace)")
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


def build_attack(config: Config) -> Optional[Attack]:
    """The gaussian attack; its seed is attack.params.seed, else the
    experiment seed."""
    if not config.attack.enabled or not config.attack.type:
        return None
    p = config.attack.params
    seed = int(p.get("seed", config.experiment.seed))
    return ATTACKS[config.attack.type](
        num_nodes=config.topology.num_nodes,
        attack_percentage=config.attack.percentage,
        noise_std=float(p.get("noise_std", p.get("std", 10.0))),
        seed=seed,
    )


def resolve_model(config: Config, data):
    """Build the model with the data/model shape check."""
    import numpy as np

    model_params = dict(config.model.params)
    if config.backend == "tpu":
        model_params.setdefault("compute_dtype", config.tpu.compute_dtype)
        if config.tpu.conv_impl != "direct":
            model_params.setdefault("conv_impl", config.tpu.conv_impl)
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


def build_network_from_config(config: Config, device="cuda") -> Network:
    """Full wiring: data + model + aggregator + attack -> Network on ``device``."""
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
    if config.aggregation.algorithm == "krum":
        # Static graph: bound the per-node candidate block at max-degree + 1.
        agg_params.setdefault(
            "max_candidates", int(topology.mask().sum(axis=1).max()) + 1
        )
    try:
        agg = build_aggregator(config.aggregation.algorithm, agg_params)
    except ValueError as e:
        raise ConfigError(str(e)) from None

    program = build_round_program(
        model,
        agg,
        data,
        local_epochs=config.training.local_epochs,
        batch_size=config.training.batch_size,
        lr=config.training.lr,
        attack=attack,
        seed=seed,
        param_dtype=resolved_param_dtype(config),
        device=device,
    )
    return Network(program, topology, attack=attack, seed=seed)
