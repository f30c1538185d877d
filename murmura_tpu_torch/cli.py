"""Command line: ``python -m murmura_tpu_torch run <yaml> [-o history.json]
[--device cuda|cpu] [--verbose|--quiet]``.

The run goes to the CUDA card by default.  Without CUDA it stops with an
error unless ``--device cpu`` asks for the CPU; it never drops to the CPU
on its own.  Prints the JAX package's results table and writes the same
history JSON schema.
"""

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch


def resolve_device(name: str) -> torch.device:
    """The run's device; ``cuda`` without a usable card is an error."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: murmura_tpu_torch runs on the card by "
                "default; pass --device cpu to run on the CPU"
            )
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (cuda or cpu)")


def display_results(history: Dict[str, List]) -> None:
    """Results table: first, middle and last recorded rounds."""
    if not history.get("round"):
        print("No evaluation rounds recorded")
        return
    print("Training results")
    print(f"{'Round':>6}  {'Mean acc':>9}  {'Std':>7}  {'Loss':>8}")
    n = len(history["round"])
    for i in sorted({0, n // 2, n - 1}):
        print(
            f"{history['round'][i]:>6}  {history['mean_accuracy'][i]:>9.4f}  "
            f"{history['std_accuracy'][i]:>7.4f}  {history['mean_loss'][i]:>8.4f}"
        )
    print(f"Final mean accuracy: {history['mean_accuracy'][-1]:.4f}")


def run(config_path: Path, output: Optional[Path] = None, device: str = "cuda",
        verbose: Optional[bool] = None):
    """Run an experiment from a config file; returns (history, network)."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.utils.factories import build_network_from_config

    dev = resolve_device(device)
    config = load_config(config_path)
    if verbose is not None:
        config.experiment.verbose = verbose
    print(
        f"murmura_tpu_torch experiment {config.experiment.name} "
        f"(backend={config.backend}, nodes={config.topology.num_nodes}, "
        f"rounds={config.experiment.rounds}, device={dev})",
        flush=True,
    )
    network = build_network_from_config(config, device=dev)
    history = network.train(
        rounds=config.experiment.rounds, verbose=config.experiment.verbose,
        rounds_per_dispatch=config.tpu.rounds_per_dispatch,
    )
    display_results(history)
    if output is not None:
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps(history, indent=2))
        print(f"History written to {output}")
    return history, network


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m murmura_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="Run an experiment from a config file")
    p_run.add_argument("config_path", type=Path)
    p_run.add_argument("-o", "--output", type=Path, default=None,
                       help="Write history JSON here")
    p_run.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="cuda (default) or cpu; never chosen for you")
    p_run.add_argument("--verbose", dest="verbose", action="store_true", default=None)
    p_run.add_argument("--quiet", dest="verbose", action="store_false")
    args = parser.parse_args(argv)

    import pydantic

    from murmura_tpu_torch.utils.factories import ConfigError

    try:
        run(args.config_path, args.output, args.device, args.verbose)
    except (pydantic.ValidationError, ConfigError) as e:
        print(f"Config error: {e}", file=sys.stderr)
        raise SystemExit(1)
