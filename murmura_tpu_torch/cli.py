"""Command line:

    python -m murmura_tpu_torch run <yaml> [-o history.json]
        [--device cuda|cpu] [--verbose|--quiet] [--profile]
        [--checkpoint-dir DIR] [--checkpoint-every N] [--resume|--no-resume]
        [--require-tpu] [--retries N]
    python -m murmura_tpu_torch report <run_dir> [--json]

The run goes to the CUDA card by default.  Without CUDA it stops with an
error unless ``--device cpu`` asks for the CPU; it never drops to the CPU
on its own.  Prints the JAX package's results table and writes the same
history JSON schema; with ``telemetry.enabled`` it also writes a telemetry
run directory (manifest and event stream, schema v2), which ``report``
renders as plain text or JSON.  ``--profile`` turns telemetry on and
traces the configured round window (the whole run when none is set) with
torch.profiler, written as Chrome trace JSON under ``<run_dir>/trace``.

Durability (the JAX package's flags, over the config's ``durability:``
block; an explicit flag wins): ``--checkpoint-dir`` snapshots the whole run
state every ``--checkpoint-every`` rounds and at the end; ``--resume``
restores the snapshot there and trains the remaining rounds, so a run
killed at any point and started again ends with the history of a run that
never stopped; ``--retries`` restores the last snapshot and retries on a
transient failure, with exponential backoff, on the same device;
``--require-tpu`` (or ``durability.require_tpu``, or
``MURMURA_REQUIRE_TPU=1``) refuses any device but the CUDA card, which in
the port means it refuses ``--device cpu``.  Refused as in the JAX
package: a snapshot already in the directory without ``--resume``,
``--resume`` or ``--retries`` without a directory, and a transient failure
before the first snapshot landed.
"""

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from murmura_tpu_torch.utils.checkpoint import has_checkpoint


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


class UsageError(ValueError):
    """A combination of flags and config the run refuses (exit code 2)."""


def resolve_durability(config, checkpoint_dir=None, checkpoint_every=None, resume=None,
                       retries=None):
    """Merge the durability flags over the config's ``durability:`` block
    (None means not given); returns (checkpoint_dir, checkpoint_every,
    resume, retries)."""
    d = config.durability
    if checkpoint_dir is None and d.checkpoint_dir is not None:
        checkpoint_dir = Path(d.checkpoint_dir)
    if checkpoint_every is None:
        checkpoint_every = d.checkpoint_every
    if resume is None:
        resume = d.resume
    if retries is None:
        retries = d.retries
    if resume and checkpoint_dir is None:
        raise UsageError("--resume requires --checkpoint-dir")
    if retries and checkpoint_dir is None:
        raise UsageError(
            "--retries requires --checkpoint-dir: a transient-failure retry restores "
            "from the last snapshot before re-dispatching"
        )
    if checkpoint_dir is not None and not resume and has_checkpoint(checkpoint_dir):
        # A fresh run would overwrite the snapshot, and a retry before its
        # own first snapshot would restore the old run's.
        raise UsageError(
            f"{checkpoint_dir} already holds a snapshot; pass --resume to continue "
            "that run, or point --checkpoint-dir at a clean directory"
        )
    return checkpoint_dir, checkpoint_every, resume, retries


def enforce_require_tpu(config, device: torch.device, require_tpu_flag: bool) -> None:
    """The --require-tpu / durability.require_tpu / MURMURA_REQUIRE_TPU=1
    hard-fail: the run's device must be the CUDA card."""
    from murmura_tpu_torch.durability.dispatch import require_tpu, tpu_required

    if require_tpu_flag or tpu_required(config):
        require_tpu(device, source="--require-tpu" if require_tpu_flag
                    else "durability.require_tpu/MURMURA_REQUIRE_TPU")


def train_with_retries(network, train, *, retries, config, checkpoint_dir):
    """Call ``train()``; with ``retries``, a classified-transient failure
    restores the network from its last snapshot and trains again (``train``
    computes the remaining rounds from the restored counter).  A retry with
    no snapshot to restore refuses: the failed attempt may have advanced
    the parameters."""

    def attempt(try_idx: int):
        if try_idx > 0:
            if not has_checkpoint(checkpoint_dir):
                raise RuntimeError(
                    f"transient failure before the first snapshot landed in "
                    f"{checkpoint_dir} — nothing to restore, so a retry could replay "
                    "advanced state; rerun from scratch (lower "
                    "durability.checkpoint_every to shrink this window)"
                )
            done = network.restore_checkpoint(str(checkpoint_dir))
            print(f"Retry {try_idx}: restored round {done}", flush=True)
        return train()

    if not retries:
        return attempt(0)
    from murmura_tpu_torch.durability.dispatch import RetryPolicy, run_with_retry

    def on_retry(exc, try_idx, delay):
        reason = f"{type(exc).__name__}: {exc}"[:300]
        print(f"Transient failure ({reason}); retry {try_idx}/{retries} in {delay:.1f}s",
              flush=True)
        if network.telemetry is not None:
            network.telemetry.emit("backend_degraded", reason=reason, retry=try_idx,
                                   delay_s=round(delay, 2), round=network.current_round)

    return run_with_retry(
        attempt,
        policy=RetryPolicy(max_retries=retries,
                           base_delay_s=config.durability.retry_base_delay_s,
                           max_delay_s=config.durability.retry_max_delay_s),
        on_retry=on_retry,
    )


def run(config_path: Path, output: Optional[Path] = None, device: str = "cuda",
        verbose: Optional[bool] = None, profile: bool = False, *,
        checkpoint_dir: Optional[Path] = None, checkpoint_every: Optional[int] = None,
        resume: Optional[bool] = None, require_tpu: bool = False,
        retries: Optional[int] = None):
    """Run an experiment from a config file; returns (history, network).
    ``profile`` turns telemetry on and, where no ``telemetry.profile_rounds``
    is set, traces the whole run.  The durability arguments are the flags
    of the module docstring (None: the config's ``durability:`` value)."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.utils.factories import (
        build_network_from_config,
        default_telemetry_dir,
    )

    dev = resolve_device(device)
    config = load_config(config_path)
    if verbose is not None:
        config.experiment.verbose = verbose
    checkpoint_dir, checkpoint_every, resume, retries = resolve_durability(
        config, checkpoint_dir, checkpoint_every, resume, retries)
    enforce_require_tpu(config, dev, require_tpu)
    if profile:
        config.telemetry.enabled = True
        if config.telemetry.profile_rounds == 0:
            config.telemetry.profile_rounds = config.experiment.rounds
    print(
        f"murmura_tpu_torch experiment {config.experiment.name} "
        f"(backend={config.backend}, nodes={config.topology.num_nodes}, "
        f"rounds={config.experiment.rounds}, device={dev})",
        flush=True,
    )
    network = build_network_from_config(
        config, device=dev, checkpoint_dir=checkpoint_dir if resume else None)
    try:
        if resume:
            if has_checkpoint(checkpoint_dir):
                done = network.restore_checkpoint(str(checkpoint_dir))
                print(f"Resumed from round {done}", flush=True)
            else:
                print(f"No checkpoint in {checkpoint_dir}; starting from round 0", flush=True)
        history = train_with_retries(
            network,
            lambda: network.train(
                rounds=max(0, config.experiment.rounds - network.current_round),
                verbose=config.experiment.verbose,
                rounds_per_dispatch=config.tpu.rounds_per_dispatch,
                checkpoint_dir=str(checkpoint_dir) if checkpoint_dir else None,
                checkpoint_every=checkpoint_every,
            ),
            retries=retries, config=config, checkpoint_dir=checkpoint_dir,
        )
    finally:
        if network.telemetry is not None:
            network.telemetry.close()
    display_results(history)
    if output is not None:
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps(history, indent=2))
        print(f"History written to {output}")
    if config.telemetry.enabled:
        print(f"Telemetry run written to {default_telemetry_dir(config)} — render it "
              "with `python -m murmura_tpu_torch report <dir>`")
    return history, network


def report(run_dir: Path, as_json: bool = False) -> None:
    """Render a telemetry run directory (either package's) as plain text,
    or print its report dict as JSON (without the manifest, which the run
    directory holds)."""
    from murmura_tpu_torch.telemetry.report import build_report, render_report

    if as_json:
        rep = build_report(run_dir)
        rep.pop("manifest", None)
        print(json.dumps(rep))
    else:
        render_report(run_dir)


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
    p_run.add_argument("--profile", action="store_true",
                       help="turn telemetry on and trace the round window (the whole "
                            "run when telemetry.profile_rounds is 0) with torch.profiler")
    p_run.add_argument("--checkpoint-dir", type=Path, default=None,
                       help="snapshot the whole run state here (default: "
                            "durability.checkpoint_dir)")
    p_run.add_argument("--checkpoint-every", type=int, default=None,
                       help="rounds between snapshots (default: durability.checkpoint_every)")
    p_run.add_argument("--resume", dest="resume", action="store_true", default=None,
                       help="resume from --checkpoint-dir if a snapshot exists (the "
                            "telemetry stream appends; default: durability.resume)")
    p_run.add_argument("--no-resume", dest="resume", action="store_false")
    p_run.add_argument("--require-tpu", action="store_true",
                       help="refuse any device but the CUDA card (env twin "
                            "MURMURA_REQUIRE_TPU=1, config twin durability.require_tpu)")
    p_run.add_argument("--retries", type=int, default=None,
                       help="retry training on transient errors, restoring the last "
                            "snapshot, with exponential backoff; needs --checkpoint-dir "
                            "(default: durability.retries)")
    p_rep = sub.add_parser("report", help="Render a telemetry run directory")
    p_rep.add_argument("run_dir", type=Path)
    p_rep.add_argument("--json", dest="as_json", action="store_true",
                       help="print the report as one JSON object")
    args = parser.parse_args(argv)

    if args.command == "report":
        try:
            report(args.run_dir, args.as_json)
        except FileNotFoundError as e:
            print(str(e), file=sys.stderr)
            raise SystemExit(1)
        return

    import pydantic

    from murmura_tpu_torch.durability.dispatch import BackendRequirementError
    from murmura_tpu_torch.utils.factories import ConfigError

    try:
        run(args.config_path, args.output, args.device, args.verbose, args.profile,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            resume=args.resume, require_tpu=args.require_tpu, retries=args.retries)
    except (pydantic.ValidationError, ConfigError) as e:
        print(f"Config error: {e}", file=sys.stderr)
        raise SystemExit(1)
    except (UsageError, BackendRequirementError) as e:
        print(f"Error: {e}", file=sys.stderr)
        raise SystemExit(2)
