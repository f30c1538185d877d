"""Command line:

    python -m murmura_tpu_torch run <yaml> [-o history.json]
        [--device cuda|cpu] [--verbose|--quiet] [--profile] [--seeds N]
        [--checkpoint-dir DIR] [--checkpoint-every N] [--resume|--no-resume]
        [--require-tpu] [--retries N]
    python -m murmura_tpu_torch sweep <yaml> [--seeds 1,2,3] [-o histories.json]
        [--device cuda|cpu] [--verbose|--quiet] and the durability flags
    python -m murmura_tpu_torch frontier <yaml> [-o frontier.json]
        [--device cuda|cpu] [--require-tpu]
    python -m murmura_tpu_torch grid <yaml> [-o grid.json] [--plan-only]
        [--device cuda|cpu] [--require-tpu]
    python -m murmura_tpu_torch serve <yaml> [--device cuda|cpu] [--require-tpu]
    python -m murmura_tpu_torch submit <yaml> --socket SOCK [--wait] [--poll-s S]
    python -m murmura_tpu_torch metrics <socket|run_dir>
    python -m murmura_tpu_torch top --socket SOCK [--interval S] [--iterations N]
    python -m murmura_tpu_torch runs [roots...] [--json]
    python -m murmura_tpu_torch report <run_dir> [--json] [--trace out.json]
    python -m murmura_tpu_torch report --latest [--json] [--trace out.json]
    python -m murmura_tpu_torch report --frontier <frontier.json> [--json]
    python -m murmura_tpu_torch report --grid <grid.json> [--json]
    python -m murmura_tpu_torch list-components [CATEGORY]
    python -m murmura_tpu_torch run-node <yaml> --node-id I --t-start T --run-id ID
        [--host HOST] [--resume|--no-resume] [--device cuda|cpu]

The run goes to the CUDA card by default.  Without CUDA it stops with an
error unless ``--device cpu`` asks for the CPU; it never drops to the CPU
on its own.  Prints the JAX package's results table and writes the same
history JSON schema; with ``telemetry.enabled`` it also writes a telemetry
run directory (manifest and event stream, schema v2), which ``report``
renders as plain text or JSON.  ``--profile`` turns telemetry on and
traces the configured round window (the whole run when none is set) with
torch.profiler, written as Chrome trace JSON under ``<run_dir>/trace``.

A config with ``tpu.param_shards`` > 1 (param-axis sharding) is laid out
as the JAX package lays its mesh, over the devices there are
(parallel/mesh.py ``plan_layout``; on the CPU ``tpu.num_devices``, else
``param_shards``): a param axis above 1 runs that many ranks of one
``torch.distributed`` group (parallel/launch.py), over gloo on the CPU and
over NCCL with rank r on ``cuda:r``; rank 0 prints and writes.  On one
card the layout is (1, 1, 1): one process, unsharded, on the padded flat
vector.  The layout is printed on a line of its own.

A config with ``backend: distributed`` runs the ZMQ multi-process backend
(distributed/runner.py): a monitor process and one process per node on this
machine, wall-clock rounds of ``distributed.round_duration_s`` after a
``startup_grace_s``, deadline-based partial aggregation, the same history
schema; each node on ``cuda:(node_id % device_count)``, or on the CPU with
``--device cpu``.  ``--checkpoint-dir``/``--resume`` and ``--profile`` are
refused with it, as in the JAX package.  ``run-node`` is its multi-machine
worker: one node of a run whose ``run_id`` and ``t_start`` the head's
``run`` printed.

``sweep`` runs the config's ``sweep:`` members (or the ``--seeds`` list)
as one gang (core/gang.py) and ``run --seeds N`` the seeds experiment.seed
.. +N-1 (1 is a single run): it prints the members' final round and writes
one history a member, keyed by member label; with telemetry one run dir a
member, ``<run_dir>/<member label>``.  ``--seeds`` below 1, and with
``--profile``, is refused.

``frontier`` runs the config's ``frontier:`` grid (frontier.py): each
(rule x adaptive attack x topology) cell as one gang of strength x seed
members with successive halving between stages, printing each cell's
progress, then writes the artifact (``-o``, the JAX package's default
``frontier.json`` in the working directory) and prints its table, which
``report --frontier`` renders again (``--json``: the grid and one summary
row a cell).

``grid`` runs the config's ``grid:`` block (serve/scheduler.py): its cells
partitioned into one bucket a structural class, each bucket one gang on the
fused path, then the manifest (``-o``, default ``grid.json`` in the working
directory) and its tables, which ``report --grid`` renders again;
``--plan-only`` prints the buckets and runs nothing.  ``serve`` runs the
multi-tenant daemon of the config's ``serve:`` block (serve/daemon.py) on
its socket (``serve.socket``, default ``<state_dir>/daemon.sock``) until a
``shutdown`` request; started again over the same state dir it resumes
what was running.  ``submit`` hands it one experiment (``--wait``: until
the submission ends).  ``metrics`` prints OpenMetrics text, scraped from a
daemon's socket or folded from a run directory; ``top`` the daemon's live
table; ``runs`` the index of every run dir and serve ledger under the
roots; ``report --latest`` the newest of those run dirs, and ``--trace``
writes a run's spans as Chrome trace JSON instead of tables.
``list-components`` prints what the port runs, a row a category (one
category when named), from its own registries.

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

import numpy as np
import torch

from murmura_tpu_torch.parallel.mesh import plan_layout, process_group
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


def _writers(network) -> list:
    """The telemetry writers of a Network (one or none) or a gang (one a
    member, or none)."""
    t = network.telemetry
    if t is None:
        return []
    return list(t) if isinstance(t, list) else [t]


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
        for t in _writers(network):
            t.emit("backend_degraded", reason=reason, retry=try_idx,
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
        retries: Optional[int] = None, num_seeds: Optional[int] = None):
    """Run an experiment from a config file; returns (history, network).
    ``profile`` turns telemetry on and, where no ``telemetry.profile_rounds``
    is set, traces the whole run.  The durability arguments are the flags
    of the module docstring (None: the config's ``durability:`` value).
    ``num_seeds`` above 1 runs the seeds experiment.seed .. +N-1 as a gang
    and returns (histories by member label, gang) instead."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.utils.factories import (
        build_network_from_config,
        default_telemetry_dir,
    )

    dev = resolve_device(device)
    config = load_config(config_path)
    if verbose is not None:
        config.experiment.verbose = verbose
    if num_seeds is not None and num_seeds < 1:
        raise UsageError(
            f"--seeds must be >= 1 (got {num_seeds}); 1 = normal run, "
            "N > 1 gang-batches N seeds"
        )
    if num_seeds is not None and num_seeds > 1:
        if profile:
            raise UsageError(
                "--seeds (gang-batched execution) does not combine with "
                "--profile; profile a single run instead"
            )
        base = config.experiment.seed
        return run_sweep(config, [base + i for i in range(num_seeds)], output, dev,
                         checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                         resume=resume, require_tpu=require_tpu, retries=retries)
    checkpoint_dir, checkpoint_every, resume, retries = resolve_durability(
        config, checkpoint_dir, checkpoint_every, resume, retries)
    enforce_require_tpu(config, dev, require_tpu)
    group = process_group()
    if group is None and config.backend == "tpu" and config.tpu.param_shards > 1:
        layout, n_dev = plan_layout(config.topology.num_nodes, config.tpu.param_shards,
                                    dev.type, config.tpu.num_devices)
        world = layout[2]
        how = (f"{world} ranks over {'nccl' if dev.type == 'cuda' else 'gloo'}" if world > 1
               else "one process, unsharded, on the padded flat vector")
        print(f"param layout (seed, nodes, param) {layout} over {n_dev} {dev.type} "
              f"device(s): {how}", flush=True)
        if world > 1:
            from murmura_tpu_torch.parallel.launch import launch

            args = (config_path, output, device, verbose, profile, checkpoint_dir,
                    checkpoint_every, resume, require_tpu, retries)
            return launch(_cli_rank, args, world=world, device_type=dev.type)[0], None
    if config.backend == "distributed":
        return run_distributed(config, output, dev, profile=profile,
                               checkpoint_dir=checkpoint_dir, resume=resume)
    if profile:
        config.telemetry.enabled = True
        if config.telemetry.profile_rounds == 0:
            config.telemetry.profile_rounds = config.experiment.rounds
    population = ""
    if config.population is not None and config.population.enabled:
        population = (f", population={config.population.virtual_size} virtual users "
                      f"/ {config.population.sampler} cohorts")
    print(
        f"murmura_tpu_torch experiment {config.experiment.name} "
        f"(backend={config.backend}, nodes={config.topology.num_nodes}, "
        f"rounds={config.experiment.rounds}{population}, device={dev})",
        flush=True,
    )
    network = build_network_from_config(
        config, device=dev, checkpoint_dir=checkpoint_dir if resume else None)
    if network.group is not None:
        print(network.group.describe(), flush=True)
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
    if group is not None and group.rank != 0:
        return history, network
    if output is not None:
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps(history, indent=2))
        print(f"History written to {output}")
    if config.telemetry.enabled:
        print(f"Telemetry run written to {default_telemetry_dir(config)} — render it "
              "with `python -m murmura_tpu_torch report <dir>`")
    return history, network


def run_distributed(config, output: Optional[Path], dev: torch.device, *, profile: bool,
                    checkpoint_dir, resume):
    """A ``backend: distributed`` run (distributed/runner.py); returns
    (history, None)."""
    from murmura_tpu_torch.distributed.runner import DistributedRunner

    if profile:
        raise UsageError(
            "--profile captures a device trace of the jitted round loop; backend: "
            "distributed trains in per-node worker processes (use the telemetry "
            "counters instead)"
        )
    if resume or checkpoint_dir is not None:
        raise UsageError(
            "--checkpoint-dir/--resume are not supported with backend: distributed "
            "(state lives in per-node processes)"
        )
    print(
        f"murmura_tpu_torch experiment {config.experiment.name} "
        f"(backend={config.backend}, nodes={config.topology.num_nodes}, "
        f"rounds={config.experiment.rounds}, device={dev})",
        flush=True,
    )
    history = DistributedRunner(config, device=dev.type).run()
    display_results(history)
    if output is not None:
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps(history, indent=2))
        print(f"History written to {output}")
    return history, None


def run_node(config_path: Path, node_id: int, t_start: float, run_id: str,
             host: Optional[str] = None, resume: bool = False, device: str = "cuda") -> None:
    """The multi-machine worker of the ZMQ backend (reference:
    cli.py:143-208): node ``node_id`` of the run ``run_id`` that a head's
    ``run`` started at monotonic ``t_start`` (valid on this machine's
    clock)."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.distributed.node_process import run_single_node

    config = load_config(config_path)
    run_single_node(config, node_id=node_id, t_start=t_start, run_id=run_id, host=host,
                    resume=resume, device=device)


def _cli_rank(config_path, output, device, verbose, profile, checkpoint_dir,
              checkpoint_every, resume, require_tpu, retries):
    """One rank of a sharded ``run`` (parallel/launch.py): the same run, in
    the rank's group; returns the history."""
    return run(config_path, output, device, verbose, profile, checkpoint_dir=checkpoint_dir,
               checkpoint_every=checkpoint_every, resume=resume, require_tpu=require_tpu,
               retries=retries)[0]


def display_sweep(gang, histories) -> None:
    """The members' final recorded round, and the spread of their accuracy."""
    print("Sweep results (final round)")
    print(f"{'Member':<24}  {'Mean acc':>9}  {'Std':>7}  {'Loss':>8}")
    for member, h in zip(gang.members, histories):
        if h["round"]:
            print(f"{member.label:<24}  {h['mean_accuracy'][-1]:>9.4f}  "
                  f"{h['std_accuracy'][-1]:>7.4f}  {h['mean_loss'][-1]:>8.4f}")
        else:
            print(f"{member.label:<24}  {'-':>9}  {'-':>7}  {'-':>8}")
    finals = [h["mean_accuracy"][-1] for h in histories if h["round"]]
    if finals:
        print(f"Across {len(finals)} member(s): mean accuracy {np.mean(finals):.4f} "
              f"± {np.std(finals):.4f}")


def run_sweep(config, seeds, output: Optional[Path], dev: torch.device, *,
              checkpoint_dir=None, checkpoint_every=None, resume=None, require_tpu=False,
              retries=None):
    """Run a gang (``sweep`` and ``run --seeds``): build it, resume it from
    its snapshot where asked, train it inside the retry envelope as a
    single run trains, print the members' final round and write their
    histories keyed by member label; returns (that dict, gang)."""
    from murmura_tpu_torch.utils.factories import build_gang_from_config, default_telemetry_dir

    checkpoint_dir, checkpoint_every, resume, retries = resolve_durability(
        config, checkpoint_dir, checkpoint_every, resume, retries)
    enforce_require_tpu(config, dev, require_tpu)
    gang = build_gang_from_config(config, seeds=seeds, device=dev,
                                  checkpoint_dir=checkpoint_dir if resume else None)
    print(
        f"murmura_tpu_torch sweep {config.experiment.name} "
        f"(backend={config.backend}, nodes={config.topology.num_nodes}, "
        f"rounds={config.experiment.rounds}, gang={gang.gang_size} member(s), device={dev})",
        flush=True,
    )
    try:
        if resume:
            if has_checkpoint(checkpoint_dir):
                done = gang.restore_checkpoint(str(checkpoint_dir))
                print(f"Resumed all {gang.gang_size} member(s) from round {done}", flush=True)
            else:
                print(f"No checkpoint in {checkpoint_dir}; starting from round 0", flush=True)
        histories = train_with_retries(
            gang,
            lambda: gang.train(
                rounds=max(0, config.experiment.rounds - gang.current_round),
                verbose=config.experiment.verbose,
                rounds_per_dispatch=config.tpu.rounds_per_dispatch,
                checkpoint_dir=str(checkpoint_dir) if checkpoint_dir else None,
                checkpoint_every=checkpoint_every,
            ),
            retries=retries, config=config, checkpoint_dir=checkpoint_dir,
        )
    finally:
        for t in _writers(gang):
            t.close()
    display_sweep(gang, histories)
    combined = {m.label: h for m, h in zip(gang.members, histories)}
    if output is not None:
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps(combined, indent=2))
        print(f"Per-member histories written to {output}")
    if config.telemetry.enabled:
        print(f"Per-member telemetry runs under {default_telemetry_dir(config)}/<member> — "
              "render one with `python -m murmura_tpu_torch report <dir>`")
    return combined, gang


def sweep(config_path: Path, seeds: Optional[List[int]] = None,
          output: Optional[Path] = None, device: str = "cuda",
          verbose: Optional[bool] = None, **durability):
    """Run a config's ``sweep:`` members, or the ``seeds`` list, as one gang;
    returns (histories by member label, gang).  ``durability``: the
    keyword arguments of :func:`run_sweep`."""
    from murmura_tpu_torch.config import load_config

    dev = resolve_device(device)
    config = load_config(config_path)
    if verbose is not None:
        config.experiment.verbose = verbose
    if seeds is None and config.sweep is None:
        raise UsageError("config has no sweep block; add one or pass --seeds 1,2,3")
    return run_sweep(config, seeds, output, dev, **durability)


def frontier(config_path: Path, output: Path = Path("frontier.json"), device: str = "cuda",
             require_tpu: bool = False) -> dict:
    """Run the config's frontier grid on ``device``, write the artifact to
    ``output`` and print its table; returns the artifact."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.frontier import run_frontier, write_frontier
    from murmura_tpu_torch.telemetry.report import render_frontier

    dev = resolve_device(device)
    config = load_config(config_path)
    enforce_require_tpu(config, dev, require_tpu)
    f = config.frontier
    grid = f"{f.rules} x {f.attacks} x {f.topologies}" if f is not None else "default grid"
    print(f"murmura_tpu_torch frontier {config.experiment.name} "
          f"(nodes={config.topology.num_nodes}, {grid}, device={dev})", flush=True)
    artifact = run_frontier(config, progress=lambda line: print(line, flush=True), device=dev)
    path = write_frontier(artifact, output)
    print(f"Frontier artifact written to {path}")
    render_frontier(artifact)
    return artifact


def report_frontier(path: Path, as_json: bool = False) -> None:
    """Render a frontier artifact, or print its grid and per-cell summary
    as one JSON object."""
    from murmura_tpu_torch.frontier import frontier_break_summary, load_frontier
    from murmura_tpu_torch.telemetry.report import render_frontier

    artifact = load_frontier(path)
    if as_json:
        print(json.dumps({"grid": artifact.get("grid"),
                          "summary": frontier_break_summary(artifact)}))
    else:
        render_frontier(artifact)


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


def grid(config_path: Path, output: Path = Path("grid.json"), device: str = "cuda",
         require_tpu: bool = False, plan_only: bool = False) -> Optional[dict]:
    """Run the config's grid on ``device`` (or, with ``plan_only``, print
    its bucket plan and run nothing), write the manifest to ``output`` and
    print its tables; returns the manifest."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.serve.scheduler import plan_grid, run_grid, write_grid
    from murmura_tpu_torch.telemetry.report import render_grid

    dev = resolve_device(device)
    config = load_config(config_path)
    enforce_require_tpu(config, dev, require_tpu)
    g = config.grid
    desc = f"{g.rules} x {g.attacks} x {g.topologies}" if g is not None else "default grid"
    print(f"murmura_tpu_torch grid {config.experiment.name} "
          f"(nodes={config.topology.num_nodes}, {desc}, device={dev})", flush=True)
    if plan_only:
        buckets = plan_grid(config)
        for b in buckets:
            print(f"  bucket {b.key} {b.rule} x {b.attack} x {b.topology}: {len(b.cells)} cells")
        print(f"{sum(len(b.cells) for b in buckets)} cells in {len(buckets)} buckets")
        return None
    artifact = run_grid(config, progress=lambda line: print(line, flush=True), device=dev)
    path = write_grid(artifact, output)
    print(f"Grid manifest written to {path} ({artifact['total_cells']} cells, "
          f"{artifact['total_compiles']} compiles)")
    render_grid(artifact)
    return artifact


def report_grid(path: Path, as_json: bool = False) -> None:
    """Render a grid manifest, or print its grid, buckets and totals as one
    JSON object."""
    from murmura_tpu_torch.serve.scheduler import load_grid
    from murmura_tpu_torch.telemetry.report import render_grid

    artifact = load_grid(path)
    if as_json:
        print(json.dumps({k: artifact.get(k) for k in ("grid", "buckets", "total_cells",
                                                       "total_compiles")}))
    else:
        render_grid(artifact)


def serve(config_path: Path, device: str = "cuda", require_tpu: bool = False) -> None:
    """Run the daemon of the config's ``serve:`` block until a shutdown."""
    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.serve.daemon import ServeDaemon
    from murmura_tpu_torch.utils.factories import ConfigError

    dev = resolve_device(device)
    config = load_config(config_path)
    enforce_require_tpu(config, dev, require_tpu)
    try:
        daemon = ServeDaemon(config, device=dev)
    except ValueError as e:  # no serve: section
        raise ConfigError(str(e)) from None
    print(f"murmura_tpu_torch serve: listening on {daemon.socket_path} "
          f"(state_dir={daemon.state_dir}, capacity={daemon.capacity}, device={dev})",
          flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        daemon.close()
    print("murmura_tpu_torch serve: stopped", flush=True)


def submit(config_path: Path, socket_path: Path, wait: bool = False,
           poll_s: float = 0.5) -> dict:
    """Submit one experiment to a running daemon; with ``wait`` poll its
    status until it ends and return its record (exit 1 unless ``done``)."""
    import time

    import yaml

    from murmura_tpu_torch.serve.protocol import send_request

    with open(config_path, encoding="utf-8") as fh:
        raw = yaml.safe_load(fh)
    resp = send_request(str(socket_path), {"op": "submit", "config": raw})
    if not resp.get("ok"):
        print(str(resp.get("error")), file=sys.stderr)
        raise SystemExit(1)
    print(f"submitted {resp['id']} (bucket {resp['bucket']})", flush=True)
    if not wait:
        return resp
    while True:
        sub = send_request(str(socket_path), {"op": "status", "id": resp["id"]}).get(
            "submission", {})
        if sub.get("state") in ("done", "failed", "evicted"):
            print(f"{resp['id']} {sub['state']} (final_accuracy={sub.get('final_accuracy')})",
                  flush=True)
            if sub["state"] != "done":
                raise SystemExit(1)
            return sub
        time.sleep(poll_s)


def metrics(target: Path) -> None:
    """Print OpenMetrics text: a live scrape of a daemon's socket, or the
    same registry folded from a run directory's manifest and stream."""
    import stat

    from murmura_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
        fold_run_events,
        render_openmetrics,
        scrape_socket,
    )

    if stat.S_ISSOCK(target.stat().st_mode):
        print(scrape_socket(str(target)))
        return
    if not target.is_dir():
        raise ValueError("metrics needs a daemon socket or a telemetry run directory")
    reg = MetricsRegistry()
    fold_run_events(reg, target)
    print(render_openmetrics(reg))


def runs(roots: List[Path], as_json: bool = False) -> None:
    """Print the index of every run dir and serve ledger under ``roots``
    (the working directory when none), newest first."""
    from murmura_tpu_torch.telemetry.registry import index_runs, render_rows

    rows = index_runs(roots or [Path(".")])
    if as_json:
        for row in rows:
            print(json.dumps(row))
    elif not rows:
        print("no telemetry runs found")
    else:
        print(render_rows(rows))


def component_rows() -> Dict[str, str]:
    """``list-components``' rows: the JAX package's categories, filled from
    the port's registries.  The backends row names what the port runs."""
    from murmura_tpu_torch.aggregation import AGGREGATORS
    from murmura_tpu_torch.attacks import ATTACKS
    from murmura_tpu_torch.topology.generators import TOPOLOGY_TYPES

    return {
        "topologies": ", ".join(TOPOLOGY_TYPES),
        "aggregators": ", ".join(sorted(AGGREGATORS)),
        "attacks": ", ".join(sorted(ATTACKS)),
        "backends": "simulation, tpu (the node axis on one CUDA card), distributed (one "
                    "ZMQ process a node on the card or the CPU)",
        "models": (
            "mlp, leaf.femnist[.tiny/.small/.baseline/.large/.xlarge], "
            "leaf.celeba, leaf.shakespeare, wearables.{uci_har,pamap2,ppg_dalia}"
        ),
        "datasets": (
            "synthetic, synthetic_sequences, leaf.{femnist,celeba,shakespeare}, "
            "wearables.{uci_har,pamap2,ppg_dalia}"
        ),
    }


def list_components(component_type: Optional[str] = None) -> None:
    """Print the component table, or one category's row."""
    rows = component_rows()
    if component_type is not None:
        if component_type not in rows:
            raise ValueError(f"Unknown component type: {component_type}\n"
                             f"Available: {', '.join(rows)}")
        rows = {component_type: rows[component_type]}
    width = max(len(k) for k in rows)
    print("murmura_tpu_torch components")
    for k, v in rows.items():
        print(f"{k:<{width}}  {v}")


def _report_command(args) -> None:
    if args.frontier_path is not None:
        report_frontier(args.frontier_path, args.as_json)
        return
    if args.grid_path is not None:
        report_grid(args.grid_path, args.as_json)
        return
    run_dir = args.run_dir
    if run_dir is None and args.latest:
        from murmura_tpu_torch.telemetry.registry import find_latest

        row = find_latest([Path(".")])
        if row is None:
            raise ValueError("--latest: no telemetry runs found under the current directory")
        run_dir = Path(row["path"])
        print(f"latest: {run_dir}", file=sys.stderr)
    if run_dir is None:
        raise ValueError("report needs a RUN_DIR (or --latest, --frontier <frontier.json>, "
                         "--grid <grid.json>)")
    if args.trace_path is not None:
        from murmura_tpu_torch.telemetry.spans import write_chrome_trace

        if not run_dir.is_dir():
            raise FileNotFoundError(f"{run_dir} is not a run directory")
        n = write_chrome_trace(args.trace_path, [run_dir])
        print(f"wrote {n} trace span(s) to {args.trace_path} (Chrome trace JSON: Perfetto, "
              "chrome://tracing)")
        return
    report(run_dir, args.as_json)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m murmura_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    # The flags run and sweep share: the device, verbosity and durability.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("config_path", type=Path)
    common.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default) or cpu; never chosen for you")
    common.add_argument("--verbose", dest="verbose", action="store_true", default=None)
    common.add_argument("--quiet", dest="verbose", action="store_false")
    common.add_argument("--checkpoint-dir", type=Path, default=None,
                        help="snapshot the whole run state here (default: "
                             "durability.checkpoint_dir)")
    common.add_argument("--checkpoint-every", type=int, default=None,
                        help="rounds between snapshots (default: durability.checkpoint_every)")
    common.add_argument("--resume", dest="resume", action="store_true", default=None,
                        help="resume from --checkpoint-dir if a snapshot exists (the "
                             "telemetry stream appends; default: durability.resume)")
    common.add_argument("--no-resume", dest="resume", action="store_false")
    common.add_argument("--require-tpu", action="store_true",
                        help="refuse any device but the CUDA card (env twin "
                             "MURMURA_REQUIRE_TPU=1, config twin durability.require_tpu)")
    common.add_argument("--retries", type=int, default=None,
                        help="retry training on transient errors, restoring the last "
                             "snapshot, with exponential backoff; needs --checkpoint-dir "
                             "(default: durability.retries)")
    p_run = sub.add_parser("run", parents=[common],
                           help="Run an experiment from a config file")
    p_run.add_argument("-o", "--output", type=Path, default=None,
                       help="Write history JSON here")
    p_run.add_argument("--profile", action="store_true",
                       help="turn telemetry on and trace the round window (the whole "
                            "run when telemetry.profile_rounds is 0) with torch.profiler")
    p_run.add_argument("--seeds", dest="num_seeds", type=int, default=None,
                       help="run the seeds experiment.seed .. +N-1 as one gang (the sweep "
                            "command with num_seeds: N); 1 is a single run")
    p_sweep = sub.add_parser("sweep", parents=[common],
                             help="Run a config's sweep members as one gang")
    p_sweep.add_argument("-o", "--output", type=Path, default=None,
                         help="write the member histories, keyed by member label, here")
    p_sweep.add_argument("--seeds", default=None,
                         help="comma-separated member seeds overriding the config's "
                              "sweep block (e.g. --seeds 1,2,3)")
    p_front = sub.add_parser("frontier", help="Run a config's robustness frontier grid")
    p_front.add_argument("config_path", type=Path)
    p_front.add_argument("-o", "--output", type=Path, default=Path("frontier.json"),
                         help="write the frontier artifact here (default: frontier.json)")
    p_front.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                         help="cuda (default) or cpu; never chosen for you")
    p_front.add_argument("--require-tpu", action="store_true",
                         help="refuse any device but the CUDA card")
    p_grid = sub.add_parser("grid", help="Run a config's rule x attack x topology x strength "
                                         "x seed grid, one gang a bucket")
    p_grid.add_argument("config_path", type=Path)
    p_grid.add_argument("-o", "--output", type=Path, default=Path("grid.json"),
                        help="write the grid manifest here (default: grid.json)")
    p_grid.add_argument("--plan-only", action="store_true",
                        help="print the bucket plan and run nothing")
    p_serve = sub.add_parser("serve", help="Run the multi-tenant daemon of a config's serve: "
                                           "block")
    p_serve.add_argument("config_path", type=Path)
    for p_dev in (p_grid, p_serve):
        p_dev.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                           help="cuda (default) or cpu; never chosen for you")
        p_dev.add_argument("--require-tpu", action="store_true",
                           help="refuse any device but the CUDA card")
    p_sub = sub.add_parser("submit", help="Submit one experiment to a running daemon")
    p_sub.add_argument("config_path", type=Path)
    p_sub.add_argument("--socket", dest="socket_path", type=Path, required=True,
                       help="the daemon's unix socket (serve.socket, <state_dir>/daemon.sock)")
    p_sub.add_argument("--wait", action="store_true",
                       help="wait until the submission ends and print its record")
    p_sub.add_argument("--poll-s", type=float, default=0.5, help="status poll interval")
    p_met = sub.add_parser("metrics", help="OpenMetrics text of a daemon socket or a run dir")
    p_met.add_argument("target", type=Path)
    p_top = sub.add_parser("top", help="A daemon's live table")
    p_top.add_argument("--socket", dest="socket_path", type=Path, required=True)
    p_top.add_argument("--interval", dest="interval_s", type=float, default=1.0)
    p_top.add_argument("--iterations", type=int, default=None,
                       help="stop after N refreshes (default: until interrupted)")
    p_runs = sub.add_parser("runs", help="Index every run dir and serve ledger under roots")
    p_runs.add_argument("roots", type=Path, nargs="*")
    p_runs.add_argument("--json", dest="as_json", action="store_true",
                        help="one JSON object a run")
    p_rep = sub.add_parser("report", help="Render a telemetry run directory, a frontier "
                                          "artifact or a grid manifest")
    p_rep.add_argument("run_dir", type=Path, nargs="?", default=None)
    p_rep.add_argument("--frontier", dest="frontier_path", type=Path, default=None,
                       help="render a frontier artifact (the frontier command's) instead")
    p_rep.add_argument("--grid", dest="grid_path", type=Path, default=None,
                       help="render a grid manifest (the grid command's) instead")
    p_rep.add_argument("--latest", action="store_true",
                       help="report the newest run dir under the working directory")
    p_rep.add_argument("--trace", dest="trace_path", type=Path, default=None,
                       help="write the run's spans as Chrome trace JSON here instead")
    p_rep.add_argument("--json", dest="as_json", action="store_true",
                       help="print the report as one JSON object")
    p_node = sub.add_parser("run-node", help="Multi-machine ZMQ worker: one node of a "
                                             "backend: distributed run")
    p_node.add_argument("config_path", type=Path)
    p_node.add_argument("--node-id", type=int, required=True, help="this worker's node id")
    p_node.add_argument("--t-start", type=float, required=True,
                        help="the shared round-0 start time the head printed")
    p_node.add_argument("--run-id", type=str, required=True, help="the run id the head printed")
    p_node.add_argument("--host", type=str, default=None, help="this node's bind host")
    p_node.add_argument("--resume", dest="resume", action="store_true", default=False,
                        help="rejoin a running experiment from this node's last per-node "
                             "checkpoint (faults.enabled crash recovery)")
    p_node.add_argument("--no-resume", dest="resume", action="store_false")
    p_node.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default, cuda:(node_id %% device_count)) or cpu; never "
                             "chosen for you")
    p_list = sub.add_parser("list-components", help="List the components the port runs")
    p_list.add_argument("component_type", nargs="?", default=None,
                        help="one category (topologies, aggregators, attacks, backends, "
                             "models, datasets)")
    args = parser.parse_args(argv)

    if args.command in ("report", "metrics", "runs", "top", "submit", "list-components"):
        try:
            if args.command == "list-components":
                list_components(args.component_type)
            elif args.command == "report":
                _report_command(args)
            elif args.command == "metrics":
                metrics(args.target)
            elif args.command == "runs":
                runs(args.roots, args.as_json)
            elif args.command == "submit":
                submit(args.config_path, args.socket_path, args.wait, args.poll_s)
            else:
                from murmura_tpu_torch.telemetry.top import run_top

                try:
                    run_top(str(args.socket_path), interval_s=args.interval_s,
                            iterations=args.iterations)
                except KeyboardInterrupt:
                    pass
        except (OSError, ValueError, RuntimeError) as e:
            print(str(e), file=sys.stderr)
            raise SystemExit(1)
        return

    import pydantic

    from murmura_tpu_torch.durability.dispatch import BackendRequirementError
    from murmura_tpu_torch.utils.factories import ConfigError

    try:
        if args.command == "frontier":
            frontier(args.config_path, args.output, args.device, args.require_tpu)
            return
        if args.command == "grid":
            grid(args.config_path, args.output, args.device, args.require_tpu, args.plan_only)
            return
        if args.command == "serve":
            serve(args.config_path, args.device, args.require_tpu)
            return
        if args.command == "run-node":
            run_node(args.config_path, args.node_id, args.t_start, args.run_id, args.host,
                     args.resume, args.device)
            return
        durability = dict(checkpoint_dir=args.checkpoint_dir,
                          checkpoint_every=args.checkpoint_every, resume=args.resume,
                          require_tpu=args.require_tpu, retries=args.retries)
        if args.command == "sweep":
            seeds = None
            if args.seeds is not None:
                try:
                    seeds = [int(x) for x in args.seeds.split(",") if x.strip()]
                except ValueError:
                    raise UsageError(
                        f"--seeds must be comma-separated ints, got {args.seeds!r}") from None
                if not seeds:
                    raise UsageError("--seeds parsed to an empty list")
            sweep(args.config_path, seeds, args.output, args.device, args.verbose,
                  **durability)
        else:
            run(args.config_path, args.output, args.device, args.verbose, args.profile,
                num_seeds=args.num_seeds, **durability)
    except (pydantic.ValidationError, ConfigError) as e:
        print(f"Config error: {e}", file=sys.stderr)
        raise SystemExit(1)
    except (UsageError, BackendRequirementError) as e:
        print(f"Error: {e}", file=sys.stderr)
        raise SystemExit(2)
