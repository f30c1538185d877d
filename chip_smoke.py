#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (murmura_tpu_torch) on one card.

    python3 chip_smoke.py     # every phase, on one CUDA card

Phases, each of which raises (and exits non-zero) on failure:

1. card: name and power limit (``nvidia-smi``);
2. build: every kernel from ``murmura_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, timed;
3. kernels against their plain PyTorch versions at the flagship's shapes
   ([16, 6,603,710], the inputs the main path hands each kernel), each
   timed with CUDA events beside its plain version, a one-call PyTorch
   yardstick where one exists, and its memory/compute bound: Krum's two
   distance passes (the pairwise pass with the center row it subtracts as
   it loads; each distance case also with its device time from
   torch.profiler and bit-equal on a repeat call), fused candidate
   selection (median and trimmed mean, float32 and bfloat16, bit-equal),
   the count sketch (twice, bit-equal to itself, with its device time
   split between its walk and its sum pass) and the pairwise pass on
   the [16, 1000] sketches Sketchguard filters on; plus Krum's selection on
   the same inputs through the kernels and through the plain versions;
   then the two distance passes once more at N = 64 ([64, 1,048,576],
   k-regular(4) offsets), which a flagship round does not make, so that
   the multi-tile paths are timed; candidate selection at [64, 6,603,710]
   bfloat16 (the 64-node flagship's parameter dtype), median and trim 1;
   and the circulant pass at N = 2,500 (two tensors) and N = 5,000 (one
   tensor), past the rows shared memory holds, and at N = 1,000 (two
   tensors, P = 262,144), where one launch would take 2-column tiles: the
   wrapper splits each into launches of at most 138 rows; and N = 400 (one
   tensor, P = 262,144), one launch of 16-column tiles (the last two also
   timed the other way); and the wearable-MLP runs' calls at [10, 178,310]:
   the two pairwise calls and the candidate select's generic path (m = 10,
   trim 3); then the compressed exchange's codec (plain tensor code, no
   kernel row) on the card against the CPU at [16, 6,603,710] float32 and
   bfloat16: int8 ``q`` and ``scale``, and top-k's decoded tensor,
   residual and reference with ties planted at the k-th magnitude, all
   bit-equal, each timed; and the circulant pass at the exponential
   graph's offsets on the sparse runs' shapes, [256, 2,890] (k = 8, and
   Krum's pass at the offsets' differences) and [64, P] of the tiny CNN
   (k = 6); and Krum's four distance calls at the two newest models'
   widths, [16, 818,137] (the char-LSTM) and [16, 3,370,818] (the CelebA
   CNN), with the median's candidate select at the latter; every median
   case of the candidate select also timed against ``torch.median`` on
   the candidate stack gathered beforehand (and equal to it);
   and each of the four kernels on the 4 column blocks of the flagship's
   [16, P] inputs, P padded to 6,603,712 (``check_column_blocks``, the
   blocks a param group of 4 aggregates): the pairwise, circulant and
   count-sketch blocks summed against the full-width plain version within
   the kernel's limit (summed over the blocks), the candidate select's
   blocks bit-equal to the full-width call's columns, one block call of
   each timed;
3b. one round on the card against the same round on the CPU (same initial
   parameters, same injected draws), for each of two seeds, for Krum,
   median, trimmed mean, geometric median, BALANCE, Sketchguard, fedavg and
   UBAR (both exchanges) on the tiny CNN under the gaussian attack; the
   geometric median under ALIE (dense, and circulant with the coalition
   estimator), the circulant trimmed mean under IPM, BALANCE under directed
   deviation and the dense trimmed mean under label flip; and Krum and
   evidential trust (both exchanges) on the evidential wearable MLP with
   dropout 0.3 and injected masks; the dense geometric median's lines
   print the derived bound beside the measured delta; Krum under the fault
   model (a dead node, a node with no alive neighbour, a NaN-injected node,
   an attack row overflowing to inf: the fault stats exactly equal); Krum
   (both exchanges) and the median (ppermute) under int8 and Krum under
   top-k, error feedback on, each held to equal decisions and the derived
   ``codec_bound``, printed with the codes that differ; the faulted Krum
   row also with its audit taps (exactly equal); and Krum (both
   exchanges) under bounded staleness from a hand-made cache (a straggler
   whose cache is warm, one past the bound, a scrubbed sender with a warm
   cache, a dead receiver): the stale stats, taps and new ages exactly
   equal, the card's new cache bit-equal to the broadcast its rule took;
   and pipelined Krum (both exchanges): two chained rounds from one
   initial state with injected draws, so that the second aggregates a
   valid buffer: the picks equal every round, the parameters within a
   scaled 1e-4, ``agg_pipe_valid`` [0, 1]; and every rule under the sparse
   [k, N] edge mask of the exponential graph of 16 nodes (all edges but
   one, and one_peer's round 1), two seeds: decisions equal, parameters
   within a scaled 1e-4; and adaptive attacks (``check_adaptive_against_cpu``):
   the bisection around gaussian std 10 (40% compromised) under Krum
   (dense, circulant, the exponential graph) and BALANCE (dense), three
   chained rounds, two seeds: picks and the bracket (``atk_scale``,
   ``atk_lo``, ``atk_hi``) equal, the acceptance EMA within rtol 1e-6,
   parameters within a scaled 1e-4; adaptive ALIE on the dense geometric
   median (no taps): ``atk_z`` equal; and one dense Krum round
   (num_compromised 1) of the char-LSTM and of the CelebA CNN at full
   width, float32, card against CPU from one spread start on injected
   draws (``check_models_against_cpu``): picks equal, parameters within a
   scaled 1e-4 plus the trained rows' own delta, the LSTM's tokens int64
   on the card;
3c. one round of the tiny CNN at 64 nodes, k-regular(4), in the parameter
   dtype the configs take by default from 64 nodes up (bfloat16), for
   every ported rule (Krum, geometric median, BALANCE, UBAR and
   Sketchguard in both exchanges, median and trimmed mean under ppermute,
   fedavg; evidential trust in both exchanges on the evidential wearable
   MLP), and Krum and the median under int8 ppermute and Krum under
   chaos_churn.yaml's faults, the counters set to 0 just before and read
   just after: the
   launches each rule makes, no plain call, every kernel call held against
   its plain version on the round's own inputs, and the rule run again on
   the CPU on the round's (own, bcast, adj): equal decisions and outputs
   within the bfloat16 bound of PERF.md section 2; and once more Krum
   allgather from the nodes' own initialisations, where its scores tie,
   each device's pick held within the score noise of the exact best; and
   every rule once more on the exponential graph of 64 nodes (k = 6, the
   sparse exchange);
3e. the ZMQ backend's node runtime (``check_node_runtime_against_cpu``):
   node 0 of uci_har_byzantine.yaml as a ``LocalNode`` on the card and on
   the CPU from one start and one draw stream, then Krum and Sketchguard on
   its [10, 178,310] mini network with the same received states: their
   kernels launched (2 pairwise; 2 count sketches and 1 pairwise), no plain
   call, decisions equal (Krum tie-aware), parameters within a scaled 1e-4;
   and a DMTTNodeProcess of dmtt_mobility.yaml: its probe scores within
   rtol 1e-5, its claim verification and TopB collaborators equal;
4. main path: ``examples/configs/femnist_krum_tpu.yaml`` as committed
   (baseline CNN at full width, 16 nodes, k-regular(4), bf16 compute, 20%
   gaussian std 10), rounds cut to 3, through the port's ``run`` entry,
   once per (rule, exchange): Krum, geometric median and BALANCE under
   allgather and ppermute, median and trimmed mean under ppermute,
   Sketchguard under both, UBAR (rho 0.8) under ppermute; then
   ``basic_fedavg.yaml``, ``ubar_attack.yaml`` (UBAR, erdos graph),
   ``uci_har_byzantine.yaml`` (Krum on the wearable MLP),
   ``uci_har_dirichlet.yaml`` and ``pamap2_dirichlet.yaml`` (fedavg, the
   evidential round at full width), ``uci_har_evidential_trust.yaml``,
   ``alie_geometric_median.yaml`` and ``label_flip_poisoning.yaml``, each
   as committed, cut to 3 rounds; evidential trust and label flip again on
   backend: tpu under ppermute (the fully-connected graph is the circulant
   of offsets 1-9: the trimmed mean's m = 10 takes the candidate kernel's
   generic path); the flagship under ALIE with the geometric median in
   both exchanges; ``chaos_churn.yaml`` (5 rounds) and
   ``compressed_exchange.yaml``; the flagship's Krum under chaos_churn's
   faults: section (both exchanges), under int8 (both exchanges, and the
   median under ppermute) and under top-k; and the flagship's Krum over 6
   rounds per round and fused in chunks of 2 (tpu.rounds_per_dispatch),
   the histories within a scaled 1e-4, no synchronising call inside a
   chunk; then telemetry and bounded staleness: ``telemetry_audit_report.yaml``
   and ``stale_gossip.yaml`` (5 rounds each), the flagship under
   stale_gossip's ``faults:``, ``exchange:`` and ``telemetry:`` sections
   (both exchanges), under telemetry_audit_report's ``telemetry:`` section
   (4 rounds, its steady seconds printed beside the plain Krum run's), the
   flagship with a profiler window over rounds 2-3 of 4 (the first trace of
   a steady round: the card's busy share, its top device ops, the four
   kernels' share, the longest idle stretches), and the fused pair once
   more under stale_gossip's sections; then durability and pipelined
   rounds: ``resumable_run.yaml`` as committed (30 rounds, a snapshot every
   5) and ``pipelined_rounds.yaml`` as committed (12 rounds,
   ``tpu.recompile_guard`` on), the flagship under pipelined_rounds'
   ``exchange:`` and ``tpu:`` sections (both exchanges) and as the fused
   pair, the flagship fused under ``tpu.transfer_guard`` (no raise), and
   the flagship under resumable_run's ``durability:``, ``compression:`` and
   ``telemetry:`` sections (4 rounds, a snapshot every 2, both exchanges):
   once uninterrupted, then through ``python -m murmura_tpu_torch run`` in
   a subprocess SIGKILLed after its round-2 snapshot and run again, which
   resumes: the kernel launched twice a round for the rounds it ran,
   decisions equal, the history within a scaled 1e-4 of the uninterrupted
   run's (bit-equality printed), the telemetry stream appended with one
   ``run_resumed``, each snapshot's bytes and save or restore seconds
   printed; then the sparse exchange: the flagship's Krum on the
   exponential graph and on one_peer, and population_1m.yaml's scenario
   without its population: block (Krum, 256 nodes, k = 8, the 32-64-10
   MLP); then gangs (core/gang.py): ``sweep_seeds.yaml`` as committed (4
   members fused in chunks of 5, 10 rounds) and per round (the two held to
   a scaled 1e-4, bit-equality printed), the flagship as a gang of 4 seeds
   in both exchanges (``run --seeds 4``, ``training.max_samples`` 48: the
   seeds' LEAF shards differ in size), each gang's members also run one by
   one in the call (launches S times a single run's, each history within a
   scaled 1e-4 of its single run's, bit-equality printed, the gang's steady
   seconds a round beside the members' summed, the peak memory of both),
   and sweep_seeds.yaml under resumable_run.yaml's sections (10 rounds, a
   snapshot every 5) killed (SIGKILL) in a ``sweep`` subprocess after its
   first snapshot and resumed: every member's history bit-equal to the
   uninterrupted gang's; then cohort streaming and DMTT:
   ``population_1m.yaml`` as committed (50 rounds, a stratified cohort of
   256 of 1,000,000 users a round, the bank memory-mapped; its swap times
   and activated users printed) beside its scenario without the
   ``population:`` block (now 50 rounds too), Krum's circulant kernel
   twice a round in both; the same config over 3 rounds (3 swaps) on the
   card and on the CPU from one spread initial state on the CPU's draws
   (cohorts equal, Krum's picks equal or tie-aware, the bank within a
   scaled 1e-4); population_1m under a ``durability:`` section (20 rounds,
   a snapshot every 5, the bank embedded) run to the end and SIGKILLed after a
   snapshot in a ``run`` subprocess and resumed: history and final
   snapshot bit-equal; and ``dmtt_mobility.yaml`` as committed (30 rounds,
   no kernel; the DMTT cross-evaluation's share of a round printed) and
   over 3 rounds on the card and on the CPU (the cross-evaluation's
   accuracies, the TopB masks and the agg_dmtt_* counts equal or
   tie-aware, the trust state within rtol 1e-5, the parameters within a
   scaled 1e-4); then adaptive attacks: the flagship with
   ``attack.adaptive`` on (the bisection, 6 rounds, both exchanges; its
   ``agg_atk_*`` columns printed), ``alie_geometric_median.yaml`` with
   adaptive ALIE, and the flagship's trimmed mean under ppermute with
   adaptive IPM (the candidate select); and the frontier, through the
   port's ``frontier`` command with ``-o`` under SMOKE_DIR:
   ``frontier_krum.yaml`` as committed (20 cells, 2 stages of 4 strengths
   x 2 seeds, 6 rounds fused) and the flagship's scenario under a
   ``frontier:`` block (Krum and BALANCE x ALIE and gaussian x dense and
   sparse, gangs of 3 at [16, 6,603,710] float32, backend: simulation):
   the counters set to 0 around each cell, each cell's kernel launched
   twice (Krum) or once (BALANCE) a round a member in every stage, none
   for the other rules, no plain call, ``compiles`` 1 in every cell, the
   artifact with the JAX schema's keys, ``report --frontier`` rendering
   it; each cell's breaking point, the stages' seconds a round, the total
   seconds and the peak memory printed; then the grid, through the port's
   ``grid`` command: ``serve_grid.yaml`` as committed in a subprocess (50
   cells, 5 buckets of 10 in ``expand_cells`` order, gangs of 10 at
   [12, P] of the MLP, ``compiles`` 1 a bucket plus at most one ``nvcc``
   build a kernel, the pairwise kernel 2 S (Krum) and S (BALANCE) times a
   round, the manifest read back by ``report --grid``) and the flagship
   under a ``grid:`` block (ppermute, 12 cells, 3 buckets, gangs of 4 at
   [16, 6,603,710]: Krum's and BALANCE's circulant passes and the
   median's candidate select per bucket, the counters set to 0 around
   each bucket; its wall, seconds a gang round and peak printed); and the
   serve daemon: ``python -m murmura_tpu_torch serve`` subprocesses on
   serve_grid.yaml's base experiment (three tenants, capacity 2, a
   snapshot every round), one uninterrupted and one SIGKILLed after its
   first snapshot and started again over its state dir: every submission
   done, decisions equal the reference's, histories within a scaled 1e-4,
   the later generation recording no build, ``metrics``, ``top``, ``runs``
   and ``report --trace`` over the live daemon (``validate_spans`` on the
   trace), admission latency and recovery time printed; and one
   flagship-width daemon in this process (allgather, 2 tenants, 2
   rounds): its second generation builds nothing, and ``freeze_member``
   on one lane leaves the other's history equal to its run without the
   eviction; then the model surface (``run_model_surface``): the
   flagship's scenario with the LEAF Shakespeare char-LSTM on
   ``leaf.shakespeare`` (Krum, both exchanges) and the LEAF CelebA CNN on
   ``leaf.celeba`` (Krum allgather, the median under ppermute, and Krum
   under ``tpu.conv_impl: im2col``, its history's scaled delta and round
   times beside the direct run's), synthetic fallbacks, 64 samples a node,
   3 rounds; and ``dmtt_mobility.yaml`` (10 of its 30 rounds, max_samples 64)
   through ``run --seeds 3``, each member also run alone: histories within
   a scaled 1e-4, the trust state within rtol 1e-5, no kernel launched;
   then param-axis sharding (``run_sharded_smoke``):
   ``sharded_model.yaml`` as committed through ``python -m
   murmura_tpu_torch run`` (layout (1, 1, 1) on this card: one process on
   the padded flat vector, 20 rounds) against ``tpu.param_shards: 1`` in
   this process; the same config in a param group of 4 ranks on cuda:0
   (``parallel/launch.launch``, gloo staged through pinned host memory),
   5 rounds, its Krum rule checked each round in lockstep against the
   full-width rule on the same gathered inputs (``_lockstep_check``: the
   group's squared distances within 3x the full-width kernel's measured
   relative error, a pick that differs within the tie those errors allow,
   the rows bit-equal or the picked candidate's), and chained against the
   one-process run: the round-1 trained rows and the parameters after
   every round before the first round whose picks differ within a scaled
   1e-4 (the later rounds' distance printed), 2 pairwise launches a rank
   a round, no plain call, no JAX in a rank; and bench_scaling.py's
   acceptance cell (16 nodes, the MLP 1000-7200-6200-62, Krum, 2 rounds)
   in a group of 8 on cuda:0 against its one-process run, each rank's
   peak device memory printed beside the one-process peak and the
   analytic flat bytes.  Several ranks on one card check the collective
   code; their round times are no speed of sharding.  Then (4e,
   ``run_distributed_smoke``) uci_har_byzantine.yaml under ``backend:
   distributed`` (2 rounds) through ``python -m murmura_tpu_torch run``: the
   monitor and 10 node processes on this card; no node
   skips a round, every node on the card, 2 pairwise launches a node
   aggregate and no plain call, the card's picks against those of a CPU
   replay of the same protocol with the same draws (in this process) equal
   or within ``krum_tie_check``'s tie on the replay's inputs, per-node
   losses within rtol 1e-4; boot, train and aggregate seconds and the card
   memory printed.
   A faulted run holds its alive and
   quarantined counts to the schedule and every kernel input finite; a
   compressed run prints its payload bytes an edge; a telemetry run reads
   its run dir back with the port's report (the memory event's peak equal
   to the allocator's, the audit taps to the schedule) and prints its
   per-node audit and its stale stats.
   The counters are set to 0 before each run and read after it: every
   kernel of that run must launch every round, no other kernel and no
   plain version may run,
   the history must have the JAX package's keys for the rule and finite
   values (and the evidential columns for an evidential model, the
   agg_dmtt_* columns for a DMTT run); each run prints its peak device
   memory, and UBAR's, evidential trust's and DMTT's their probe forwards'
   share of the round;
5. output: the pipelined flagship's steady seconds a round beside the
   serialized one's, the gangs' beside their members' summed, the resumed
   runs' equality and snapshot costs, population_1m's steady seconds,
   peak memory and swap times beside its scenario's, dmtt_mobility's
   steady seconds and cross-evaluation share, the adaptive flagship's
   steady seconds beside the static run's, the frontiers' total seconds,
   stage seconds a round and peaks, the grids' and the daemons' times, the
   codec's times beside the flagship round's, the DMTT gang's and the
   model surface's summaries, one
   ``{"kernels": [...]}`` JSON line, the card line, and the
   ``{"ok": true, "device": ...}`` line last.

It imports nothing of JAX or of the JAX package.  Without CUDA, or run
from a directory that lacks the port, it exits non-zero and prints no
result.
"""

import argparse
import contextlib
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "examples" / "configs" / "femnist_krum_tpu.yaml"
BASIC_FEDAVG = ROOT / "examples" / "configs" / "basic_fedavg.yaml"
UBAR_ATTACK = ROOT / "examples" / "configs" / "ubar_attack.yaml"
UCI_HAR_BYZANTINE = ROOT / "examples" / "configs" / "uci_har_byzantine.yaml"
UCI_HAR_DIRICHLET = ROOT / "examples" / "configs" / "uci_har_dirichlet.yaml"
PAMAP2_DIRICHLET = ROOT / "examples" / "configs" / "pamap2_dirichlet.yaml"
UCI_HAR_EVIDENTIAL_TRUST = ROOT / "examples" / "configs" / "uci_har_evidential_trust.yaml"
ALIE_GEOMETRIC_MEDIAN = ROOT / "examples" / "configs" / "alie_geometric_median.yaml"
LABEL_FLIP_POISONING = ROOT / "examples" / "configs" / "label_flip_poisoning.yaml"
CHAOS_CHURN = ROOT / "examples" / "configs" / "chaos_churn.yaml"
COMPRESSED_EXCHANGE = ROOT / "examples" / "configs" / "compressed_exchange.yaml"
TELEMETRY_AUDIT_REPORT = ROOT / "examples" / "configs" / "telemetry_audit_report.yaml"
STALE_GOSSIP = ROOT / "examples" / "configs" / "stale_gossip.yaml"
RESUMABLE_RUN = ROOT / "examples" / "configs" / "resumable_run.yaml"
PIPELINED_ROUNDS = ROOT / "examples" / "configs" / "pipelined_rounds.yaml"
SWEEP_SEEDS = ROOT / "examples" / "configs" / "sweep_seeds.yaml"
FRONTIER_KRUM = ROOT / "examples" / "configs" / "frontier_krum.yaml"
POPULATION_1M = ROOT / "examples" / "configs" / "population_1m.yaml"
DMTT_MOBILITY = ROOT / "examples" / "configs" / "dmtt_mobility.yaml"
SMOKE_DIR = ROOT / "build" / "murmura_tpu_torch" / "smoke"
SMOKE_ROUNDS = 3
REPS = 20
PLAIN_REPS = 5

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 (non-tensor) and dense
# TF32 tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def card_line() -> str:
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        return out[0]
    import torch

    return f"{torch.cuda.get_device_name(0)}, power limit unknown (no nvidia-smi)"


def time_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    by CUDA events around the whole run of calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn, reps: int = REPS) -> dict:
    """Mean milliseconds per call of device time by kernel name (the name
    up to its argument list): the self time of every CUDA kernel that
    ``reps`` calls launch, from a torch.profiler trace, over ``reps``.
    Empty when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = float(ev.self_cuda_time_total if us is None else us)
        if us > 0:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0].strip()
            split[name] = split.get(name, 0.0) + us / 1e3 / reps
    return split


def bound(bytes_moved: float, flops: float, tf32_flops: float = 0.0):
    """Least time in ms: bytes over the memory rate, or float32 operations
    plus TF32 tensor-core operations over their peaks, the larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + tf32_flops / TF32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairwise_work(n, m, p, same):
    """(bytes, float32 ops, TF32 ops) of one pairwise call with a center:
    a (and b unless same), the center row and the output moved once; per
    value read, its centering, its norm's multiply-add and the hi/lo
    split's subtraction in float32; the Gram as three TF32 products."""
    rows = n if same else n + m
    return ((rows + 1) * p * 4 + n * m * 4, 4.0 * rows * p, 3 * 2.0 * n * m * p)


def check_kernels(results: dict) -> None:
    """Phase 3: each kernel against its plain version on the main path's
    inputs, its times, and Krum's selection through both."""
    import torch

    from murmura_tpu_torch.aggregation.base import AggContext
    from murmura_tpu_torch.aggregation.krum import make_krum
    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.flatten import model_dimension

    dev = torch.device("cuda")
    model = build_model("leaf.femnist.baseline", {})
    p = model_dimension(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    n = 16
    offsets = [1, 2, 14, 15]  # k-regular(4) on 16 nodes
    deltas = sorted({abs(b - a) for a in offsets for b in offsets if a != b})
    print(f"[kernels] shapes: N={n} P={p} offsets={offsets} deltas={deltas}", flush=True)

    own, bcast = krum_inputs(n, p, 1234)
    _distance_cases(results, own, bcast, offsets, in_round=True)

    # Krum's selection on the same round inputs, through the kernels (card)
    # and through the plain versions (the same tensors on the CPU).
    adj = torch.zeros((n, n))
    for o in offsets:
        adj[torch.arange(n), (torch.arange(n) + o) % n] = 1.0
    for c in (1, 3):  # 3 = the flagship's count (the (m-2)/2 fallback)
        for circ in (False, True):
            kw = {"num_compromised": c, "max_candidates": len(offsets) + 1}
            if circ:
                kw["exchange_offsets"] = offsets
            agg = make_krum(**kw)
            _, _, s_card = agg.aggregate(own, bcast, adj.to(dev), 0.0, {}, AggContext())
            _, _, s_cpu = agg.aggregate(own.cpu(), bcast.cpu(), adj, 0.0, {}, AggContext())
            sel_card = s_card["selected_index"].cpu()
            same = torch.equal(sel_card, s_cpu["selected_index"])
            print(f"[kernels] krum c={c} {'circulant' if circ else 'dense'}: "
                  f"selected_index kernel {sel_card.tolist()} "
                  f"{'==' if same else '!='} plain", flush=True)
            if not same:
                raise AssertionError("Krum's selection differs between kernel and plain")
    check_candidate_select(results, own, bcast, offsets)
    check_wearable_shapes(results)
    own_sk, bcast_sk = check_count_sketch(results, own, bcast)
    del own, bcast
    # Sketchguard's filter: the pairwise kernel on the [16, S] sketches,
    # centred on the mean of own's sketches (pairwise_l2_distances).
    s = own_sk.shape[1]
    _check_distances(
        results, "pairwise_sq_distances", f"(own, bcast sketches [{n}, {s}])",
        (own_sk, bcast_sk, own_sk.mean(dim=0)), *_pairwise_fns(),
        *_pairwise_work(n, n, s, False))
    torch.cuda.empty_cache()
    check_distances_n64(results)
    check_candidate_select_n64(results)
    check_circulant_beyond_cap(results)
    check_circulant_exponential(results)
    check_column_blocks(results)


def check_codec() -> dict:
    """Phase 3, the compressed exchange's codec (plain tensor code; no
    kernel row): on the card against the CPU on the same input, at the
    flagship's [16, P] in float32 and bfloat16.  int8 of block 256 (a third
    of one row zero, so some blocks are all zero): ``q`` and ``scale``
    bit-equal.  Top-k of ratio 0.05 with error feedback, two chained calls,
    the first from a zero reference with each row's k-th magnitude planted
    on 1.5 k entries of both signs (bfloat16 rows tie on their own): the
    decoded tensor, the residual and the reference bit-equal.  Each timed
    by CUDA events.  Returns {case: ms a call}."""
    import torch

    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.compress import (
        CompressionSpec, compress_exchange, init_compress_state, quantize_int8)
    from murmura_tpu_torch.ops.flatten import model_dimension

    dev = torch.device("cuda")
    model = build_model("leaf.femnist.baseline", {})
    p = model_dimension(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    n = 16
    ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        g = torch.Generator().manual_seed(77)
        x = torch.randn((n, p), generator=g) * torch.logspace(-3, 2, n)[:, None]
        x[1, : p // 3] = 0.0
        x = x.to(dtype)
        xc = x.to(dev)
        q_cpu, q_card = quantize_int8(x, 256), quantize_int8(xc, 256)
        ok = torch.equal(q_card.q.cpu(), q_cpu.q) and torch.equal(q_card.scale.cpu(), q_cpu.scale)
        ms[f"quantize_int8 {dname}"] = time_ms(lambda: quantize_int8(xc, 256))
        int8 = CompressionSpec("int8", block=256, error_feedback=True)
        st = init_compress_state(int8, xc)
        ms[f"int8 exchange {dname}"] = time_ms(lambda: compress_exchange(int8, xc, st, True))
        print(f"[codec] int8 {dname} [{n}, {p}] block 256: q, scale card == CPU: {ok}; "
              f"quantize {ms[f'quantize_int8 {dname}']:.3f} ms, compress_exchange with error "
              f"feedback {ms[f'int8 exchange {dname}']:.3f} ms", flush=True)
        if not ok:
            raise AssertionError(f"the int8 codec differs between the card and the CPU ({dname})")
        del q_cpu, q_card, st

        topk = CompressionSpec("topk", topk_ratio=0.05, error_feedback=True)
        k = topk.topk_k(p)
        y = torch.randn((n, p), generator=g)
        kth = y.abs().float().topk(k, dim=1).values[:, -1:]
        pos = torch.stack([torch.randperm(p, generator=g)[: 3 * k // 2] for _ in range(n)])
        signs = torch.where(torch.rand(pos.shape, generator=g) < 0.5, 1.0, -1.0)
        y.scatter_(1, pos, kth * signs)
        y = y.to(dtype)
        states = {"cpu": init_compress_state(topk, torch.zeros_like(y)),
                  "card": init_compress_state(topk, torch.zeros_like(y).to(dev))}
        equal = True
        for step, inp in enumerate((y, (y.float() + 0.01 * torch.randn(
                (n, p), generator=g)).to(dtype))):
            res = {}
            for where, t in (("cpu", inp), ("card", inp.to(dev))):
                _, dec, up, _ = compress_exchange(topk, t, states[where], False)
                states[where] = {**states[where], **up}
                res[where] = (dec, up)
            equal = equal and torch.equal(res["card"][0].cpu(), res["cpu"][0]) and all(
                torch.equal(res["card"][1][key].cpu(), res["cpu"][1][key]) for key in res["cpu"][1])
        yc = y.to(dev)
        st = states["card"]
        ms[f"top-k exchange {dname}"] = time_ms(lambda: compress_exchange(topk, yc, st, False))
        mag = y.abs().float()
        ties = int(((mag == mag.topk(k, dim=1).values[:, -1:]).sum(dim=1) > 1).sum())
        print(f"[codec] top-k {dname} [{n}, {p}] ratio 0.05 (k = {k}), error feedback, two "
              f"chained calls, {ties} of {n} rows with ties at the k-th magnitude: decoded, "
              f"residual and reference card == CPU: {equal}; compress_exchange "
              f"{ms[f'top-k exchange {dname}']:.3f} ms", flush=True)
        if not equal:
            raise AssertionError(f"the top-k codec differs between the card and the CPU ({dname})")
        del x, xc, y, yc, states, st, res
        torch.cuda.empty_cache()
    return ms


def check_wearable_shapes(results: dict) -> None:
    """The kernel calls of the 10-node wearable-MLP runs ([10, 178,310]
    float32, the UCI HAR MLP on the fully-connected graph): the two
    pairwise calls of Krum (uci_har_byzantine.yaml) and the (iterate,
    bcast) call of the geometric median (alie_geometric_median.yaml), and
    the trimmed mean's candidate select under ppermute (offsets 1-9, m =
    10, trim 3 of trim ratio 0.3: the kernel's generic path;
    label_flip_poisoning.yaml on backend: tpu)."""
    import torch

    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.flatten import model_dimension

    dev = torch.device("cuda")
    model = build_model("wearables.uci_har", {})
    n = 10
    p = model_dimension(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    print(f"[kernels] shapes: N={n} P={p} (the UCI HAR MLP, fully connected)", flush=True)
    own, bcast = krum_inputs(n, p, 1010)
    _check_distances(results, "pairwise_sq_distances", f"(bcast, bcast) N={n} P={p}",
                     (bcast, None, bcast.mean(dim=0)), *_pairwise_fns(),
                     *_pairwise_work(n, n, p, True))
    _check_distances(results, "pairwise_sq_distances", f"(own, bcast) N={n} P={p}",
                     (own, bcast, own.mean(dim=0)), *_pairwise_fns(),
                     *_pairwise_work(n, n, p, False))
    check_candidate_select(results, own, bcast, list(range(1, n)),
                           ((torch.float32, False, 3),), tag=f" N={n}", in_round=True)
    del own, bcast
    torch.cuda.empty_cache()


def krum_inputs(n: int, p: int, seed: int):
    """(own, bcast) [n, p] float32 on the card: nodes scattered around a
    common model with distinct spreads (so that Krum's scores have no
    near-ties), three of them broadcasting noise of std 10."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    spread = 0.01 * (1.0 + torch.arange(n, device=dev, dtype=torch.float32) / n)
    own = 0.05 * torch.randn((1, p), generator=g, device=dev) + spread[:, None] * torch.randn(
        (n, p), generator=g, device=dev
    )
    bcast = own.clone()
    bcast[:3] += 10.0 * torch.randn((3, p), generator=g, device=dev)
    torch.cuda.synchronize()
    return own, bcast


def _pairwise_fns():
    """(kernel, plain version, yardstick) of a pairwise case (a, b, c); the
    yardstick is cdist on the rows as they are (centering leaves distances
    unchanged)."""
    import torch

    from murmura_tpu_torch.ops import agg_kernels as K

    return (
        lambda a, b, c: K.pairwise_sq_distances(a, b, center=c),
        lambda a, b, c: K.pairwise_sq_distances_plain(a, b, center=c),
        lambda a, b, c: torch.cdist(a, a if b is None else b,
                                    compute_mode="use_mm_for_euclid_dist") ** 2,
    )


def _distance_cases(results, own, bcast, offsets, in_round, tag=""):
    """Krum's four distance calls on (own, bcast) with k-regular offsets:
    pairwise (bcast, bcast) and (own, bcast), each centered on the mean of
    its first operand as pairwise_l2_distances centers it, and circulant
    (own, bcast, offsets) and (bcast, bcast, deltas)."""
    from murmura_tpu_torch.ops import agg_kernels as K

    n, p = own.shape
    deltas = sorted({abs(b - a) for a in offsets for b in offsets if a != b})
    bytes_1 = n * p * 4  # one [N, P] float32 tensor
    kw = {"in_round": in_round}
    _check_distances(results, "pairwise_sq_distances", f"(bcast, bcast){tag}",
                     (bcast, None, bcast.mean(dim=0)), *_pairwise_fns(),
                     *_pairwise_work(n, n, p, True), **kw)
    _check_distances(results, "pairwise_sq_distances", f"(own, bcast){tag}",
                     (own, bcast, own.mean(dim=0)), *_pairwise_fns(),
                     *_pairwise_work(n, n, p, False), **kw)
    _check_distances(results, "circulant_sq_distances",
                     f"(own, bcast, offsets {offsets}){tag}", (own, bcast),
                     lambda a, b: K.circulant_sq_distances(a, b, offsets),
                     lambda a, b: K.circulant_sq_distances_plain(a, b, offsets),
                     None, 2 * bytes_1 + len(offsets) * n * 4,
                     3.0 * len(offsets) * n * p, **kw)
    _check_distances(results, "circulant_sq_distances",
                     f"(bcast, bcast, deltas {deltas}){tag}", (bcast, bcast),
                     lambda a, b: K.circulant_sq_distances(a, b, deltas),
                     lambda a, b: K.circulant_sq_distances_plain(a, b, deltas),
                     None, bytes_1 + len(deltas) * n * 4,
                     3.0 * len(deltas) * n * p, **kw)


def check_distances_n64(results: dict) -> None:
    """The two distance passes at N = 64 ([64, 1,048,576] float32 built
    like the flagship's inputs, k-regular(4) offsets): four pairwise output
    tiles a side, and 256 circulant pairs.  No main-path round makes these
    calls."""
    import torch

    n, p = 64, 1 << 20
    offsets = [1, 2, n - 2, n - 1]
    own, bcast = krum_inputs(n, p, 4321)
    print(f"[kernels] shapes: N={n} P={p} offsets={offsets}", flush=True)
    _distance_cases(results, own, bcast, offsets, in_round=False, tag=f" N={n}")
    del own, bcast
    torch.cuda.empty_cache()


def check_circulant_beyond_cap(results: dict) -> None:
    """The circulant pass at N that no main-path round makes (float32,
    k-regular(4) offsets): N = 2,500 with two tensors and N = 5,000 with one
    at P = 4,096, past the row cap; N = 1,000 with two at P = 262,144, where
    one launch would take 2-column tiles (all three split by the wrapper
    into launches of at most circulant_split_rows rows); and N = 400 with
    one at P = 262,144, one launch of 16-column tiles.  The last two are
    also timed the other way (one launch, or the split)."""
    import torch

    from murmura_tpu_torch.ops import agg_kernels as K

    for n, same, p in ((2500, False, 4096), (5000, True, 4096), (1000, False, 262_144),
                       (400, True, 262_144)):
        offsets = [1, 2, n - 2, n - 1]
        own, bcast = krum_inputs(n, p, n)
        own = bcast if same else own
        tensors = 1 if same else 2
        vec = K._vec(p, own, bcast)
        split = K.circulant_needs_split(n, same, vec)
        label = (f"({'bcast, bcast' if same else 'own, bcast'}, offsets {offsets}) "
                 f"N={n} P={p}, {'split' if split else 'one launch'}")
        _check_distances(results, "circulant_sq_distances", label, (own, bcast),
                         lambda a, b: K.circulant_sq_distances(a, b, offsets),
                         lambda a, b: K.circulant_sq_distances_plain(a, b, offsets),
                         None, tensors * n * p * 4 + len(offsets) * n * 4,
                         3.0 * len(offsets) * n * p, in_round=False)
        if n <= K.circulant_row_cap(vec) * (2 if same else 1):
            rows = K.circulant_split_rows(vec)
            plan = K.circulant_plan(n, p, len(offsets), same, vec, K._sm_count(own.device))
            if split:
                other = f"one launch of {1 << plan['tc_log2']}-column tiles"
                fn = lambda: K.circulant_launch(own, bcast, offsets)  # noqa: E731
            else:
                other = f"the split into {len(K.circulant_split(n, offsets, rows))} launches"
                fn = lambda: K.circulant_split_call(own, bcast, offsets, rows,  # noqa: E731
                                                    K.circulant_launch)
            ref = K.circulant_sq_distances_plain(own, bcast, offsets)
            if not bool(((fn() - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)).all()):
                raise AssertionError(f"circulant_sq_distances {label}: {other} disagrees")
            print(f"[kernels] circulant_sq_distances {label}: as {other} "
                  f"{time_ms(fn):.4f} ms (the wrapper's time is above)", flush=True)
            del ref
        del own, bcast
    torch.cuda.empty_cache()


def check_circulant_exponential(results: dict) -> None:
    """The circulant pass at the exponential graph's offsets, on the sparse
    runs' shapes: [256, 2,890] (population_1m.yaml's 32-64-10 MLP, k = 8,
    phase 4) and [64, P] of the tiny CNN (k = 6, phase 3c's sparse rows),
    float32: own against bcast at the offsets and bcast against bcast at
    their differences (Krum's two passes).  N = 256 stays under the
    wrapper's 260-row limit: one launch a call."""
    import torch

    from murmura_tpu_torch.models.cnn import make_femnist_cnn
    from murmura_tpu_torch.models.mlp import make_mlp
    from murmura_tpu_torch.ops import agg_kernels as K
    from murmura_tpu_torch.ops.flatten import model_dimension
    from murmura_tpu_torch.topology.sparse import exponential_offsets

    def dim(model):
        return model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))

    for n, p in ((256, dim(make_mlp(32, (64,), 10))), (64, dim(make_femnist_cnn(variant="tiny")))):
        offsets = list(exponential_offsets(n))
        deltas = sorted({abs(b - a) for a in offsets for b in offsets if a != b})
        own, bcast = krum_inputs(n, p, n + 7)
        for what, a, offs in (("own, bcast, exponential offsets", own, offsets),
                              ("bcast, bcast, their differences", bcast, deltas)):
            tensors = 1 if a is bcast else 2
            _check_distances(results, "circulant_sq_distances",
                             f"({what} {offs}) N={n} P={p}", (a, bcast),
                             lambda x, y, o=offs: K.circulant_sq_distances(x, y, o),
                             lambda x, y, o=offs: K.circulant_sq_distances_plain(x, y, o),
                             None, tensors * n * p * 4 + len(offs) * n * 4,
                             3.0 * len(offs) * n * p, in_round=False)
        del own, bcast
    torch.cuda.empty_cache()


def _check_distances(results, name, label, args, kern, plain, library, nbytes, flops,
                     tf32_flops=0.0, in_round=True):
    """One distance kernel case against its plain version and against a
    repeat of itself (bit-equal), then timed, with its device time and its
    launches a call."""
    import torch

    from murmura_tpu_torch.ops import agg_kernels as K

    before = K.LAUNCHES[name]
    got = kern(*args)
    launches = K.LAUNCHES[name] - before
    again = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if name == "pairwise_sq_distances":
        a, b, c = args
        sa = ((a - c) ** 2).sum(-1)
        sb = sa if b is None else ((b - c) ** 2).sum(-1)
        limit = 1e-5 * (sa[:, None] + sb[None, :])
        rule = "|d2 - plain| <= 1e-5 (|a_i - c|^2 + |b_j - c|^2)"
    else:
        limit = 1e-5 * torch.clamp(ref.abs(), min=1.0)
        rule = "|d2 - plain| <= 1e-5 max(1, |plain|)"
    max_err = float(err.max())
    repeat = torch.equal(got, again)
    ok = bool((err <= limit).all()) and bool(torch.isfinite(got).all()) and repeat
    print(f"[kernels] {name} {label}: max |d2 - plain| = {max_err:.6g}, "
          f"limit {rule} (max limit {float(limit.max()):.6g}); repeat call bit-equal: "
          f"{repeat}; {launches} launch(es) a call: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version or itself")
    del got, again, ref, err, limit
    _record(results, name, label, max_err,
            lambda: kern(*args), lambda: plain(*args),
            None if library is None else (lambda: library(*args)), nbytes, flops,
            in_round=in_round, tf32_flops=tf32_flops, profile=True)


def _record(results, name, label, max_err, kern, plain, library, nbytes, flops,
            in_round=True, tf32_flops=0.0, profile=False):
    """Time a checked kernel beside its plain version and yardstick.
    ``in_round``: the case is one of the calls a main-path round makes;
    ``profile``: also take its device time from a profiler trace."""
    import torch

    ms = time_ms(kern)
    split = device_split(kern) if profile else {}
    dev_ms = sum(split.values()) if split else None
    plain_ms = time_ms(plain, PLAIN_REPS)
    lib_ms = time_ms(library) if library is not None else None
    torch.cuda.synchronize()
    bound_ms, bound_by = bound(nbytes, flops, tf32_flops)
    shown = "" if not profile else (
        f" (device {dev_ms:.4f} ms)" if dev_ms is not None else " (device time not measured)")
    print(f"[kernels] {name} {label}: kernel {ms:.4f} ms{shown}, plain {plain_ms:.4f} ms, "
          f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP float32, {tf32_flops / 1e9:.2f} GFLOP TF32), "
          f"{bound_ms / ms:.1%} of the bound", flush=True)
    if len(split) > 1:
        print(f"[kernels] {name} {label}: device ms by kernel "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    results.setdefault(name, []).append({
        "case": label, "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
        "device_split": split,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "in_round": in_round,
    })


def check_candidate_select(results: dict, own, bcast, offsets, cases=None, tag="",
                           in_round=None) -> None:
    """Fused candidate selection at the main path's shape: median and
    trimmed mean (trim 1 of m = 5) in float32, and the trimmed mean in
    bfloat16 (the parameter dtype from 64 nodes up), or the given
    (dtype, median, trim) cases.  Limit: bit-equal to the plain version,
    and to itself on a repeat call.  A median round makes the first call, a
    trimmed-mean round the second."""
    import torch

    from murmura_tpu_torch.ops import candidate_kernels as C

    m = len(offsets) + 1
    n, p = own.shape
    cases = cases or ((torch.float32, True, 0), (torch.float32, False, 1),
                      (torch.bfloat16, False, 1))
    for dtype, median, trim in cases:
        o, b = own.to(dtype), bcast.to(dtype)
        label = (f"({str(dtype).replace('torch.', '')}, "
                 f"{'median' if median else f'trim {trim}'}, m {m}){tag}")
        got = C.candidate_select(o, b, offsets, trim=trim, median=median)
        again = C.candidate_select(o, b, offsets, trim=trim, median=median)
        torch.cuda.synchronize()
        ref = C.candidate_select_plain(o, b, offsets, trim=trim, median=median)
        torch.cuda.synchronize()
        max_err = float((got.float() - ref.float()).abs().max())
        repeat = torch.equal(got, again)
        ok = torch.equal(got, ref) and repeat and bool(torch.isfinite(got).all())
        print(f"[kernels] candidate_select {label}: max |out - plain| = {max_err:.6g}, "
              f"limit bit-equal; repeat call bit-equal: {repeat}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"candidate_select {label} disagrees with its plain version")
        del got, again, ref
        item = o.element_size()
        library = stack = None
        if median and m % 2 == 1:
            # One PyTorch call computes the median on the candidate stack
            # gathered beforehand ([m, N, P]: own, then bcast rolled by each
            # offset), as the count sketch's yardstick takes pre-signed
            # rows; m odd, so torch's lower median is the median.  No one
            # call computes the trimmed mean.
            stack = torch.stack([o] + [torch.roll(b, -off, dims=0) for off in offsets])
            lib_out = torch.median(stack, dim=0).values
            lib_same = torch.equal(lib_out, C.candidate_select(o, b, offsets, trim=0,
                                                               median=True))
            print(f"[kernels] candidate_select {label}: torch.median on the pre-gathered "
                  f"[{m}, {n}, {p}] stack equals the kernel: {lib_same}", flush=True)
            if not lib_same:
                raise AssertionError(f"candidate_select {label} disagrees with torch.median")
            del lib_out

            def library():
                return torch.median(stack, dim=0)
        # Read own and bcast once, write the output once; about m^2/2
        # compare-exchanges and m adds per output.
        _record(results, "candidate_select", label, max_err,
                lambda: C.candidate_select(o, b, offsets, trim=trim, median=median),
                lambda: C.candidate_select_plain(o, b, offsets, trim=trim, median=median),
                library, 3 * n * p * item, (m * (m - 1) / 2 + m) * n * p,
                in_round=(dtype == torch.float32 and median) if in_round is None else in_round,
                profile=True)
        del o, b, library, stack
        torch.cuda.empty_cache()


def check_candidate_select_n64(results: dict) -> None:
    """Candidate selection at [64, 6,603,710] in bfloat16, the 64-node
    flagship's parameter dtype, median and trim 1 (k-regular(4) offsets).
    No main-path round of phase 4 makes these calls."""
    import torch

    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.flatten import model_dimension

    dev = torch.device("cuda")
    model = build_model("leaf.femnist.baseline", {})
    p = model_dimension(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    n = 64
    offsets = [1, 2, n - 2, n - 1]
    own, bcast = krum_inputs(n, p, 6464)
    own, bcast = own.to(torch.bfloat16), bcast.to(torch.bfloat16)
    torch.cuda.empty_cache()
    print(f"[kernels] shapes: N={n} P={p} offsets={offsets} bfloat16", flush=True)
    check_candidate_select(results, own, bcast, offsets,
                           ((torch.bfloat16, False, 1), (torch.bfloat16, True, 0)),
                           tag=f" N={n}", in_round=False)
    del own, bcast
    torch.cuda.empty_cache()


def check_count_sketch(results: dict, own, bcast):
    """The count sketches of own and of bcast ([16, P] float32 each, the
    two calls a Sketchguard round makes) with Sketchguard's tables (S =
    1000, seed 42), each twice (bit-equal: the same from run to run).
    Limit: |out - plain| <= 1e-4 sum_{p: hash=s} |v_p| per bucket, float32
    reordering over a bucket of about P/S terms.  Returns the kernel's
    sketches of own and of bcast."""
    import torch

    from murmura_tpu_torch.ops import sketch_kernels as SK
    from murmura_tpu_torch.ops.sketch import build_sketch_tables

    rows, p = own.shape
    s = 1000
    t0 = time.perf_counter()
    tables = build_sketch_tables(p, s, 42)
    t = tables.plain_on(own.device)
    print(f"[kernels] count_sketch tables for P={p}, S={s}: "
          f"{time.perf_counter() - t0:.2f} s on the host", flush=True)
    sms = torch.cuda.get_device_properties(own.device).multi_processor_count
    print(f"[kernels] count_sketch plan for [{rows}, {p}]: slices of {tables.slice_len} "
          f"columns, {tables.starts.shape[0]} slices, "
          f"{SK.sketch_plan(rows, p, s, tables.slice_len, sms)}", flush=True)
    sketches = []
    for which, v in (("own", own), ("bcast", bcast)):
        label = f"({which} [{rows}, {p}] float32, S {s})"
        got = SK.count_sketch(v, tables)
        again = SK.count_sketch(v, tables)
        torch.cuda.synchronize()
        ref = SK.count_sketch_plain(v, tables)
        scale = torch.zeros((rows, s), device=v.device).index_add_(1, t["hash"], v.abs())
        err = (got - ref).abs()
        max_err = float(err.max())
        same = torch.equal(got, again)
        ok = bool((err <= 1e-4 * scale).all()) and same and bool(torch.isfinite(got).all())
        print(f"[kernels] count_sketch {label}: max |out - plain| = {max_err:.6g}, limit "
              f"1e-4 sum|v| per bucket (smallest limit {float((1e-4 * scale).min()):.6g}); "
              f"repeat call bit-equal: {same}: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"count_sketch {label} disagrees with its plain version or itself")
        signed = t["sign"] * v
        # What the kernel reads and writes: v once, its 16-bit entries and
        # its int32 starts once, the output once.  The yardstick is
        # index_add_ of the pre-signed values.
        nbytes = (rows * p * 4 + tables.entries.nbytes + tables.starts.nbytes
                  + rows * s * 4)
        _record(results, "count_sketch", label, max_err,
                lambda: SK.count_sketch(v, tables), lambda: SK.count_sketch_plain(v, tables),
                lambda: torch.zeros((rows, s), device=v.device).index_add_(1, t["hash"], signed),
                nbytes, 2.0 * rows * p, profile=True)
        sketches.append(got)
        del signed, again, ref, scale, err
    return sketches


@contextlib.contextmanager
def kept_calls(mod, attr: str, sink: list, tag=None):
    """While open, ``mod.attr`` keeps a copy of the arguments of every call
    in ``sink`` (as (tag, args, kwargs)) before it runs."""
    import torch

    real = getattr(mod, attr)

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrapper(*args, **kwargs):
        sink.append((tag, tuple(clone(a) for a in args), {k: clone(v) for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    setattr(mod, attr, wrapper)
    try:
        yield
    finally:
        setattr(mod, attr, real)


# Phase 3b's rules: (label, rule, params, stats that must be equal).  The
# params' "circulant" runs the rule under ppermute's offsets; "wearable"
# runs the round on the evidential wearable MLP (UCI HAR widths, dropout
# 0.3, injected masks) instead of the tiny CNN; "attack" (type, params)
# replaces the gaussian attack of std 10.
UBAR_STAGES = ("agg_stage1_acceptance_rate", "agg_stage2_acceptance_rate")
# The faulted rows' audit taps (telemetry.audit_taps), and what the stale
# rows hold exactly equal.
FAULT_TAPS = ("agg_tap_quarantined", "agg_tap_attack_scrubbed", "agg_tap_alive",
              "agg_tap_selected_by", "agg_tap_considered_by")
STALE_EQUAL = ("agg_stale_used", "agg_stale_expired", "agg_tap_stale_used",
               "agg_tap_stale_age", "agg_alive", "agg_quarantined", "agg_selected_index",
               "agg_tap_quarantined", "agg_tap_alive", "agg_tap_selected_by")
# The codecs of the compressed runs: int8 of block 256 and top-k of ratio
# 0.05, each with error feedback.
INT8_EF = {"algorithm": "int8", "block": 256, "error_feedback": True}
TOPK_EF = {"algorithm": "topk", "topk_ratio": 0.05, "error_feedback": True}
ROUND_RULES = [
    ("krum dense", "krum", {"num_compromised": 1}, ("agg_selected_index",)),
    ("krum circulant", "krum", {"num_compromised": 1, "circulant": True}, ("agg_selected_index",)),
    ("median circulant", "median", {"circulant": True}, ()),
    ("trimmed_mean circulant", "trimmed_mean", {"trim_ratio": 0.2, "circulant": True}, ()),
    ("geometric_median dense", "geometric_median", {}, ()),
    ("geometric_median circulant", "geometric_median", {"circulant": True}, ()),
    ("balance dense", "balance", {}, ("agg_acceptance_rate",)),
    ("balance circulant", "balance", {"circulant": True}, ("agg_acceptance_rate",)),
    ("sketchguard dense", "sketchguard", {}, ("agg_acceptance_rate",)),
    ("sketchguard circulant", "sketchguard", {"circulant": True}, ("agg_acceptance_rate",)),
    ("fedavg dense", "fedavg", {}, ()),
    # rho 0.8 shortlists 3 of the 4 neighbours, so the loss probe decides.
    ("ubar dense", "ubar", {"rho": 0.8}, UBAR_STAGES),
    ("ubar circulant", "ubar", {"rho": 0.8, "circulant": True}, UBAR_STAGES),
    ("krum dense, wearable MLP, dropout 0.3", "krum", {"num_compromised": 1, "wearable": True},
     ("agg_selected_index",)),
    # The other attacks, and evidential trust on the wearable MLP (trust
    # threshold 0.1 as in uci_har_evidential_trust.yaml).
    ("geometric_median dense", "geometric_median",
     {"attack": ("alie", {"z": 1.5})}, ()),
    ("geometric_median circulant", "geometric_median",
     {"circulant": True, "attack": ("alie", {"estimator": "coalition"})}, ()),
    ("trimmed_mean circulant", "trimmed_mean",
     {"trim_ratio": 0.2, "circulant": True, "attack": ("ipm", {})}, ()),
    ("balance dense", "balance",
     {"attack": ("directed_deviation", {})}, ("agg_acceptance_rate",)),
    ("trimmed_mean dense", "trimmed_mean",
     {"trim_ratio": 0.2, "attack": ("label_flip", {})}, ()),
    ("evidential_trust dense", "evidential_trust",
     {"trust_threshold": 0.1, "wearable": True}, ("agg_acceptance_rate",)),
    ("evidential_trust circulant", "evidential_trust",
     {"trust_threshold": 0.1, "circulant": True, "wearable": True}, ("agg_acceptance_rate",)),
    # The fault model (FAULT_* nodes; 1 of 16 an IPM attacker, epsilon
    # 1e39), and the compressed exchange with error feedback.
    ("krum dense, faulted", "krum",
     {"num_compromised": 1, "faults": True, "pct": 1 / 16,
      "attack": ("ipm", {"epsilon": 1e39})},
     ("agg_alive", "agg_quarantined", "agg_attack_scrubbed", "agg_selected_index")
     + FAULT_TAPS),
    # Bounded staleness (max 2, discount 0.7) on the faulted graph, from a
    # hand-made cache (STALE_*): a straggler whose cache is warm, one whose
    # cache is past the bound, the NaN-injected sender with a warm cache,
    # and the dead node as a receiver; the audit taps on.
    ("krum dense, stale", "krum", {"num_compromised": 1, "faults": True, "stale": True},
     STALE_EQUAL),
    ("krum circulant, stale", "krum",
     {"num_compromised": 1, "faults": True, "stale": True, "circulant": True}, STALE_EQUAL),
    ("krum dense, int8", "krum",
     {"num_compromised": 1, "compression": INT8_EF}, ("agg_selected_index",)),
    ("krum circulant, int8", "krum",
     {"num_compromised": 1, "circulant": True, "compression": INT8_EF},
     ("agg_selected_index",)),
    ("median circulant, int8", "median",
     {"circulant": True, "compression": INT8_EF}, ("agg_num_candidates",)),
    ("krum dense, top-k", "krum",
     {"num_compromised": 1, "compression": TOPK_EF}, ("agg_selected_index",)),
]


# Phase 3b's seeds: each draws its own data, initial parameters and draws
# (cut from four, with 19 and 23, for the script's time budget; PERF.md
# section 6 has the times of both).
ROUND_SEEDS = (7, 11)


def _round_inputs(n: int, seed: int, wearable: bool):
    """(model, data, initial parameters, injected draws) of one phase-3b
    round: one common model plus per-node offsets of distinct scales (so
    that Krum's scores and UBAR's probe losses are far apart compared with
    float32 summation noise), a shuffle key and, for the wearable MLP, one
    dropout mask a layer and step."""
    import numpy as np
    import torch

    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.models.cnn import make_femnist_cnn
    from murmura_tpu_torch.models.mlp import make_wearable_mlp
    from murmura_tpu_torch.ops.flatten import tree_map

    if wearable:
        model = make_wearable_mlp()
        data = build_federated_data("wearables.uci_har", {
            "num_samples": 640, "partition_method": "dirichlet", "alpha": 0.5},
            num_nodes=n, seed=seed)
    else:
        model = make_femnist_cnn(variant="tiny")
        data = build_federated_data("leaf.femnist", {"num_samples": 640}, num_nodes=n, seed=seed)
    rng = np.random.default_rng(seed)
    template = model.init(torch.Generator().manual_seed(seed), "cpu")
    scale = 0.02 * (1.0 + np.arange(n) / n)
    init = tree_map(
        lambda t: (t.numpy()[None] + scale.reshape((n,) + (1,) * t.dim())
                   * rng.normal(size=(n,) + tuple(t.shape))).astype(np.float32),
        template,
    )
    draws = {"u": [rng.random(data.mask.shape).astype(np.float32)]}
    if model.dropout_widths:
        steps, batch = int(data.steps_per_epoch(16).max()), int(data.effective_batch(16).max())
        keep = 1.0 - model.dropout
        draws["dropout"] = [[[rng.random((n, batch, w)) < keep for w in model.dropout_widths]
                             for _ in range(steps)]]
    return model, data, init, draws


def gm_dense_bound(own, bcast, adj, steps, z, m_cap: int, nu: float = 1e-6,
                   eps: float = 1e-5) -> float:
    """The derived bound on the scaled card-against-CPU delta of a float32
    dense geometric-median round (PERF.md section 2), from the rule's inputs,
    its CPU output ``z`` and ``steps``: one (z_t, d2_err_t) a Weiszfeld
    step, z_t the iterate whose distances the step's pairwise call took on
    the card and d2_err_t that call's measured discrepancy [i, j] (kernel
    against plain version), or None for the kernel's limit eps (|b_j - c|^2
    + |z_i - c|^2), c the broadcast mean.  A discrepancy dD2_ij moves the
    weight w_ij = 1/d_ij by the relative rho_ij = |dD2_ij| / (2 d_ij^2), and
    the step's weighted mean in coordinate p by sum_j rho_ij w_ij |b_jp -
    z_ip| / W_i, taken at its largest p; the [N, N] @ [N, P] mean adds 2 m u
    max|x| (m terms, u = 2^-24).  Summed over the steps (first order: a step
    carries an earlier step's error at most at its own size) and scaled by
    max(1, max|z|)."""
    import torch

    from murmura_tpu_torch.aggregation.base import candidate_indices

    own, bcast, z = (t.double().cpu() for t in (own, bcast, z))
    adj = adj.cpu()
    n = own.shape[0]
    ci, cv = candidate_indices(adj, m_cap)
    nb = torch.zeros((n, n), dtype=torch.float64)
    nb[torch.arange(n)[:, None], ci] = cv.double()
    nb *= 1.0 - torch.eye(n, dtype=torch.float64)
    c = bcast.mean(dim=0)
    total = 0.0
    for z_t, d2_err in steps:
        z_t = z_t.double().cpu()
        d = torch.clamp(torch.cdist(z_t, bcast), min=nu)  # [i, j] = |b_j - z_i|
        if d2_err is None:
            d2_err = eps * (((z_t - c) ** 2).sum(-1)[:, None]
                            + ((bcast - c) ** 2).sum(-1)[None, :])
        w = nb / d
        coef = d2_err.double().cpu() / (2 * d * d) * w
        w_total = 1.0 / torch.clamp((own - z_t).norm(dim=-1), min=nu) + w.sum(dim=1)
        total += max(float((coef[i] @ (bcast - z_t[i]).abs()).max() / w_total[i])
                     for i in range(n))
    sums = 2.0 * m_cap * 2.0 ** -24 * float(torch.maximum(own.abs().max(), bcast.abs().max()))
    return (total + (len(steps) + 1) * sums) / max(1.0, float(z.abs().max()))


def codec_bound(spec, x_card, x_cpu, ref, own_card, own_cpu, out_cpu):
    """The derived bound on the scaled card-against-CPU delta of a
    compressed round whose rule copies a candidate row or takes a
    coordinate-wise order statistic of the candidates (Krum, the median):
    each output element then moves by at most the largest move of a
    candidate element: an own row's (|own_card - own_cpu|, from training)
    or a decoded row's.  A decoded element moves by at most the codec's
    input delta carried through, plus one step where its code differs
    between the devices.  int8: |q_a s_a - q_b s_b| <= |q_a| |s_a - s_b| +
    s_b |q_a - q_b| <= max_block |dx| + s_b |dq| (|q| <= 127, s = max|x| /
    127).  top-k (the same reference on both): |dx| where both devices pick
    the element, max |x - ref| where only one does.  ``x_*`` are the codec
    inputs (broadcast plus residual, float32).  The codes of the card are
    recomputed on the CPU from the card's input (the codec is bit-equal
    between the devices: phase 3).  Returns (bound scaled by max(1,
    max|out|), codes or picks that differ, max |dx|)."""
    import torch

    from murmura_tpu_torch.ops.compress import quantize_int8, topk_mask

    xa, xb = x_card.cpu(), x_cpu.cpu()
    dx = (xa - xb).abs()
    n, p = xb.shape
    if spec.algorithm == "int8":
        qa, qb = quantize_int8(xa, spec.block), quantize_int8(xb, spec.block)
        pad = qb.q.shape[1] - p
        dx_blk = torch.nn.functional.pad(dx, (0, pad)).reshape(n, -1, spec.block).amax(-1)
        dq = (qa.q.to(torch.int16) - qb.q.to(torch.int16)).abs().to(torch.float32)
        step = (dq.reshape(n, -1, spec.block) * qb.scale[:, :, None]).reshape(n, -1)[:, :p]
        elem = torch.repeat_interleave(dx_blk, spec.block, dim=1)[:, :p] + step
        differ = int((dq > 0).sum())
    else:
        ref = ref.cpu().float()
        da, db = xa - ref, xb - ref
        k = spec.topk_k(p)
        ma, mb = topk_mask(da.abs(), k), topk_mask(db.abs(), k)
        elem = torch.where(ma & mb, dx, 0.0) + torch.where(
            ma ^ mb, torch.maximum(da.abs(), db.abs()), 0.0)
        differ = int((ma ^ mb).sum())
    d_own = float((own_card.cpu().float() - own_cpu.cpu().float()).abs().max())
    total = max(d_own, float(elem.max()))
    return total / max(1.0, float(out_cpu.abs().max())), differ, float(dx.max())


# The faulted rows of phase 3b: node 5 dead, node 6's one link goes to node
# 5 (no alive neighbour), node 2 emits NaN, and one IPM attacker whose
# broadcast overflows to inf (epsilon 1e39).
FAULT_DEAD, FAULT_ISOLATED, FAULT_NAN = 5, 6, 2
# The stale rows: node 4 (a neighbour of the dead node) straggles with a
# cache one round old, node 12 with one past the bound; node 2 (NaN) has a
# warm cache that the scrub gate withholds.
STALE_WARM, STALE_EXPIRED = 4, 12


def check_round_against_cpu(device: str = "cuda") -> None:
    """Phase 3b: one round (16 nodes, k-regular(4), float32 compute, 20%
    compromised: gaussian std 10 unless the row names another attack) per
    rule and seed on the card and on the CPU, from the
    same initial parameters and the same injected draws (shuffle, noise and
    dropout masks), on the tiny CNN, or on the wearable MLP for the row that
    says so.  The card runs the kernels, the CPU their plain versions; on
    every seed the post-round parameters must agree to a scaled delta of
    1e-4, and Krum's selection, the filters' acceptance and UBAR's two
    stages must be equal.  The dense geometric median's line also prints
    the derived bound on its delta (gm_dense_bound).  The faulted row (a
    dead node, a node with no alive neighbour, a NaN-injected node, an
    attack row overflowing to inf) holds the fault stats and the audit taps
    exactly equal.  The stale rows (bounded staleness from a hand-made
    cache, STALE_*) hold the stale stats and taps, the new ages and Krum's
    picks exactly equal, and the card's new cache bit-equal to the
    broadcast its rule was handed.
    The compressed rows (int8 or top-k, with error feedback from a non-zero
    residual) hold the decisions equal and the delta within codec_bound,
    printed beside it with the codes that differ.  Every seed runs before a
    failure is raised, so the line shows the largest delta."""
    import dataclasses

    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.attacks import ATTACKS
    from murmura_tpu_torch.core import rounds as rounds_mod
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.core.stale import AGE_KEY, CACHE_KEY, StalenessSpec
    from murmura_tpu_torch.faults.schedule import FaultSpec
    from murmura_tpu_torch.ops import agg_kernels as K
    from murmura_tpu_torch.ops.compress import RESIDUAL_KEY, CompressionSpec
    from murmura_tpu_torch.ops.flatten import model_dimension
    from murmura_tpu_torch.topology.generators import create_topology

    n, offsets = 16, [1, 2, 14, 15]
    base_adj = create_topology("k-regular", n, k=4).mask()
    fault_adj = base_adj.copy()
    fault_adj[FAULT_ISOLATED, :] = fault_adj[:, FAULT_ISOLATED] = 0.0
    fault_adj[FAULT_ISOLATED, FAULT_DEAD] = fault_adj[FAULT_DEAD, FAULT_ISOLATED] = 1.0
    alive_np = np.ones(n, np.float32)
    alive_np[FAULT_DEAD] = 0.0
    stale_adj = base_adj.copy()
    stale_adj[:, [STALE_WARM, STALE_EXPIRED]] = 0.0
    inputs = {}
    for label, rule, params, equal_stats in ROUND_RULES:
        wearable = bool(params.get("wearable"))
        faulted = bool(params.get("faults"))
        stale = bool(params.get("stale"))
        comp_kw = params.get("compression")
        kind, attack_kw = params.get("attack", ("gaussian", {"noise_std": 10.0}))
        pct = params.get("pct", 0.2)
        kw = {k: v for k, v in params.items()
              if k not in ("circulant", "wearable", "attack", "faults", "compression", "pct",
                           "stale")}
        dense_gm = rule == "geometric_median" and not params.get("circulant")
        if params.get("circulant"):
            kw["exchange_offsets"] = offsets
        if rule in ("krum", "median", "trimmed_mean", "geometric_median"):
            kw["max_candidates"] = len(offsets) + 1
        adj = stale_adj if stale else fault_adj if faulted else base_adj
        deltas, bounds, unequal, ok = [], [], [], True
        codec_notes, fault_notes, stale_notes = [], [], []
        for seed in ROUND_SEEDS:
            if (seed, wearable) not in inputs:
                inputs[seed, wearable] = _round_inputs(n, seed, wearable)
            model, data, init, draws = inputs[seed, wearable]
            template = model.init(torch.Generator().manual_seed(0), "cpu")
            out, seen, gram, codec_in, rule_in = {}, [], [], {}, {}
            spec = None if comp_kw is None else CompressionSpec(**comp_kw)
            for dev in (device, "cpu"):
                attack = ATTACKS[kind](n, pct, seed=seed, **attack_kw)
                if attack.data_poison_fn is not None:
                    data = dataclasses.replace(data, y=attack.data_poison_fn(
                        inputs[seed, wearable][1].y, data.mask, data.num_classes))
                agg = build_aggregator(rule, kw, model_dim=model_dimension(template))
                real = agg.aggregate

                def keep(own, bcast, adj_, *rest, real=real, dev=dev):
                    rule_in[dev] = own.clone()
                    rule_in[dev, "bcast"] = bcast.clone()
                    if dev == "cpu":
                        seen.append((own.clone(), bcast.clone(), adj_.clone()))
                    return real(own, bcast, adj_, *rest)

                agg = dataclasses.replace(agg, aggregate=keep)
                prog = build_round_program(
                    model, agg, data,
                    attack=attack, local_epochs=1, batch_size=16, lr=0.05, seed=seed,
                    device=dev, init_params=init,
                    faults=FaultSpec(nan_inject_nodes=(FAULT_NAN,)) if faulted else None,
                    compression=spec, audit_taps=faulted,
                    staleness=StalenessSpec(2, 0.7, base_mask=base_adj) if stale else None,
                )
                noise = np.random.default_rng(seed + 1).normal(
                    size=(int(attack.compromised.sum()), prog.model_dim)).astype(np.float32)
                comp = torch.as_tensor(attack.compromised.astype(np.float32)).to(dev)
                state = dict(prog.init_agg_state)
                if spec is not None and spec.error_feedback:
                    state[RESIDUAL_KEY] = torch.as_tensor(
                        0.01 * np.random.default_rng(seed + 2).normal(
                            size=tuple(prog.init_flat.shape)).astype(np.float32)).to(dev)
                if stale:
                    # Every sender delivered a round earlier (age 0), one
                    # three rounds earlier; each cache row near its sender.
                    age = np.zeros(n, np.float32)
                    age[STALE_EXPIRED] = 2.0
                    state[AGE_KEY] = torch.as_tensor(age).to(dev)
                    state[CACHE_KEY] = prog.init_flat + torch.as_tensor(
                        0.01 * np.random.default_rng(seed + 3).normal(
                            size=tuple(prog.init_flat.shape)).astype(np.float32)).to(dev)
                real_codec = rounds_mod.compress_exchange

                def codec(spec_, bcast, agg_state, *rest, dev=dev):
                    x = bcast.float()
                    if spec_.error_feedback:
                        x = x + agg_state[RESIDUAL_KEY].float()
                    codec_in[dev] = (x, agg_state.get("compress_ref"))
                    return real_codec(spec_, bcast, agg_state, *rest)

                sink = gram if dev != "cpu" and dense_gm else []
                alive = torch.as_tensor(alive_np).to(dev) if faulted else None
                rounds_mod.compress_exchange = codec
                try:
                    with kept_calls(K, "pairwise_sq_distances", sink):
                        flat, new_state, metrics = prog.train_step(
                            prog.init_flat, state, torch.as_tensor(adj).to(dev), comp, 0.0,
                            draws={**draws, "noise": noise}, alive=alive)
                finally:
                    rounds_mod.compress_exchange = real_codec
                out[dev] = (flat.cpu().double(), {k: v.cpu() for k, v in metrics.items()})
                if stale:
                    rule_in[dev, "state"] = {k: new_state[k].cpu()
                                             for k in (AGE_KEY, CACHE_KEY)}
            (f_card, m_card), (f_cpu, m_cpu) = out[device], out["cpu"]
            delta = float((f_card - f_cpu).abs().max() / max(1.0, float(f_cpu.abs().max())))
            deltas.append(delta)
            limit = 1e-4
            if spec is not None:
                (x_card, ref), (x_cpu, _) = codec_in[device], codec_in["cpu"]
                b, differ, dx = codec_bound(spec, x_card, x_cpu, ref, rule_in[device],
                                            rule_in["cpu"], f_cpu)
                limit = b
                codec_notes.append(f"seed {seed}: bound {b:.3g}, codec input max |dx| "
                                   f"{dx:.3g}, {differ} {'codes' if spec.algorithm == 'int8' else 'picks'} differ")
            if faulted and not stale:
                fault_notes.append(
                    "/".join(f"{float(m_card[k]):g}" for k in
                             ("agg_alive", "agg_quarantined", "agg_attack_scrubbed")))
            if stale:
                s_card, s_cpu = rule_in[device, "state"], rule_in["cpu", "state"]
                ages_equal = torch.equal(s_card[AGE_KEY], s_cpu[AGE_KEY])
                cache_served = torch.equal(s_card[CACHE_KEY], rule_in[device, "bcast"].cpu())
                served = m_card["agg_tap_stale_age"]
                exercised = (float(served[STALE_WARM]) == 1.0 and float(served[FAULT_NAN]) == 0.0
                             and float(m_card["agg_stale_expired"]) > 0)
                stale_notes.append(
                    f"seed {seed}: used {float(m_card['agg_stale_used']):g}, expired "
                    f"{float(m_card['agg_stale_expired']):g}, ages equal {ages_equal}, "
                    f"card cache == its served broadcast {cache_served}, schedule exercised "
                    f"{exercised}")
                ok = ok and ages_equal and cache_served and exercised
            if dense_gm:
                # Each Weiszfeld step's distance call on the card (the last
                # call only feeds the stats): its iterate z_t and its Gram
                # discrepancy, kernel against plain version, as [z_i, b_j].
                iters = 8
                if len(gram) != iters + 1:
                    raise AssertionError(f"{len(gram)} pairwise calls, want {iters + 1}")
                steps = [(args_[1], (K.pairwise_sq_distances(*args_, **kwargs)
                                     - K.pairwise_sq_distances_plain(*args_, **kwargs)).abs().T.cpu())
                         for _, args_, kwargs in gram[:iters]]
                m_cap = len(offsets) + 1
                bounds.append((gm_dense_bound(*seen[0], [(z_t, None) for z_t, _ in steps],
                                              f_cpu, m_cap),
                               gm_dense_bound(*seen[0], steps, f_cpu, m_cap)))
            unequal += [f"{k} (seed {seed})" for k in equal_stats
                        if not torch.equal(m_card[k], m_cpu[k])]
            ok = ok and delta <= limit and bool(torch.isfinite(f_card).all())
        ok = ok and not unequal
        shown = ""
        if equal_stats:
            shown = (f"; {', '.join(equal_stats)} == CPU on every seed" if not unequal
                     else f"; differs from the CPU: {', '.join(unequal)}")
        if bounds:
            shown += (
                "; derived bound from the kernel's limit "
                f"{', '.join(f'{b[0]:.3g}' for b in bounds)}, from this round's Gram "
                f"discrepancy {', '.join(f'{b[1]:.3g}' for b in bounds)} (every delta under "
                f"both: {all(d <= min(b) for d, b in zip(deltas, bounds))})")
        if codec_notes:
            shown += f"; derived codec bound (gated): {'; '.join(codec_notes)}"
        if fault_notes:
            shown += f"; alive/quarantined/attack_scrubbed by seed {', '.join(fault_notes)}"
        if stale_notes:
            shown += f"; {'; '.join(stale_notes)}"
        limit_note = "codec_bound" if spec is not None else "1e-4"
        what = (("wearable MLP" if wearable else "tiny CNN") + f", {kind} attack"
                + (f" {attack_kw}" if "attack" in params else ""))
        print(f"[round] {label}, {what}, card vs CPU, seeds {list(ROUND_SEEDS)}: scaled "
              f"param delta {', '.join(f'{d:.3g}' for d in deltas)} (largest "
              f"{max(deltas):.3g}, limit {limit_note}){shown}: {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            raise AssertionError(f"a {label} round on the card disagrees with the CPU round")


def check_pipelined_against_cpu(device: str = "cuda") -> None:
    """Phase 3b, pipelined rounds: Krum (num_compromised 1) on the tiny CNN,
    16 nodes, k-regular(4), 20% gaussian std 10, built with pipeline=True,
    two chained rounds on the card and on the CPU from the same initial
    parameters and injected draws (each round its own attack noise), so
    that round 1 aggregates a valid buffer (round 0 the placeholder), in
    both exchanges and on each of ROUND_SEEDS.  Every round's Krum picks and
    ``agg_pipe_valid`` ([0, 1]) must be equal, the parameters within a
    scaled delta of 1e-4.  (Seed 19's round-1 training sits at a near-tie
    of the CNN (a max-pool window or a ReLU): sums in another order move
    one weight, node 4's 603rd, by a discrete 8.65e-5 on the card in some
    calls, and so does a 3e-8 relative perturbation of the round's start on
    the CPU, in 3 of 8 draws; PERF.md, section 6.)"""
    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.attacks import ATTACKS
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.topology.generators import create_topology

    n, offsets = 16, [1, 2, 14, 15]
    adj = create_topology("k-regular", n, k=4).mask()
    for circulant in (False, True):
        kw = {"num_compromised": 1, "max_candidates": len(offsets) + 1}
        if circulant:
            kw["exchange_offsets"] = offsets
        deltas, unequal, valid = [], [], []
        for seed in ROUND_SEEDS:
            model, data, init, draws = _round_inputs(n, seed, False)
            out = {}
            for dev in (device, "cpu"):
                attack = ATTACKS["gaussian"](n, 0.2, seed=seed, noise_std=10.0)
                prog = build_round_program(
                    model, build_aggregator("krum", kw), data, attack=attack, local_epochs=1,
                    batch_size=16, lr=0.05, seed=seed, device=dev, init_params=init,
                    pipeline=True)
                comp = torch.as_tensor(attack.compromised.astype(np.float32)).to(dev)
                flat, state, rows = prog.init_flat, dict(prog.init_agg_state), []
                for r in range(2):
                    noise = np.random.default_rng(seed + 1 + r).normal(
                        size=(int(attack.compromised.sum()), prog.model_dim)).astype(np.float32)
                    flat, state, metrics = prog.train_step(
                        flat, state, torch.as_tensor(adj).to(dev), comp, float(r),
                        draws={**draws, "noise": noise})
                    rows.append((flat.cpu().double(), metrics["agg_selected_index"].cpu(),
                                 float(metrics["agg_pipe_valid"])))
                out[dev] = rows
            for r, ((f_card, sel_card, v_card), (f_cpu, sel_cpu, v_cpu)) in enumerate(
                    zip(out[device], out["cpu"])):
                deltas.append(float((f_card - f_cpu).abs().max()
                                    / max(1.0, float(f_cpu.abs().max()))))
                if not torch.equal(sel_card, sel_cpu):
                    unequal.append(f"seed {seed} round {r}")
                valid.append((v_card, v_cpu) == (float(r), float(r)))
        ok = max(deltas) <= 1e-4 and not unequal and all(valid)
        label = "circulant" if circulant else "dense"
        print(f"[round] krum {label}, pipelined, two chained rounds, tiny CNN, gaussian attack, "
              f"card vs CPU, seeds {list(ROUND_SEEDS)}: scaled param delta by seed and round "
              f"{', '.join(f'{d:.3g}' for d in deltas)} (largest {max(deltas):.3g}, limit "
              f"1e-4); agg_selected_index "
              + ("== CPU every round" if not unequal else f"differs: {', '.join(unequal)}")
              + f"; agg_pipe_valid [0, 1] on both: {all(valid)}: {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            raise AssertionError(f"a pipelined krum {label} round on the card disagrees with "
                                 "the CPU")


# Phase 3b's sparse rows: every rule under the [k, N] edge mask of the
# exponential graph of 16 nodes (offsets 1, 2, 4, 8): (rule, params, on the
# evidential wearable MLP).
SPARSE_OFFSETS = (1, 2, 4, 8)
SPARSE_RULES = [
    ("krum", {"num_compromised": 1}, False),
    ("fedavg", {}, False),
    ("median", {}, False),
    ("trimmed_mean", {"trim_ratio": 0.2}, False),
    ("geometric_median", {}, False),
    ("balance", {}, False),
    ("sketchguard", {}, False),
    ("ubar", {"rho": 0.8}, False),
    ("evidential_trust", {"trust_threshold": 0.1}, True),
]


def check_sparse_rounds_against_cpu(device: str = "cuda") -> None:
    """Phase 3b, the sparse exchange: one round of every rule on the card and
    on the CPU from the same initial parameters and injected draws (16
    nodes, the tiny CNN, or the evidential wearable MLP for evidential
    trust; 20% gaussian std 10), under two [k, N] edge masks of the
    exponential graph: all edges but one (node 7's broadcast to node 5
    dropped), and one_peer's round 1 (offset 2 alone), on two of
    ROUND_SEEDS.  The rule's decisions (DECISIONS) must be equal and the
    parameters within a scaled delta of 1e-4."""
    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.attacks import ATTACKS
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.ops.flatten import model_dimension
    from murmura_tpu_torch.topology.generators import create_topology

    n = 16
    dropped = create_topology("exponential", n).edge_mask(0)
    dropped[SPARSE_OFFSETS.index(2), 5] = 0.0  # receiver 5 from sender 7
    masks = {"exponential, edge 7 -> 5 dropped": dropped,
             "one_peer round 1": create_topology("one_peer", n).edge_mask(1)}
    seeds = ROUND_SEEDS[:2]
    inputs = {}
    for rule, params, wearable in SPARSE_RULES:
        kw = dict(params, exchange_offsets=list(SPARSE_OFFSETS), sparse_exchange=True)
        for mask_label, mask in masks.items():
            deltas, unequal, finite = [], [], True
            for seed in seeds:
                if (seed, wearable) not in inputs:
                    inputs[seed, wearable] = _round_inputs(n, seed, wearable)
                model, data, init, draws = inputs[seed, wearable]
                dim = model_dimension(model.init(torch.Generator().manual_seed(0), "cpu"))
                out = {}
                for dev in (device, "cpu"):
                    attack = ATTACKS["gaussian"](n, 0.2, seed=seed, noise_std=10.0)
                    prog = build_round_program(
                        model, build_aggregator(rule, kw, model_dim=dim), data, attack=attack,
                        local_epochs=1, batch_size=16, lr=0.05, seed=seed, device=dev,
                        init_params=init, sparse_offsets=SPARSE_OFFSETS)
                    noise = np.random.default_rng(seed + 1).normal(
                        size=(int(attack.compromised.sum()), prog.model_dim)).astype(np.float32)
                    comp = torch.as_tensor(attack.compromised.astype(np.float32)).to(dev)
                    flat, _, metrics = prog.train_step(
                        prog.init_flat, dict(prog.init_agg_state), torch.as_tensor(mask).to(dev),
                        comp, 0.0, draws={**draws, "noise": noise})
                    out[dev] = (flat.cpu().double(), {k: v.cpu() for k, v in metrics.items()})
                (f_card, m_card), (f_cpu, m_cpu) = out[device], out["cpu"]
                finite = finite and bool(torch.isfinite(f_card).all())
                deltas.append(float((f_card - f_cpu).abs().max()
                                    / max(1.0, float(f_cpu.abs().max()))))
                unequal += [f"{k} (seed {seed})" for k in DECISIONS[rule]
                            if not torch.equal(m_card[f"agg_{k}"], m_cpu[f"agg_{k}"])]
            ok = max(deltas) <= 1e-4 and not unequal and finite
            print(f"[round] {rule} sparse ({mask_label}), "
                  f"{'wearable MLP' if wearable else 'tiny CNN'}, gaussian attack, card vs CPU, "
                  f"seeds {list(seeds)}: scaled param delta {', '.join(f'{d:.3g}' for d in deltas)}"
                  f" (limit 1e-4); {', '.join(DECISIONS[rule])} "
                  + ("== CPU on every seed" if not unequal else f"differ: {', '.join(unequal)}")
                  + f": {'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                raise AssertionError(f"a sparse {rule} round on the card disagrees with the CPU")


# Phase 3c's rounds: (rule, exchange, params, {kernel: launches}, spread[,
# config sections: "compression", or "faults" naming the config whose
# faults: section to take]).  The exchange "exponential" runs the rule on
# the exponential graph (the sparse [k, N] edge-mask exchange).
# Krum with num_compromised 1 selects (c < (m - 2) / 2 at m = 5).  spread:
# the nodes start from one model plus offsets of distinct scales, so that
# the decisions are exact; the one row without it starts from the nodes'
# own initialisations, as every 64-node config does, and is held by
# krum_tie_check.
N64_RULES = [
    ("median", "ppermute", {}, {"candidate_select": 1}, True),
    ("trimmed_mean", "ppermute", {"trim_ratio": 0.2}, {"candidate_select": 1}, True),
    ("krum", "allgather", {"num_compromised": 1}, {"pairwise_sq_distances": 2}, True),
    ("krum", "allgather", {"num_compromised": 1}, {"pairwise_sq_distances": 2}, False),
    ("krum", "ppermute", {"num_compromised": 1}, {"circulant_sq_distances": 2}, True),
    ("geometric_median", "allgather", {}, {"pairwise_sq_distances": 9}, True),
    ("geometric_median", "ppermute", {}, {"circulant_sq_distances": 9}, True),
    ("balance", "allgather", {}, {"pairwise_sq_distances": 1}, True),
    ("balance", "ppermute", {}, {"circulant_sq_distances": 1}, True),
    ("ubar", "allgather", {}, {"pairwise_sq_distances": 1}, True),
    ("ubar", "ppermute", {}, {"circulant_sq_distances": 1}, True),
    ("sketchguard", "allgather", {}, {"count_sketch": 2, "pairwise_sq_distances": 1}, True),
    ("sketchguard", "ppermute", {}, {"count_sketch": 2, "pairwise_sq_distances": 1}, True),
    ("fedavg", "allgather", {}, {}, True),
    # On the evidential wearable MLP (UCI HAR widths, dropout 0.3), the
    # trust threshold of uci_har_evidential_trust.yaml.
    ("evidential_trust", "allgather", {"trust_threshold": 0.1}, {}, True),
    ("evidential_trust", "ppermute", {"trust_threshold": 0.1}, {}, True),
    # int8 with error feedback (the rule gets the float32 dequantization,
    # own stays bfloat16), and chaos_churn.yaml's fault model.
    ("krum", "ppermute", {"num_compromised": 1}, {"circulant_sq_distances": 2}, True,
     {"compression": INT8_EF}),
    ("median", "ppermute", {}, {"candidate_select": 1}, True, {"compression": INT8_EF}),
    ("krum", "allgather", {"num_compromised": 1}, {"pairwise_sq_distances": 2}, True,
     {"faults": "chaos_churn"}),
    # The sparse exchange: every rule on the exponential graph of 64 nodes
    # (k = 6), the [k, N] edge mask all ones.  The median and the trimmed
    # mean take the masked stack in plain tensor code (no kernel), as the
    # JAX package does.
    ("krum", "exponential", {"num_compromised": 1}, {"circulant_sq_distances": 2}, True),
    ("geometric_median", "exponential", {}, {"circulant_sq_distances": 9}, True),
    ("balance", "exponential", {}, {"circulant_sq_distances": 1}, True),
    ("ubar", "exponential", {}, {"circulant_sq_distances": 1}, True),
    ("sketchguard", "exponential", {}, {"count_sketch": 2, "circulant_sq_distances": 1}, True),
    ("median", "exponential", {}, {}, True),
    ("trimmed_mean", "exponential", {"trim_ratio": 0.2}, {}, True),
    ("fedavg", "exponential", {}, {}, True),
    ("evidential_trust", "exponential", {"trust_threshold": 0.1}, {}, True),
]
# The stats that are decisions: equal between the card and the CPU.
DECISIONS = {
    "krum": ("selected_index", "selected_own"),
    "median": ("num_candidates",),
    "trimmed_mean": ("num_candidates", "trimmed_per_side"),
    "geometric_median": ("num_candidates",),
    "balance": ("acceptance_rate",),
    "sketchguard": ("acceptance_rate",),
    "ubar": ("stage1_acceptance_rate", "stage2_acceptance_rate"),
    "fedavg": ("num_neighbors",),
    "evidential_trust": ("acceptance_rate",),
}


# Phase 3b's adaptive rows: (label, rule, params, sparse offsets or None).
# The bisection around the gaussian attack (std 10), 40% compromised.
ADAPTIVE_RULES = [
    ("krum dense", "krum", {"num_compromised": 1}, None),
    ("krum circulant", "krum", {"num_compromised": 1, "exchange_offsets": [1, 2, 14, 15]}, None),
    ("krum sparse exponential", "krum",
     {"num_compromised": 1, "exchange_offsets": list(SPARSE_OFFSETS), "sparse_exchange": True},
     SPARSE_OFFSETS),
    ("balance dense", "balance", {}, None),
]
ADAPTIVE_ROUNDS = 3


def check_adaptive_against_cpu(device: str = "cuda") -> None:
    """Phase 3b, adaptive attacks: three chained rounds on the card and on
    the CPU, the tiny CNN, 16 nodes, the bisection around the gaussian
    attack (std 10, 40% compromised), for each ADAPTIVE_RULES row on two
    of ROUND_SEEDS.  Each device carries its own attack state from round
    to round (the closed loop under test); each round takes the same
    injected draws (its own attack noise) and starts both devices from the
    same parameters: round 0 from the spread initial state, round r from
    the CPU's round r-1 output plus fresh offsets of distinct scales.
    (Without the offsets, nodes that copied one Krum winner train into
    near-copies whose dense scores tie within the Gram identity's float32
    cancellation, which the std-10 rows inflate: the card then picks the
    other near-copy, as PERF.md section 2 says.)  Every round the picks
    (Krum's selection, BALANCE's ``tap_selected_by``) must be equal,
    ``atk_scale``, ``atk_lo`` and ``atk_hi`` bit-equal, ``atk_accept_ema``
    within rtol 1e-6 (the card may fuse its multiply-add), the parameters
    within a scaled 1e-4 plus the scaled delta of the round's trained rows
    alone (``train_flat`` on both devices): Krum copies a candidate row and
    BALANCE takes a convex combination of candidates, so the rule adds
    nothing to a training difference.  (The tiny CNN's training can sit at
    a near-tie, a max-pool window or a ReLU, where another summation order
    moves one node's weights by a discrete step: on an H100, seed 7's
    round 1 moved node 2 by 8.6e-4 scaled, everything else by under 1e-7;
    PERF.md, section 6.)  Then adaptive ALIE (omniscient) on the dense
    geometric median, which has no taps: the attacker escalates blind, and
    its ``atk_z`` must be equal on both devices (the parameters' delta
    printed, the median's derived bound of section 2 not gated here)."""
    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.attacks import ATTACKS
    from murmura_tpu_torch.attacks.adaptive import (
        make_adaptive_alie_attack,
        make_bisection_attack,
    )
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.topology.generators import create_topology

    n = 16
    dense_adj = create_topology("k-regular", n, k=4).mask().astype(np.float32)
    seeds = ROUND_SEEDS[:2]
    inputs = {seed: _round_inputs(n, seed, False) for seed in seeds}
    spread = 0.02 * (1.0 + np.arange(n) / n)

    def lockstep(rule, kw, offsets, make_attack, seed):
        """Per round: (card (flat, picks, state), CPU (flat, picks, state))."""
        model, data, init, draws = inputs[seed]
        progs, comps, states = {}, {}, {}
        for dev in (device, "cpu"):
            attack = make_attack(seed)
            progs[dev] = build_round_program(
                model, build_aggregator(rule, kw), data, attack=attack, local_epochs=1,
                batch_size=16, lr=0.05, seed=seed, device=dev, init_params=init,
                sparse_offsets=offsets)
            comps[dev] = torch.as_tensor(attack.compromised.astype(np.float32)).to(dev)
            states[dev] = dict(progs[dev].init_agg_state)
        comp = attack.compromised
        adj = np.ones((len(offsets), n), np.float32) if offsets else dense_adj
        start, rows = progs["cpu"].init_flat.clone(), []
        for r in range(ADAPTIVE_ROUNDS):
            rng = np.random.default_rng(seed + 1 + r)
            noise = rng.normal(size=(int(comp.sum()), progs["cpu"].model_dim)).astype(np.float32)
            if r:
                start = start + torch.as_tensor(
                    (spread[:, None] * rng.normal(size=tuple(start.shape))).astype(np.float32))
            out = {}
            for dev in (device, "cpu"):
                trained, _ = progs[dev].train_flat(
                    start.to(dev), states[dev], torch.as_tensor(adj).to(dev), comps[dev],
                    float(r), draws={**draws, "noise": noise})
                flat, states[dev], metrics = progs[dev].train_step(
                    start.to(dev), states[dev], torch.as_tensor(adj).to(dev), comps[dev],
                    float(r), draws={**draws, "noise": noise})
                picks = metrics.get("agg_selected_index", metrics.get("agg_tap_selected_by"))
                out[dev] = (flat.cpu().double(), None if picks is None else picks.cpu(),
                            {k: v.cpu()[comp] for k, v in states[dev].items()
                             if k.startswith("atk_")}, trained.cpu().double())
            start = out["cpu"][0].float()
            rows.append((out[device], out["cpu"]))
        return rows

    def bisection(seed):
        return make_bisection_attack(ATTACKS["gaussian"](n, 0.4, seed=seed, noise_std=10.0))

    for label, rule, kw, offsets in ADAPTIVE_RULES:
        deltas, unequal, ema_rel, where, over = [], [], 0.0, [], []
        for seed in seeds:
            rows = lockstep(rule, kw, offsets, bisection, seed)
            for r, ((f_card, p_card, s_card, t_card), (f_cpu, p_cpu, s_cpu, t_cpu)) in enumerate(
                    rows):
                deltas.append(float((f_card - f_cpu).abs().max()
                                    / max(1.0, float(f_cpu.abs().max()))))
                trained = float((t_card - t_cpu).abs().max() / max(1.0, float(t_cpu.abs().max())))
                if deltas[-1] > 1e-4 + trained:
                    over.append(f"seed {seed} round {r}")
                if deltas[-1] > 1e-4:
                    node = int((f_card - f_cpu).abs().amax(dim=1).argmax())
                    where.append(f"seed {seed} round {r} node {node}: {deltas[-1]:.3g} "
                                 f"(training alone {trained:.3g})")
                if not torch.equal(p_card, p_cpu):
                    unequal.append(f"seed {seed} round {r} picks")
                for k in ("atk_scale", "atk_lo", "atk_hi"):
                    if not torch.equal(s_card[k], s_cpu[k]):
                        unequal.append(f"seed {seed} round {r} {k}")
                ema = s_cpu["atk_accept_ema"].double()
                rel = float(((s_card["atk_accept_ema"].double() - ema).abs()
                             / ema.abs().clamp(min=1e-30)).max())
                ema_rel = max(ema_rel, rel)
        last = rows[-1][0][2]
        ok = not over and not unequal and ema_rel <= 1e-6
        print(f"[round] {label}, adaptive (bisection around gaussian std 10, 40%), "
              f"{ADAPTIVE_ROUNDS} chained rounds, tiny CNN, card vs CPU, seeds {list(seeds)}: "
              f"scaled param delta largest {max(deltas):.3g} (limit 1e-4 plus the trained rows' "
              f"delta; over 1e-4: {'; '.join(where) or 'none'}); picks and "
              "atk_scale/lo/hi " + ("equal every round" if not unequal
                                    else f"differ: {', '.join(unequal)}")
              + f"; atk_accept_ema rel {ema_rel:.3g} (limit 1e-6); seed {seeds[-1]}'s last "
              f"atk_scale / atk_lo / atk_hi of the compromised rows "
              f"{sorted(set(last['atk_scale'].tolist()))} / {sorted(set(last['atk_lo'].tolist()))}"
              f" / {sorted(set(last['atk_hi'].tolist()))}: {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            raise AssertionError(f"an adaptive {label} round on the card disagrees with the CPU")

    def alie(seed):
        return make_adaptive_alie_attack(n, 0.4, seed=seed)

    zs, deltas = [], []
    for seed in seeds:
        rows = lockstep("geometric_median", {}, None, alie, seed)
        for (f_card, _, s_card, _), (f_cpu, _, s_cpu, _) in rows:
            zs.append(torch.equal(s_card["atk_z"], s_cpu["atk_z"]))
            deltas.append(float((f_card - f_cpu).abs().max() / max(1.0, float(f_cpu.abs().max()))))
    z_last = sorted(set(rows[-1][0][2]["atk_z"].tolist()))
    print(f"[round] geometric_median dense, adaptive ALIE (no taps: blind escalation), "
          f"{ADAPTIVE_ROUNDS} chained rounds, card vs CPU, seeds {list(seeds)}: atk_z equal "
          f"every round {all(zs)} (the compromised rows' last {z_last}); scaled param delta "
          f"largest {max(deltas):.3g} (the dense geometric median's derived bound, section 2 "
          f"of PERF.md): {'ok' if all(zs) else 'FAILED'}", flush=True)
    if not all(zs):
        raise AssertionError("adaptive ALIE's z differs between the card and the CPU")


def bf16_roundings(rule: str, circulant: bool, alpha: float = 0.5) -> float:
    """r of the bfloat16 output bound |card - CPU| <= r 2^-7 m (PERF.md
    section 2): the bfloat16 roundings, weighted, that the output passes
    through after the first float32 sum whose order differs between the
    card and the CPU.  Krum copies a row and the candidate kernel is
    bit-equal: 0.  fedavg rounds its mean once: 1.  BALANCE, Sketchguard,
    UBAR and evidential trust round the neighbour mean, (1 - alpha) times it
    and the blend: 3 + 2 alpha relative to max(|out|, |own|) (evidential
    trust adds trust_weight_term).  The geometric median rounds
    each of its 9 weighted means once (dense) or twice (circulant)."""
    if rule in ("krum", "median", "trimmed_mean"):
        return 0.0
    if rule == "fedavg":
        return 1.0
    if rule == "geometric_median":
        return 9.0 * (2 if circulant else 1)
    return 3.0 + 2.0 * alpha


def trust_weight_term(state_card, state_cpu, threshold, adj, bcast, bf16_weights: bool,
                      alpha: float = 0.5):
    """[N, P] addition to evidential trust's bfloat16 output bound for the
    trust weights themselves, which the card and the CPU take from their own
    probe forwards: w_ij = trust_ij on the accepted edges (the carried trust
    of a first round), cast to bfloat16 on the dense path, which normalises
    by the cast weights.  A weight moved by dw_ij moves the neighbour mean
    by sum_j dw_ij (b_j - mean_i) / W_i, at most 2 (sum_j |dw_ij| / W_i)
    max_{j accepted} |b_j| (the mean is a convex combination; first order),
    and the output by (1 - alpha) times that.  Zero where the two devices'
    weights are equal.  Returns (term, max |dw|)."""
    import torch

    def weights(state):
        trust = state["smoothed_trust"].cpu()
        w = torch.where((trust >= threshold) & (adj.cpu() > 0), trust, 0.0)
        return w.to(torch.bfloat16).float() if bf16_weights else w

    w_card, w_cpu = weights(state_card), weights(state_cpu)
    dw = (w_card - w_cpu).abs()
    b = bcast.cpu().float().abs()
    term = torch.zeros_like(b)
    if float(dw.max()) == 0.0:
        return term, 0.0
    total = torch.clamp(w_cpu.sum(dim=1), min=1e-12)
    for i in torch.nonzero(dw.sum(dim=1) > 0)[:, 0].tolist():
        acc = (w_cpu[i] > 0) | (w_card[i] > 0)
        term[i] = (1.0 - alpha) * 2.0 * float(dw[i].sum() / total[i]) * b[acc].max(dim=0).values
    return term, float(dw.max())


def _kernel_fns():
    """{kernel: (module, name of the kernel wrapper, its plain version)}."""
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    return {
        "pairwise_sq_distances": (agg_kernels, "pairwise_sq_distances",
                                  "pairwise_sq_distances_plain"),
        "circulant_sq_distances": (agg_kernels, "circulant_sq_distances",
                                   "circulant_sq_distances_plain"),
        "candidate_select": (candidate_kernels, "candidate_select", "candidate_select_plain"),
        "count_sketch": (sketch_kernels, "count_sketch", "count_sketch_plain"),
    }


def _within_kernel_limit(name, args, kwargs, got, ref):
    """(ok, max |got - ref|) under the kernel's limit of PERF.md section 2."""
    import torch

    err = (got.float() - ref.float()).abs()
    if name == "pairwise_sq_distances":
        a = args[0].float()
        b = a if len(args) < 2 or args[1] is None else args[1].float()
        c = kwargs.get("center")
        c = torch.zeros_like(a[0]) if c is None else c
        limit = 1e-5 * (((a - c) ** 2).sum(-1)[:, None] + ((b - c) ** 2).sum(-1)[None, :])
    elif name == "circulant_sq_distances":
        limit = 1e-5 * torch.clamp(ref.abs(), min=1.0)
    elif name == "count_sketch":
        v, tables = args
        h = tables.plain_on(v.device)["hash"]
        limit = 1e-4 * torch.zeros_like(ref).index_add_(1, h, v.abs())
    else:
        limit = torch.zeros_like(err)
    return bool((err <= limit).all()) and bool(torch.isfinite(got).all()), float(err.max())


def krum_tie_check(own, bcast, adj, c: int, selected, new, eps: float = 1e-5):
    """Phase 3c's check of a dense Krum round whose scores may tie to within
    the Gram identity's float32 noise (nodes from their own
    initialisations).  Per node, every candidate's exact score s (float64,
    from the bfloat16 states) is recomputed on the CPU.  A float32 squared
    distance within the pairwise kernel's limit dD2 = eps (|x - mu|^2 +
    |y - mu|^2) of the exact one (mu the mean the call centres on: own's
    for the self candidate's distances, bcast's for the others) moves the
    distance by e = min(sqrt(dD2), dD2 / d) and a score by E_a = (m - c -
    2) max_b e_ab.  A device's pick j must then satisfy s_j - min s <= E_j
    + E_argmin, and its output row must be the picked candidate's row, bit
    for bit.  Returns (ok, largest gap / its tolerance, nodes where the
    pick is not the exact argmin)."""
    import torch

    from murmura_tpu_torch.aggregation.base import candidate_indices

    own, bcast, adj = own.cpu(), bcast.cpu(), adj.cpu()
    selected, new = selected.cpu(), new.cpu()
    n = own.shape[0]
    o64, b64 = own.double(), bcast.double()
    c_own, c_b = o64.mean(dim=0), b64.mean(dim=0)
    ci, cv = candidate_indices(adj, n)
    ok, worst, off_argmin = True, 0.0, 0
    for i in range(n):
        idx = ci[i][cv[i]]
        rows = torch.stack([o64[i] if j == i else b64[j] for j in idx.tolist()])
        is_self = idx == i
        m = len(idx)
        d = torch.cdist(rows, rows)
        r2 = ((rows - c_b) ** 2).sum(-1)
        r2_own = ((rows - c_own) ** 2).sum(-1)
        # A pair's distance comes from the own-centred call when either end
        # is the self candidate, else from the bcast-centred call.
        pair_self = is_self[:, None] | is_self[None, :]
        dd2 = eps * torch.where(pair_self, r2_own[:, None] + r2_own[None, :],
                                r2[:, None] + r2[None, :])
        e = torch.minimum(dd2.sqrt(), dd2 / torch.clamp(d, min=1e-300))
        eye = torch.eye(m, dtype=torch.bool)
        take = max(1, m - c - 2)
        s = torch.sort(d.masked_fill(eye, float("inf")), dim=1).values[:, :take].sum(1)
        big_e = take * e.masked_fill(eye, 0.0).max(dim=1).values
        pick = int((idx == int(selected[i])).nonzero()[0, 0])
        best = int(torch.argmin(s))
        tol = float(big_e[pick] + big_e[best])
        gap = float(s[pick] - s[best])
        want = own[i] if int(selected[i]) == i else bcast[int(selected[i])]
        ok = ok and gap <= tol and torch.equal(new[i], want)
        worst = max(worst, gap / tol if tol > 0 else (0.0 if gap == 0 else float("inf")))
        off_argmin += pick != best
    return ok, worst, off_argmin


def check_round_n64_bf16() -> dict:
    """Phase 3c: one tiny-CNN round at 64 nodes, k-regular(4), parameters in
    the dtype the configs take by default from 64 nodes up (bfloat16), for
    every ported rule in the exchanges of N64_RULES, through ``cli.run``.
    The counters are set to 0 just before each run and read just after; the
    inputs of every kernel launch and of the rule are kept.  Afterwards each
    kernel call is held against its plain version on those inputs, within
    the kernel's limit, and the rule runs again on the CPU on the kept
    (own, bcast, adj): its decisions must equal the card's, and its
    output must lie within |card - CPU| <= r 2^-7 m element by element
    (bf16_roundings; m = max(|CPU out|, |own|), or for the geometric median
    the largest |value| among the node's candidates).  The nodes start from
    one common model plus offsets of distinct scales, as in phase 3b, except
    on the one Krum row that starts them from their own initialisations as
    the configs do: there Krum's scores tie to within the Gram identity's
    float32 noise, either device may pick either of the tied nodes, and
    krum_tie_check holds each pick within that noise of the exact best.
    Evidential trust takes its weights from each device's own probe
    forwards, so its bound adds trust_weight_term."""
    import dataclasses

    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch import cli
    from murmura_tpu_torch.aggregation.base import candidate_indices
    from murmura_tpu_torch.core import rounds
    from murmura_tpu_torch.ops.flatten import tree_map
    from murmura_tpu_torch.utils import factories

    def spread_init(model, n, seed, device):
        g = torch.Generator(device=device).manual_seed(int(seed))
        template = model.init(g, device)
        scale = 0.02 * (1.0 + torch.arange(n, device=device) / n)
        return tree_map(lambda t: t[None] + scale.reshape((n,) + (1,) * t.dim()) * torch.randn(
            (n,) + tuple(t.shape), generator=g, device=device), template)

    mods = _kernel_modules()
    fns = _kernel_fns()
    runs = {}
    for rule, exchange, params, expect, spread, *extra in N64_RULES:
        sections = extra[0] if extra else {}
        tag = (f"{rule}:{exchange}:n64-bf16" + ("" if spread else "-own-init")
               + "".join(f"-{k}" for k in sections))
        sparse = exchange == "exponential"
        cfg = {
            "experiment": {"name": f"n64-{rule}", "seed": 5, "rounds": 1, "verbose": False},
            "topology": ({"type": "exponential", "num_nodes": 64} if sparse
                         else {"type": "k-regular", "num_nodes": 64, "k": 4}),
            "aggregation": {"algorithm": rule, "params": params},
            "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2,
                       "params": {"noise_std": 10.0}},
            "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.02},
            "data": {"adapter": "leaf.femnist", "params": {"num_samples": 64 * 40}},
            "model": {"factory": "leaf.femnist.tiny", "params": {}},
            "backend": "tpu",
            "tpu": {"exchange": "ppermute" if sparse else exchange, "compute_dtype": "bfloat16"},
        }
        if "compression" in sections:
            cfg["compression"] = dict(sections["compression"])
        if "faults" in sections:
            cfg["faults"] = config_section(sections["faults"], "faults")
        if rule == "evidential_trust":
            # Trust reads Dirichlet outputs: the evidential wearable MLP.
            cfg["data"] = {"adapter": "wearables.uci_har", "params": {"num_samples": 64 * 40}}
            cfg["model"] = {"factory": "wearables.uci_har", "params": {}}
        SMOKE_DIR.mkdir(parents=True, exist_ok=True)
        path = SMOKE_DIR / f"{tag.replace(':', '_')}.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        calls, rule_calls = [], []
        real_build = factories.build_aggregator

        def build(name, agg_params, model_dim=0):
            agg = real_build(name, agg_params, model_dim=model_dim)

            def aggregate(own, bcast, adj, round_idx, state, ctx):
                kept = (own.clone(), bcast.clone(), adj.clone(), round_idx,
                        {k: v.clone() for k, v in state.items()}, ctx)
                new, new_state, stats = agg.aggregate(own, bcast, adj, round_idx, state, ctx)
                rule_calls.append((agg, kept, new.clone(), {k: v.clone() for k, v in stats.items()},
                                   {k: v.clone() for k, v in new_state.items()}))
                return new, new_state, stats

            return dataclasses.replace(agg, aggregate=aggregate)

        factories.build_aggregator = build
        real_init = rounds.init_stacked_params
        if spread:
            rounds.init_stacked_params = spread_init
        try:
            with contextlib.ExitStack() as stack:
                for k, (mod, attr, _) in fns.items():
                    stack.enter_context(kept_calls(mod, attr, calls, tag=k))
                for mod in mods:
                    mod.reset_counts()
                _, network = cli.run(
                    path, output=SMOKE_DIR / f"history_{tag.replace(':', '_')}.json", device="cuda")
                torch.cuda.synchronize()
                launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
                plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
        finally:
            factories.build_aggregator = real_build
            rounds.init_stacked_params = real_init
        # Every kernel call against its plain version on its own inputs.
        kernel_errs, kernels_ok = {}, True
        for name, args, kwargs in calls:
            mod, attr, plain_attr = fns[name]
            got = getattr(mod, attr)(*args, **kwargs)
            ref = getattr(mod, plain_attr)(*args, **kwargs)
            ok_k, err = _within_kernel_limit(name, args, kwargs, got, ref)
            kernels_ok = kernels_ok and ok_k
            kernel_errs[name] = max(kernel_errs.get(name, 0.0), err)
            del got, ref
        # The rule again on the CPU on the kept inputs.
        (agg, (own, bcast, adj, round_idx, state, ctx), new_card, stats_card,
         state_card) = rule_calls[0]
        if ctx.probe_x is not None:
            ctx = dataclasses.replace(ctx, probe_x=ctx.probe_x.cpu(), probe_y=ctx.probe_y.cpu(),
                                      probe_mask=ctx.probe_mask.cpu())
        new_cpu, state_cpu, stats_cpu = agg.aggregate(
            own.cpu(), bcast.cpu(), adj.cpu(), round_idx, {k: v.cpu() for k, v in state.items()},
            ctx)
        decisions = DECISIONS[rule] if spread else ()
        unequal = [k for k in decisions if not torch.equal(stats_card[k].cpu(), stats_cpu[k])]
        r = bf16_roundings(rule, exchange != "allgather")
        cpu32, card32 = new_cpu.float(), new_card.cpu().float()
        offsets = network.program.sparse_offsets
        if rule == "geometric_median":
            if sparse:
                cand = torch.stack([own.cpu()] + [torch.roll(bcast.cpu(), -o, 0)
                                                  for o in offsets], dim=1)
            else:
                ci, _ = candidate_indices(adj.cpu(), 5)
                cand = torch.cat([own.cpu()[:, None], bcast.cpu()[ci[:, 1:]]], dim=1)
            mag = cand.float().abs().max(dim=1).values
            del cand
        else:
            mag = torch.maximum(cpu32.abs(), own.cpu().float().abs())
        diff = (card32 - cpu32).abs()
        extra, trust_note = 0.0, ""
        if rule == "evidential_trust":
            edges = adj
            if sparse:
                # The edge mask as the dense [receiver, sender] matrix.
                edges = torch.zeros((64, 64))
                ar = torch.arange(64)
                for j, o in enumerate(offsets):
                    edges[ar, (ar + o) % 64] = adj.cpu()[j].float()
            extra, dw = trust_weight_term(state_card, state_cpu, float(stats_cpu["threshold"][0]),
                                          edges, bcast, bf16_weights=exchange == "allgather")
            trust_rel = float(((state_card["smoothed_trust"].cpu() - state_cpu["smoothed_trust"])
                               .abs() / state_cpu["smoothed_trust"].abs().clamp(min=1e-30)).max())
            trust_note = (f"; trust card vs CPU max rel {trust_rel:.3g}, weights' max |card - "
                          f"CPU| {dw:.3g} (trust_weight_term, {int((extra > 0).any(1).sum())} "
                          f"node(s) with a weight term)")
        if spread:
            limit = r * 2.0 ** -7 * mag + extra
            out_ok = bool((diff <= limit).all())
            slack = float((diff / torch.clamp(limit, min=1e-30)).max()) if r else 0.0
            held = (f"decisions {list(decisions)} "
                    f"{'== CPU' if not unequal else f'differ: {unequal}'}; output max "
                    f"|card - CPU| {float(diff.max()):.3g}, bound r 2^-7 m with r {r:g}, "
                    f"largest share of the bound {slack:.3g}{trust_note}")
        else:
            # Both devices' picks are held to the exact scores.
            held = []
            out_ok = True
            for who, sel, out in (("card", stats_card["selected_index"], new_card),
                                  ("CPU", stats_cpu["selected_index"], new_cpu)):
                ok_w, share, off_argmin = krum_tie_check(
                    own, bcast, adj, params["num_compromised"], sel, out)
                out_ok = out_ok and ok_w
                held.append(f"{who} {'ok' if ok_w else 'FAILED'} (largest share of the "
                            f"tolerance {share:.3g}, {off_argmin} node(s) off the exact argmin)")
            picks_differ = int((stats_card["selected_index"].cpu()
                                != stats_cpu["selected_index"]).sum())
            held = (f"own initialisations: each pick within the kernel limit's score noise "
                    f"of the exact best and its row copied bit for bit: {', '.join(held)}; "
                    f"card and CPU picked differently on {picks_differ} node(s)")
        counts_ok = (all(launches[k] == v for k, v in expect.items())
                     and all(v == 0 for k, v in launches.items() if k not in expect)
                     and not any(plain.values()))
        finite = bool(torch.isfinite(network.flat).all())
        ok = (counts_ok and kernels_ok and not unequal and out_ok and finite
              and network.flat.dtype == torch.bfloat16 and len(rule_calls) == 1)
        loss_note = ""
        if "own_loss" in stats_card:
            rel = (stats_card["own_loss"].cpu() - stats_cpu["own_loss"]).abs() / stats_cpu["own_loss"]
            loss_note = f"; own_loss card vs CPU max rel {float(rel.max()):.3g} (not gated)"
        what = "wearable MLP" if rule == "evidential_trust" else "tiny CNN"
        print(f"[round64] {tag}: {what}, 64 nodes, parameters "
              f"{str(network.flat.dtype).replace('torch.', '')}; launches {launches} (want "
              f"{expect}), plain-version calls {plain}; {len(calls)} kernel call(s) against "
              f"their plain versions on the round's inputs, max err {kernel_errs}: "
              f"{'within limits' if kernels_ok else 'OUTSIDE LIMITS'}; {held}{loss_note}; "
              f"final parameters finite: "
              f"{finite}; round seconds {[round(t, 4) for t in network.round_times]}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"the 64-node bfloat16 round {tag} failed its checks")
        runs[tag] = {
            "launches": {k: launches[k] for k in expect},
            "s_per_round": list(np.asarray(network.round_times))}
        del network, calls, rule_calls, own, bcast, new_card, new_cpu
        torch.cuda.empty_cache()
    return runs


# Each rule's stats in the history (the JAX package's agg_* keys).
RULE_STATS = {
    "krum": ("selected_index", "krum_score", "selected_own"),
    "median": ("num_candidates",),
    "trimmed_mean": ("num_candidates", "trimmed_per_side"),
    "geometric_median": ("num_candidates", "max_weight_share", "mean_dist_to_gm"),
    "balance": ("acceptance_rate", "threshold"),
    "sketchguard": ("acceptance_rate", "threshold", "compression_ratio"),
    "fedavg": ("num_neighbors",),
    "ubar": ("stage1_acceptance_rate", "stage2_acceptance_rate", "own_loss"),
    "evidential_trust": ("acceptance_rate", "mean_trust", "mean_vacuity", "mean_entropy",
                         "threshold"),
}
# Phase 4's runs: (label, config, exchange, aggregation or None for the
# config's own, {kernel: launches a round, exact or at least}[, options:
# "attack" replacing the config's, "sections" added to it (compression:,
# or faults:, exchange:, telemetry: taken from the named config), "rounds"
# instead of SMOKE_ROUNDS, "profile" (start, rounds) for a profiler window,
# "memory_stats" to sample memory events]).  An exchange runs the config on backend: tpu.  No other
# kernel may launch.
ALIE_20 = {"enabled": True, "type": "alie", "percentage": 0.2, "params": {}}
ADAPTIVE_FLAGSHIP_ROUNDS = 6
# stale_gossip.yaml's lever sections, taken onto the flagship.
STALE_SECTIONS = {"faults": "stale_gossip", "exchange": "stale_gossip",
                  "telemetry": "stale_gossip"}
# pipelined_rounds.yaml's and resumable_run.yaml's lever sections, taken
# onto the flagship.
PIPELINE_SECTIONS = {"exchange": "pipelined_rounds", "tpu": "pipelined_rounds"}
RESUME_SECTIONS = {"durability": "resumable_run", "compression": "resumable_run",
                   "telemetry": "resumable_run"}
# The audit taps each rule adds (telemetry.audit_taps).
RULE_TAPS = {"krum": ("selected_by", "considered_by"),
             "balance": ("selected_by", "considered_by")}
# The four kernels' device-side names, for the trace's split.
KERNEL_SYMBOLS = {
    "pairwise_sq_distances": ("pairwise_kernel", "pairwise_finalize_kernel"),
    "circulant_sq_distances": ("circulant_kernel", "sum_blocks_kernel"),
    "candidate_select": ("staged_kernel", "direct_kernel"),
    "count_sketch": ("sketch_walk_kernel", "sketch_sum_kernel"),
}
MAIN_RUNS = [
    ("krum:allgather", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")}),
    ("krum:ppermute", FLAGSHIP, "ppermute", None, {"circulant_sq_distances": (2, "==")}),
    ("median:ppermute", FLAGSHIP, "ppermute", {"algorithm": "median", "params": {}},
     {"candidate_select": (1, "==")}),
    ("trimmed_mean:ppermute", FLAGSHIP, "ppermute",
     {"algorithm": "trimmed_mean", "params": {"trim_ratio": 0.2}},
     {"candidate_select": (1, "==")}),
    # max_iters 8: 8 Weiszfeld steps and the final weights, 9 distance calls.
    ("geometric_median:allgather", FLAGSHIP, "allgather",
     {"algorithm": "geometric_median", "params": {}}, {"pairwise_sq_distances": (9, "==")}),
    ("geometric_median:ppermute", FLAGSHIP, "ppermute",
     {"algorithm": "geometric_median", "params": {}}, {"circulant_sq_distances": (9, "==")}),
    ("balance:allgather", FLAGSHIP, "allgather", {"algorithm": "balance", "params": {}},
     {"pairwise_sq_distances": (1, "==")}),
    ("balance:ppermute", FLAGSHIP, "ppermute", {"algorithm": "balance", "params": {}},
     {"circulant_sq_distances": (1, "==")}),
    ("sketchguard:allgather", FLAGSHIP, "allgather", {"algorithm": "sketchguard", "params": {}},
     {"count_sketch": (2, "=="), "pairwise_sq_distances": (1, "==")}),
    ("sketchguard:ppermute", FLAGSHIP, "ppermute", {"algorithm": "sketchguard", "params": {}},
     {"count_sketch": (2, "=="), "pairwise_sq_distances": (1, "==")}),
    ("fedavg:basic_fedavg", BASIC_FEDAVG, None, None, {}),
    ("ubar:erdos", UBAR_ATTACK, None, None, {"pairwise_sq_distances": (1, "==")}),
    # rho 0.8 as in ubar_attack.yaml: 3 of the 4 neighbours shortlisted.
    ("ubar:ppermute", FLAGSHIP, "ppermute", {"algorithm": "ubar", "params": {"rho": 0.8}},
     {"circulant_sq_distances": (1, "==")}),
    ("krum:uci_har_byzantine", UCI_HAR_BYZANTINE, None, None,
     {"pairwise_sq_distances": (2, "==")}),
    ("fedavg:uci_har_dirichlet", UCI_HAR_DIRICHLET, None, None, {}),
    ("fedavg:pamap2_dirichlet", PAMAP2_DIRICHLET, None, None, {}),
    ("evidential_trust:uci_har", UCI_HAR_EVIDENTIAL_TRUST, None, None, {}),
    # The fully-connected graph of 10 nodes is the circulant with offsets 1-9.
    ("evidential_trust:ppermute", UCI_HAR_EVIDENTIAL_TRUST, "ppermute", None, {}),
    ("geometric_median:alie", ALIE_GEOMETRIC_MEDIAN, None, None,
     {"pairwise_sq_distances": (9, "==")}),
    ("geometric_median:alie_flagship", FLAGSHIP, "allgather",
     {"algorithm": "geometric_median", "params": {}}, {"pairwise_sq_distances": (9, "==")},
     {"attack": ALIE_20}),
    ("geometric_median:alie_ppermute", FLAGSHIP, "ppermute",
     {"algorithm": "geometric_median", "params": {}}, {"circulant_sq_distances": (9, "==")},
     {"attack": ALIE_20}),
    ("trimmed_mean:label_flip", LABEL_FLIP_POISONING, None, None, {}),
    # m = 10 candidates (own + 9 offsets), trim 3: the kernel's generic path.
    ("trimmed_mean:label_flip_ppermute", LABEL_FLIP_POISONING, "ppermute", None,
     {"candidate_select": (1, "==")}),
    # The fault model and the compressed exchange: the two configs as
    # committed, and the flagship under chaos_churn.yaml's faults: section,
    # under int8 (block 256) and under top-k (ratio 0.05), error feedback on.
    ("krum:chaos_churn", CHAOS_CHURN, None, None, {"pairwise_sq_distances": (2, "==")},
     {"rounds": 5}),
    ("krum:compressed_exchange", COMPRESSED_EXCHANGE, None, None,
     {"pairwise_sq_distances": (2, "==")}),
    ("krum:faults_flagship", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {"sections": {"faults": "chaos_churn"}}),
    ("krum:faults_ppermute", FLAGSHIP, "ppermute", None, {"circulant_sq_distances": (2, "==")},
     {"sections": {"faults": "chaos_churn"}}),
    ("krum:int8_flagship", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {"sections": {"compression": INT8_EF}}),
    ("krum:int8_ppermute", FLAGSHIP, "ppermute", None, {"circulant_sq_distances": (2, "==")},
     {"sections": {"compression": INT8_EF}}),
    ("median:int8_ppermute", FLAGSHIP, "ppermute", {"algorithm": "median", "params": {}},
     {"candidate_select": (1, "==")}, {"sections": {"compression": INT8_EF}}),
    ("krum:topk_flagship", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {"sections": {"compression": TOPK_EF}}),
    # Telemetry and bounded staleness: the two configs as committed, the
    # flagship under stale_gossip.yaml's faults:, exchange: and telemetry:
    # sections (both exchanges) and under telemetry_audit_report.yaml's
    # telemetry: section, and the flagship with a profiler window over
    # rounds 2-3 of 4 (the trace's split of a steady round is printed).
    ("krum:telemetry_audit_report", TELEMETRY_AUDIT_REPORT, None, None,
     {"pairwise_sq_distances": (2, "==")}, {"rounds": 5}),
    ("krum:stale_gossip", STALE_GOSSIP, None, None, {"pairwise_sq_distances": (2, "==")},
     {"rounds": 5}),
    ("krum:stale_flagship", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {"sections": STALE_SECTIONS, "memory_stats": True}),
    ("krum:stale_ppermute", FLAGSHIP, "ppermute", None, {"circulant_sq_distances": (2, "==")},
     {"sections": STALE_SECTIONS, "memory_stats": True}),
    ("krum:telemetry_flagship", FLAGSHIP, "allgather", None,
     {"pairwise_sq_distances": (2, "==")},
     {"rounds": 4, "sections": {"telemetry": "telemetry_audit_report"}}),
    ("krum:profiled_flagship", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {"rounds": 4, "profile": (1, 2)}),
    # Durability and pipelined rounds: the two configs as committed
    # (resumable_run: 30 rounds, a snapshot every 5; pipelined_rounds: 12
    # rounds, tpu.recompile_guard on), the flagship under pipelined_rounds'
    # exchange: and tpu: sections (both exchanges; round 0 aggregates the
    # placeholder buffer through the kernel too), and the flagship fused in
    # chunks of 2 under tpu.transfer_guard.
    ("krum:resumable_run", RESUMABLE_RUN, None, None, {"pairwise_sq_distances": (2, "==")},
     {"rounds": 30}),
    ("krum:pipelined_rounds", PIPELINED_ROUNDS, None, None, {"pairwise_sq_distances": (2, "==")},
     {"rounds": 12}),
    ("krum:pipelined_flagship", FLAGSHIP, "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {"sections": PIPELINE_SECTIONS}),
    ("krum:pipelined_ppermute", FLAGSHIP, "ppermute", None, {"circulant_sq_distances": (2, "==")},
     {"sections": PIPELINE_SECTIONS}),
    ("krum:transfer_guard_fused", FLAGSHIP, "allgather", None,
     {"pairwise_sq_distances": (2, "==")},
     {"rounds": 4, "sections": {"rounds_per_dispatch": 2, "tpu": {"transfer_guard": True}}}),
    # The sparse exchange: the flagship on the exponential graph and on
    # one_peer (offsets 1, 2, 4, 8; the circulant pass at the offsets and at
    # their differences each round), and population_1m.yaml's scenario
    # without its population: block (Krum, 256 nodes, k = 8, the 32-64-10
    # MLP), the shape the population engine will run.
    ("krum:exponential_flagship", FLAGSHIP, "allgather", None,
     {"circulant_sq_distances": (2, "==")},
     {"topology": {"type": "exponential", "num_nodes": 16}}),
    ("krum:one_peer_flagship", FLAGSHIP, "allgather", None,
     {"circulant_sq_distances": (2, "==")},
     {"topology": {"type": "one_peer", "num_nodes": 16}}),
    ("krum:population_1m_scenario", POPULATION_1M, None, None,
     {"circulant_sq_distances": (2, "==")}, {"drop": ("population",), "rounds": 50}),
    # Cohort streaming and DMTT: population_1m.yaml as committed (50 rounds,
    # a stratified cohort of 256 from 1,000,000 users every round, the
    # 1M-user bank memory-mapped), beside the scenario above in the same
    # call, and dmtt_mobility.yaml as committed (30 rounds, fedavg: no
    # kernel; the DMTT cross-evaluation's share of a round printed).
    ("krum:population_1m", POPULATION_1M, None, None,
     {"circulant_sq_distances": (2, "==")}, {"rounds": 50}),
    ("fedavg:dmtt_mobility", DMTT_MOBILITY, None, None, {}, {"rounds": 30}),
    # Adaptive attacks: the flagship with attack.adaptive on (the bisection
    # around its gaussian attack, 6 rounds, both exchanges),
    # alie_geometric_median.yaml with adaptive ALIE, and the flagship's
    # trimmed mean under ppermute with adaptive IPM (the candidate select).
    ("krum:adaptive_flagship", FLAGSHIP, "allgather", None,
     {"pairwise_sq_distances": (2, "==")}, {"rounds": ADAPTIVE_FLAGSHIP_ROUNDS, "adaptive": True}),
    ("krum:adaptive_ppermute", FLAGSHIP, "ppermute", None,
     {"circulant_sq_distances": (2, "==")}, {"rounds": ADAPTIVE_FLAGSHIP_ROUNDS, "adaptive": True}),
    ("geometric_median:adaptive_alie", ALIE_GEOMETRIC_MEDIAN, None, None,
     {"pairwise_sq_distances": (9, "==")}, {"adaptive": True}),
    ("trimmed_mean:adaptive_ipm_ppermute", FLAGSHIP, "ppermute",
     {"algorithm": "trimmed_mean", "params": {"trim_ratio": 0.2}},
     {"candidate_select": (1, "==")},
     {"attack": {"enabled": True, "type": "ipm", "percentage": 0.2, "params": {},
                 "adaptive": {"enabled": True}}}),
]
# The DMTT round's per-node stats (the JAX package's agg_dmtt_* keys).
DMTT_STATS = ("agg_dmtt_collab_count", "agg_dmtt_received_count", "agg_dmtt_mean_topo_trust")
# Fused dispatch: the flagship's Krum allgather over FUSED_ROUNDS rounds,
# per round and with tpu.rounds_per_dispatch 2, in the same call.
FUSED_ROUNDS = 6


def _kernel_modules():
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    return (agg_kernels, candidate_kernels, sketch_kernels)


@contextlib.contextmanager
def timed_probes(events: list):
    """While open, the probe forwards of UBAR (the cross-evaluation and the
    own loss), of evidential trust (the cross-evaluation) and of a DMTT round
    (its shared cross-evaluation) record a pair of CUDA events around each
    call into ``events``: device-stream time, with no synchronisation added
    to the round."""
    import torch

    from murmura_tpu_torch.aggregation import evidential_trust, ubar
    from murmura_tpu_torch.core import rounds

    patched = [(ubar, "pairwise_probe_eval"), (ubar, "circulant_probe_eval"),
               (ubar, "self_probe_metrics"), (evidential_trust, "pairwise_probe_eval"),
               (evidential_trust, "circulant_probe_eval"), (rounds, "pairwise_probe_eval")]
    real = {(mod, name): getattr(mod, name) for mod, name in patched}

    def timed(fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        return wrapper

    for mod, name in patched:
        setattr(mod, name, timed(real[mod, name]))
    try:
        yield
    finally:
        for mod, name in patched:
            setattr(mod, name, real[mod, name])


@contextlib.contextmanager
def timed_swap_parts(parts: dict):
    """While open, a population run's swap records the host seconds of its
    parts into ``parts`` (name -> list): ``stage`` (the bank gather, the
    pinned copies and the queued copies to the card; the prefetch inside
    the round too), ``write_back`` (the bank's scatter into its rows, the
    device-to-host copy excluded) and ``rebind`` (the slots' data shards);
    the rest of ``swap_s`` is that copy, the composition and the draw."""
    from murmura_tpu_torch.population import bank, engine

    patched = [(bank.PopulationBank, "scatter", "write_back"),
               (engine.PopulationNetwork, "_stage_cohort_rows", "stage"),
               (engine.PopulationNetwork, "_rebind_data", "rebind")]
    real = {(cls, name): getattr(cls, name) for cls, name, _ in patched}

    def timed(fn, part):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            parts.setdefault(part, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    for cls, name, part in patched:
        setattr(cls, name, timed(real[cls, name], part))
    try:
        yield
    finally:
        for cls, name, _ in patched:
            setattr(cls, name, real[cls, name])


def config_section(name: str, key: str) -> dict:
    """The ``key:`` section of examples/configs/<name>.yaml."""
    import yaml

    return yaml.safe_load((ROOT / "examples" / "configs" / f"{name}.yaml").read_text())[key]


@contextlib.contextmanager
def finite_kernel_inputs(flags: list):
    """While open, every kernel wrapper records, for each floating-point
    tensor it is handed, whether all of it is finite: a device bool in
    ``flags``, so the round is not synchronised."""
    import torch

    patched = []
    for name, (mod, attr, _) in _kernel_fns().items():
        real = getattr(mod, attr)

        def wrapper(*args, real=real, name=name, **kwargs):
            for a in (*args, *kwargs.values()):
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    flags.append((name, torch.isfinite(a).all()))
            return real(*args, **kwargs)

        setattr(mod, attr, wrapper)
        patched.append((mod, attr, real))
    try:
        yield
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)


@contextlib.contextmanager
def sync_free_chunks(events: list):
    """While open, every fused chunk (a single run's or a gang's) after the
    first of its size runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` (the first makes the
    wrappers' one-time device copies: the attack's compromised rows, the
    circulant offsets), and each synchronising call inside it lands in
    ``events`` as "file:line: message".  The mode's other warning (that it
    is a prototype) is not an event."""
    import warnings

    import torch

    from murmura_tpu_torch.core import gang as gang_mod
    from murmura_tpu_torch.core import network as net_mod

    builders = ((net_mod, "build_multi_round"), (gang_mod, "build_gang_multi_round"))
    real = {mod: getattr(mod, attr) for mod, attr in builders}

    def watched(real_build, *build_args):
        fn = real_build(*build_args)
        calls = []

        def run(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                return fn(*args, **kwargs)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    events.extend(f"{w.filename}:{w.lineno}: {str(w.message).splitlines()[0]}"
                                  for w in caught
                                  if "called a synchronizing CUDA operation" in str(w.message))

        return run

    for mod, attr in builders:
        setattr(mod, attr, lambda *a, real_build=real[mod]: watched(real_build, *a))
    try:
        yield
    finally:
        for mod, attr in builders:
            setattr(mod, attr, real[mod])


def _launch_context(events: list) -> dict:
    """For each device event's correlation id, (innermost host op, outermost
    ``murmura.*`` phase) around the host call that launched it: the runtime
    call (cudaLaunchKernel, a memcpy) carries the id, and the ``cpu_op`` and
    ``user_annotation`` ranges of its thread that contain it name the op and
    the phase (core/rounds.py's record_function ranges).  Autograd runs the
    backward pass on a thread of its own, outside the ranges of the thread
    that asked for the gradient, so a launch with no phase on its thread
    takes the phase whose range, on any thread, holds its time.  One sweep
    a thread over its nested ranges."""
    import bisect

    by_tid: dict = {}
    phases_any = []
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation"):
            by_tid.setdefault(e.get("tid"), []).append((e["ts"], 0, -e["dur"], e))
            if e["name"].startswith("murmura."):
                phases_any.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif (e.get("cat") in ("cuda_runtime", "cuda_driver")
              and (e.get("args") or {}).get("correlation") is not None):
            by_tid.setdefault(e.get("tid"), []).append((e["ts"], 1, 0, e))
    phases_any.sort()
    phase_starts = [a for a, _, _ in phases_any]

    def phase_at(t):
        i = bisect.bisect_right(phase_starts, t) - 1
        while i >= 0:
            a, b, name = phases_any[i]
            if b >= t:
                return name
            i -= 1
            if i >= 0 and phases_any[i][1] < a:
                break
        return "(no phase)"

    out = {}
    for items in by_tid.values():
        stack: list = []
        for t, kind, _, e in sorted(items, key=lambda x: x[:3]):
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
                stack.pop()
            if kind == 0:
                stack.append(e)
                continue
            ops = [r["name"] for r in stack if r["cat"] == "cpu_op"]
            phases = [r["name"] for r in stack if r["name"].startswith("murmura.")]
            out[e["args"]["correlation"]] = (ops[-1] if ops else "(no op)",
                                            phases[0] if phases else phase_at(t))
    return out


def trace_split(path: Path, top: int = 10, gaps: int = 5) -> dict:
    """The split of a profiler window from its Chrome trace (the ``run``
    entry's torch.profiler window, core/network.py): the window's span
    (first to last event, host or device), the share of it in which the
    card ran something (the union of kernel, copy and set intervals), the
    ``top`` device kernels and the ``top`` host ops by the device time they
    launched, with their shares of the window, the device time and host
    time of each round phase (core/rounds.py's ``murmura.*`` ranges), the
    four kernels' share, and the ``gaps`` longest stretches with nothing on
    the card (ms, and ms from the window's start)."""
    trace = json.loads(Path(path).read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise AssertionError(f"the trace {path} holds no device activity")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    idle = [(merged[0][0] - t0, 0.0)]
    idle += [(b2[0] - b1[1], b1[1] - t0) for b1, b2 in zip(merged, merged[1:])]
    idle.append((t1 - merged[-1][1], merged[-1][1] - t0))
    context = _launch_context(events)
    by_name: dict = {}
    by_op: dict = {}
    by_phase: dict = {}
    for e in device:
        name = e["name"].replace("(anonymous namespace)::", "").replace("at::native::", "")
        name = name.split("(")[0].strip()[:160] or e["name"][:160]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
        op, phase = context.get((e.get("args") or {}).get("correlation"),
                                ("(no op)", "(no phase)"))
        by_op[op] = by_op.get(op, 0.0) + e["dur"]
        by_phase[phase] = by_phase.get(phase, 0.0) + e["dur"]
    host_phase: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("murmura."):
            host_phase[e["name"]] = host_phase.get(e["name"], 0.0) + e["dur"]
    symbols = {sym: k for k, syms in KERNEL_SYMBOLS.items() for sym in syms}
    ours: dict = {}
    for name, us in by_name.items():
        for sym, kernel in symbols.items():
            if name.endswith(sym) or f"{sym}<" in name or name.split("<")[0].endswith(sym):
                ours[kernel] = ours.get(kernel, 0.0) + us
                break
    window = t1 - t0

    def ranked(d):
        return [(k, us / 1e3, us / window) for k, us in sorted(d.items(), key=lambda kv: -kv[1])]

    return {
        "window_ms": window / 1e3,
        "device_busy_share": busy / window,
        "device_ms": busy / 1e3,
        "device_ops": len(device),
        "top": ranked(by_name)[:top],
        "top_ops": ranked(by_op)[:top],
        "phases": {k: (ms, share, host_phase.get(k, 0.0) / 1e3)
                   for k, ms, share in ranked(by_phase)},
        "kernels_ms": {k: us / 1e3 for k, us in ours.items()},
        "kernels_share": sum(ours.values()) / window,
        "gaps": [(g / 1e3, at / 1e3) for g, at in sorted(idle, reverse=True)[:gaps]],
    }


def history_delta(got: dict, ref: dict) -> float:
    """Largest scaled difference of two histories' values, key by key:
    max |got - ref| / max(1, max |ref|)."""
    import numpy as np

    worst = 0.0
    for k, v in ref.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        if b.size:
            worst = max(worst, float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b))))))
    return worst


def read_telemetry(label, run_dir, tel, network, rounds, faults, peak_bytes) -> str:
    """Read a phase-4 run's telemetry dir back through the port's report
    (the gates and prints of run_main_path's docstring); returns a summary
    for the run's line."""
    import numpy as np
    import torch

    from murmura_tpu_torch.telemetry.report import build_report
    from murmura_tpu_torch.telemetry.writer import events_of_type

    rep = build_report(run_dir)
    notes = [f"telemetry {run_dir.relative_to(ROOT)}: {rep['time']['rounds_timed']} "
             f"phase_times ({', '.join(rep['time']['by_mode'])})"]
    if rep["time"]["rounds_timed"] != rounds:
        raise AssertionError(f"{rep['time']['rounds_timed']} phase_times records")
    if tel.get("memory_stats"):
        mem = events_of_type(run_dir, "memory")
        ev_peak = mem[-1]["stats"]["peak_bytes_in_use"]
        notes.append(f"memory event peak {ev_peak:,} B, torch.cuda.max_memory_allocated "
                     f"{peak_bytes:,} B, limit {mem[-1]['stats']['bytes_limit']:,} B "
                     f"({mem[-1]['device_kind']})")
        if ev_peak != peak_bytes or mem[-1]["device_kind"] != torch.cuda.get_device_name(0):
            raise AssertionError("the memory event disagrees with the allocator")
    rounds_ev = events_of_type(run_dir, "round")
    sched = network.fault_schedule
    if tel.get("audit_taps") and sched is not None:
        taps = [e["metrics"]["agg_tap_alive"] for e in rounds_ev]
        if taps != [sched.alive_at(r).tolist() for r in range(rounds)]:
            raise AssertionError("agg_tap_alive differs from the schedule's alive rows")
        frm = int(faults.get("nan_inject_from_round", 0))
        for node in faults.get("nan_inject_nodes", []):
            want = float(sum(sched.alive_at(r)[node] for r in range(frm, rounds)))
            got = rep["faults"]["quarantined_rounds"][node]
            notes.append(f"node {node} quarantined {got:g} rounds, alive {want:g} of them")
            if got != want:
                raise AssertionError(f"node {node}'s quarantined total differs from the schedule")
        notes.append("agg_tap_alive == the schedule's alive rows")
        t, f = rep.get("taps", {}), rep["faults"]
        cols = [("selected_by", t.get("selected_by")), ("considered_by", t.get("considered_by")),
                ("rejections", t.get("rejections")),
                ("quarantined", f.get("quarantined_rounds")), ("alive", f.get("alive_rounds"))]
        cols = [(k, v) for k, v in cols if v is not None]
        print(f"[main:{label}] per-node audit over {rounds} rounds: "
              + "; ".join(f"{k} {[round(x, 1) for x in v]}" for k, v in cols), flush=True)
    if "staleness" in rep:
        st = rep["staleness"]
        notes.append(f"stale edge-serves {st['total_stale_edges']:g}, served ages "
                     f"{st.get('age_histogram', {})}, stale in-edges a node "
                     f"{[round(x, 1) for x in st['stale_in_edges']]}")
    if "influence" in rep:
        notes.append(f"declared influence {rep['influence']['kind']}")
    prof = [e for e in events_of_type(run_dir, "profile") if e["status"] == "stopped"]
    if tel.get("profile_rounds"):
        if len(prof) != 1:
            raise AssertionError(f"{len(prof)} profiler windows closed, want 1")
        rt = network.round_times
        first = tel["profile_start_round"]
        window_s = sum(rt[first:first + tel["profile_rounds"]])
        split = trace_split(Path(prof[0]["trace_file"]))
        print(f"[trace:{label}] window rounds {first + 1}-{first + tel['profile_rounds']} "
              f"(1-based), {split['window_ms']:.2f} ms traced ({window_s * 1e3:.2f} ms of "
              f"round time under the profiler); the card busy "
              f"{split['device_busy_share']:.2%} of it ({split['device_ms']:.2f} ms, "
              f"{split['device_ops']} device ops); the four kernels "
              f"{split['kernels_share']:.2%} ({split['kernels_ms']})", flush=True)
        print(f"[trace:{label}] device ms, share of the window and host ms by round phase: "
              + "; ".join(f"{k} {ms:.2f} ms {sh:.2%} (host {h:.2f} ms)"
                          for k, (ms, sh, h) in split["phases"].items()), flush=True)
        print(f"[trace:{label}] the top device kernels:", flush=True)
        for name, ms, share in split["top"]:
            print(f"[trace:{label}]   {ms:9.3f} ms  {share:7.2%}  {name}", flush=True)
        print(f"[trace:{label}] the top host ops by the device time they launched:",
              flush=True)
        for name, ms, share in split["top_ops"]:
            print(f"[trace:{label}]   {ms:9.3f} ms  {share:7.2%}  {name}", flush=True)
        print(f"[trace:{label}] longest idle stretches (ms, at ms): "
              + ", ".join(f"{g:.2f} at {at:.2f}" for g, at in split["gaps"]), flush=True)
        notes.append(f"trace {Path(prof[0]['trace_file']).name}")
    return "; ".join(notes)


def smoke_config(name, config, exchange, aggregation, opts):
    """Phase 4's config for one run (run_main_path's docstring), written to
    SMOKE_DIR/<name>.yaml; returns (raw, its path, the history path).  A
    ``durability:`` section gets its checkpoint_dir under SMOKE_DIR/ckpts
    (emptied first) and ``opts["checkpoint_every"]`` if given;
    ``opts["drop"]`` removes sections, ``opts["topology"]``, ``opts["data"]``
    and ``opts["model"]`` replace those sections, ``opts["max_samples"]``
    sets training.max_samples and ``opts["adaptive"]`` turns
    attack.adaptive on."""
    import yaml

    raw = yaml.safe_load(config.read_text())
    raw["experiment"]["rounds"] = opts.get("rounds", SMOKE_ROUNDS)
    for key in opts.get("drop", ()):
        raw.pop(key, None)
    for key in ("topology", "data", "model"):
        if key in opts:
            raw[key] = dict(opts[key])
    if "max_samples" in opts:
        raw["training"]["max_samples"] = opts["max_samples"]
    if exchange is not None:
        raw["backend"] = "tpu"
        raw.setdefault("tpu", {})["exchange"] = exchange
    if aggregation is not None:
        raw["aggregation"] = aggregation
    if opts.get("attack") is not None:
        raw["attack"] = opts["attack"]
    if opts.get("adaptive"):
        raw["attack"]["adaptive"] = {"enabled": True}
    sections = opts.get("sections", {})
    for key in ("compression", "faults", "exchange", "telemetry", "durability"):
        if key in sections:
            value = sections[key]
            raw[key] = dict(value) if isinstance(value, dict) else config_section(value, key)
    if "tpu" in sections:
        value = sections["tpu"]
        raw.setdefault("tpu", {}).update(
            value if isinstance(value, dict) else config_section(value, "tpu"))
    if "profile" in opts:
        start, count = opts["profile"]
        raw["telemetry"] = {"enabled": True, "profile_start_round": start,
                            "profile_rounds": count}
    if "rounds_per_dispatch" in sections:
        raw["backend"] = "tpu"
        raw.setdefault("tpu", {})["rounds_per_dispatch"] = sections["rounds_per_dispatch"]
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    tel = raw.get("telemetry") or {}
    if tel.get("enabled"):
        tel["dir"] = str(SMOKE_DIR / "runs" / name)
        tel["memory_stats"] = tel.get("memory_stats", False) or opts.get("memory_stats", False)
        shutil.rmtree(tel["dir"], ignore_errors=True)
    if raw.get("durability"):
        ckpt = SMOKE_DIR / "ckpts" / name
        shutil.rmtree(ckpt, ignore_errors=True)
        raw["durability"]["checkpoint_dir"] = str(ckpt)
        if "checkpoint_every" in opts:
            raw["durability"]["checkpoint_every"] = opts["checkpoint_every"]
    cfg = SMOKE_DIR / f"{name}.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    return raw, cfg, SMOKE_DIR / f"history_{name}.json"


def run_main_path(label, config, exchange, aggregation, expect, opts=None) -> dict:
    """Phase 4: one config through ``murmura_tpu_torch.cli.run`` on the card,
    the kernel counters set to 0 just before and read just after, with the
    run's peak device memory and, for UBAR and evidential trust, its probe
    forwards' time.  A faulted run also holds its alive and quarantined
    counts to the schedule and every kernel input finite; a compressed run
    prints its payload bytes an edge; a fused run (tpu.rounds_per_dispatch
    above 1) allows no synchronising call inside a chunk (sync_free_chunks).
    A run with telemetry writes its run dir under SMOKE_DIR/runs and reads
    it back with the port's report: its ``memory`` events' peak must equal
    ``torch.cuda.max_memory_allocated``, its ``agg_tap_alive`` rows the
    schedule's alive rows, a NaN-injected node's quarantined total the
    rounds it was alive; the per-node audit table, the stale stats and the
    served ages are printed.  ``opts["profile"] = (start, rounds)`` opens
    the profiler window over those rounds and prints the trace's split
    (trace_split)."""
    import numpy as np
    import torch

    from murmura_tpu_torch import cli
    from murmura_tpu_torch.core.network import empty_history

    opts = opts or {}
    rounds = opts.get("rounds", SMOKE_ROUNDS)
    name = label.replace(":", "_")
    raw, cfg, out = smoke_config(name, config, exchange, aggregation, opts)
    rule = raw["aggregation"]["algorithm"]
    faults = raw.get("faults", {}) or {}
    faulted = bool(faults.get("enabled"))
    compression = (raw.get("compression") or {}).get("algorithm", "none") != "none"
    tpu = raw.get("tpu") or {}
    fused = tpu.get("rounds_per_dispatch", 1) > 1
    stale = (raw.get("exchange") or {}).get("max_staleness", 0) > 0
    pipelined = bool((raw.get("exchange") or {}).get("pipeline"))
    tel = raw.get("telemetry") or {}
    adaptive = bool(((raw.get("attack") or {}).get("adaptive") or {}).get("enabled"))
    # An adaptive attack turns the audit taps on: they are its feedback.
    audit = bool(tel.get("enabled") and tel.get("audit_taps")) or adaptive

    mods = _kernel_modules()
    probe_events: list = []
    swap_parts: dict = {}
    finite_flags: list = []
    sync_events: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_probes(probe_events))
        stack.enter_context(timed_swap_parts(swap_parts))
        if faulted:
            stack.enter_context(finite_kernel_inputs(finite_flags))
        if fused and not tpu.get("transfer_guard"):
            # (Under tpu.transfer_guard the Network raises on a sync itself.)
            stack.enter_context(sync_free_chunks(sync_events))
        for mod in mods:
            mod.reset_counts()
        t0 = time.perf_counter()
        history, network = cli.run(cfg, output=out, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9

    print(f"[main:{label}] launches {launches}, plain-version calls {plain}", flush=True)
    for kernel, (per_round, op) in expect.items():
        want = per_round * rounds
        if not (launches[kernel] == want if op == "==" else launches[kernel] >= want):
            raise AssertionError(f"{kernel} launched {launches[kernel]} times in "
                                 f"{rounds} rounds (want {op} {per_round} a round)")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card path: {plain}")
    stray = {k: v for k, v in launches.items() if v and k not in expect}
    if stray:
        raise AssertionError(f"kernels this run should not launch did: {stray}")
    hist = json.loads(out.read_text())
    want = set(empty_history()) | {f"agg_{k}" for k in RULE_STATS[rule]}
    if faulted:
        want.add("agg_alive")
        if faults.get("nan_quarantine", True):
            want.add("agg_quarantined")
            if raw.get("attack", {}).get("enabled"):
                want.add("agg_attack_scrubbed")
    if compression:
        want.add("agg_compress_error")
        if raw["compression"].get("error_feedback"):
            want.add("agg_compress_residual_norm")
    if stale:
        want |= {"agg_stale_used", "agg_stale_expired"}
    if pipelined:
        want.add("agg_pipe_valid")
    if raw.get("dmtt") is not None:
        want |= set(DMTT_STATS)
    if audit:
        want |= {f"agg_tap_{k}" for k in RULE_TAPS.get(rule, ())}
        if faulted:
            want |= {f"agg_tap_{k[4:]}" for k in want & {
                "agg_alive", "agg_quarantined", "agg_attack_scrubbed"}}
        if stale:
            want |= {"agg_tap_stale_used", "agg_tap_stale_age"}
    if adaptive:
        want |= {f"agg_{k}" for k in network.attack.state_keys} | {"agg_atk_accept"}
    if set(hist) != want:
        raise AssertionError(f"history keys {sorted(hist)} != {sorted(want)}")
    if len(hist["round"]) != rounds:
        raise AssertionError(f"history has {len(hist['round'])} rounds")
    if pipelined and hist["agg_pipe_valid"] != [0.0] + [1.0] * (rounds - 1):
        raise AssertionError(f"agg_pipe_valid {hist['agg_pipe_valid']}, want [0, 1, ...]")
    for k, v in hist.items():
        if v and not np.all(np.isfinite(np.asarray(v, dtype=np.float64))):
            raise AssertionError(f"history[{k!r}] is not finite: {v}")
    evidential = ("mean_vacuity", "mean_entropy", "mean_strength")
    if network.program.evidential and any(len(hist[k]) != rounds for k in evidential):
        raise AssertionError(f"an evidential run's history lacks {evidential}")
    if not torch.isfinite(network.flat).all():
        raise AssertionError("final parameters are not finite")
    rt = network.round_times
    extra = ""
    for k in ("agg_acceptance_rate", "agg_stage1_acceptance_rate", "agg_stage2_acceptance_rate",
              "agg_mean_trust", "agg_threshold", "agg_trimmed_per_side",
              "mean_vacuity", "mean_entropy", "mean_strength", "honest_accuracy",
              "agg_compress_error", "agg_compress_residual_norm"):
        if hist.get(k):
            extra += f"; {k.replace('agg_', '')} {[round(v, 4) for v in hist[k]]}"
    if faulted:
        sched = network.fault_schedule
        inject = list(faults.get("nan_inject_nodes", []))
        alive = [float(sched.alive_at(r).sum()) for r in range(rounds)]
        quarantined = [float(sched.alive_at(r)[inject].sum()) for r in range(rounds)]
        finite = all(bool(f) for _, f in finite_flags)
        extra += (f"; alive {hist['agg_alive']} (schedule {alive}), quarantined "
                  f"{hist.get('agg_quarantined')} (schedule {quarantined}), attack scrubbed "
                  f"{hist.get('agg_attack_scrubbed')}; {len(finite_flags)} kernel inputs, "
                  f"all finite: {finite}")
        if hist["agg_alive"] != alive or hist.get("agg_quarantined", quarantined) != quarantined:
            raise AssertionError("the alive or quarantined counts differ from the schedule")
        if not finite:
            bad = sorted({k for k, f in finite_flags if not bool(f)})
            raise AssertionError(f"a non-finite input reached a kernel: {bad}")
    if compression:
        spec = network.program.compression
        p = network.program.model_dim
        item = network.flat.element_size()
        extra += (f"; payload {spec.payload_bytes(p, item):,} bytes an edge against "
                  f"{p * item:,} uncompressed ({p * item / spec.payload_bytes(p, item):.2f}x)")
    if fused:
        extra += (f"; {len(sync_events)} synchronising call(s) inside the chunks after the "
                  f"first" + (f": {sorted(set(sync_events))[:5]}" if sync_events else ""))
    if stale:
        extra += (f"; stale used a round {hist['agg_stale_used']}, expired "
                  f"{hist['agg_stale_expired']}")
    if pipelined:
        extra += (f"; pipelined, agg_pipe_valid {hist['agg_pipe_valid']}, recompile_guard "
                  f"{network.recompile_guard}")
    if tpu.get("transfer_guard"):
        extra += "; tpu.transfer_guard on: no synchronising call raised inside a chunk"
    if hasattr(network, "swap_times"):
        swaps = network.swap_times
        extra += (f"; population: {len(swaps)} swaps, swap_s median {np.median(swaps):.6f} "
                  f"max {max(swaps):.6f} (the first {swaps[0]:.6f}), "
                  f"{network.bank.activated:,} of {network.population.virtual_size:,} users "
                  f"activated, bank {'memory-mapped' if network.bank.path else 'in RAM'}; "
                  "median s of its parts: " + ", ".join(
                      f"{k} {np.median(v):.6f} ({len(v)} calls)"
                      for k, v in sorted(swap_parts.items())))
    if raw.get("dmtt") is not None:
        extra += "; " + "; ".join(f"{k[9:]} {[round(v, 3) for v in hist[k]]}"
                                  for k in DMTT_STATS)
    if adaptive:
        extra += f"; {network.attack.name}: " + "; ".join(
            f"{k[4:]} {[round(v, 4) for v in hist[k]]}" for k in sorted(hist)
            if k.startswith("agg_atk_"))
    if network.checkpoints:
        extra += "; snapshots " + ", ".join(
            f"{c['action']} round {c['round']} {c['bytes']:,} B in {c['seconds']:.3f} s"
            for c in network.checkpoints)
    if tel.get("enabled"):
        extra += "; " + read_telemetry(label, Path(tel["dir"]), tel, network, rounds, faults,
                                       peak_bytes)
    probe_ms = sum(a.elapsed_time(b) for a, b in probe_events)
    probe_share = None
    if probe_events:
        steady = float(np.sum(rt[1:]))
        steady_ms = sum(a.elapsed_time(b) for a, b in probe_events[len(probe_events) // len(rt):])
        probe_share = steady_ms / 1e3 / steady
        extra += (f"; probe forwards {probe_ms:.2f} ms in {len(probe_events)} calls, "
                  f"{probe_share:.1%} of the steady rounds")
    swap_s = list(getattr(network, "swap_times", []))
    activated = network.bank.activated if swap_s else None
    print(f"[main:{label}] P={network.program.model_dim} N={network.program.num_nodes} "
          f"round seconds {[round(t, 4) for t in rt]}; steady s/round "
          f"{np.mean(rt[1:]):.4f}; run wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB "
          f"({base_gb:.2f} GB held before the run); "
          f"final mean accuracy {hist['mean_accuracy'][-1]:.4f}{extra}", flush=True)
    if sync_events:
        raise AssertionError("a fused chunk synchronised with the host")
    checkpoints = list(network.checkpoints)
    if swap_s:
        network.bank.close()  # the 1M-user bank's temporary directory
    del network, history
    held_gb = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    print(f"[main:{label}] held once the run is dropped, before the cycle collector: "
          f"{held_gb:.2f} GB, after it {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] for k in expect}, "s_per_round": rt,
            "peak_gb": peak_gb, "probe_ms": probe_ms, "history": hist,
            "checkpoints": checkpoints, "swap_s": swap_s, "activated": activated,
            "probe_share": probe_share, "swap_parts": swap_parts}


def run_fused_pair(tag: str = "flagship", sections=None) -> dict:
    """Phase 4, fused dispatch: the flagship's Krum allgather (with the
    config ``sections`` added) over FUSED_ROUNDS rounds per round, then with
    tpu.rounds_per_dispatch 2, in the same call.  The two histories must
    agree to a scaled delta of 1e-4 (cuDNN may pick another backward
    algorithm between the runs; the CPU tests hold them bit-equal); whether
    they are bit-equal is printed, with both runs' steady seconds a round."""
    import numpy as np

    expect = {"pairwise_sq_distances": (2, "==")}
    runs = {}
    per_round, fused = f"krum:per_round_{tag}", f"krum:fused_{tag}"
    for label, dispatch in ((per_round, 1), (fused, 2)):
        extra = {"rounds_per_dispatch": dispatch} if dispatch > 1 else {}
        runs[label] = run_main_path(label, FLAGSHIP, "allgather", None, expect,
                                    {"rounds": FUSED_ROUNDS,
                                     "sections": {**(sections or {}), **extra}})
    ref, got = runs[per_round], runs[fused]
    delta = history_delta(got["history"], ref["history"])
    same = got["history"] == ref["history"]
    steady = {k: float(np.mean(v["s_per_round"][2:])) for k, v in runs.items()}
    print(f"[main:fused_{tag}] {FUSED_ROUNDS} rounds per round and in chunks of 2: history "
          f"bit-equal {same}, scaled delta {delta:.3g} (limit 1e-4); steady s/round (rounds "
          f"3-{FUSED_ROUNDS}) per round {steady[per_round]:.4f}, fused "
          f"{steady[fused]:.4f}: {'ok' if delta <= 1e-4 else 'FAILED'}",
          flush=True)
    if delta > 1e-4:
        raise AssertionError("the fused history differs from per-round dispatch")
    return runs


# The flagship under RESUME_SECTIONS: rounds (cut from 6 for the script's
# time budget), and the snapshot cadence.
RESUME_ROUNDS, RESUME_EVERY = 4, 2
# ``python -m murmura_tpu_torch run ...`` (cli.main), then the kernel
# counters of the process on one line.
_CLI_WITH_COUNTS = """
import json, sys
from murmura_tpu_torch import cli
from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels
cli.main(sys.argv[1:])
mods = (agg_kernels, candidate_kernels, sketch_kernels)
print("COUNTS " + json.dumps({
    "launches": {k: v for m in mods for k, v in m.LAUNCHES.items()},
    "plain": {k: v for m in mods for k, v in m.PLAIN_CALLS.items()}}))
"""


def _snapshot_round(ckpt: Path) -> int:
    """The round meta.json commits to, or -1 before the first snapshot."""
    try:
        return int(json.loads((ckpt / "meta.json").read_text())["round"])
    except (OSError, ValueError, KeyError):
        return -1


def run_kill_resume(exchange: str) -> dict:
    """Phase 4, durability on the flagship's Krum under resumable_run.yaml's
    durability:, compression: (int8, error feedback) and telemetry:
    sections, RESUME_ROUNDS rounds, a snapshot every RESUME_EVERY: first
    uninterrupted through run_main_path (its kernel counts and snapshot
    sizes and times), then through ``python -m murmura_tpu_torch run`` in a
    subprocess, SIGKILLed once meta.json names round RESUME_EVERY or later,
    and the same command again, which resumes.  The resumed run must launch
    the distance kernel twice a round for the rounds it ran and no plain
    version, take Krum's decisions (``agg_selected_index``,
    ``agg_selected_own``) of the uninterrupted run, and agree with its
    history to a scaled 1e-4 (cuDNN may pick another algorithm in a new
    process); whether it is bit-equal is printed, with the telemetry
    stream's seam (one ``run_resumed``, appended), and each snapshot's bytes
    and save or restore seconds."""
    from murmura_tpu_torch.telemetry.writer import events_of_type

    kernel = "pairwise_sq_distances" if exchange == "allgather" else "circulant_sq_distances"
    expect = {kernel: (2, "==")}
    opts = {"rounds": RESUME_ROUNDS, "sections": RESUME_SECTIONS,
            "checkpoint_every": RESUME_EVERY}
    ref = run_main_path(f"krum:durable_{exchange}", FLAGSHIP, exchange, None, expect, opts)
    name = f"krum_killed_{exchange}"
    raw, cfg, out = smoke_config(name, FLAGSHIP, exchange, None, opts)
    ckpt, run_dir = Path(raw["durability"]["checkpoint_dir"]), Path(raw["telemetry"]["dir"])
    cmd = [sys.executable, "-c", _CLI_WITH_COUNTS, "run", str(cfg), "--device", "cuda",
           "-o", str(out)]
    t0 = time.perf_counter()
    with open(SMOKE_DIR / f"{name}.killed.log", "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and _snapshot_round(ckpt) < RESUME_EVERY:
                time.sleep(0.005)
            running = proc.poll() is None
            proc.kill()
        finally:
            proc.wait()
    killed_s = time.perf_counter() - t0
    stopped = _snapshot_round(ckpt)
    if not running:
        raise AssertionError(f"the run exited ({proc.returncode}) before it could be killed")
    t0 = time.perf_counter()
    resumed = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    resumed_s = time.perf_counter() - t0
    (SMOKE_DIR / f"{name}.resumed.log").write_text(resumed.stdout + resumed.stderr)
    if resumed.returncode != 0:
        raise AssertionError(f"the resumed run failed: {resumed.stderr[-3000:]}")
    if f"Resumed from round {stopped}" not in resumed.stdout:
        raise AssertionError(f"the run did not resume from round {stopped}")
    counts = json.loads(resumed.stdout.rsplit("COUNTS ", 1)[1].splitlines()[0])
    want = 2 * (RESUME_ROUNDS - stopped)
    stray = {k: v for k, v in counts["launches"].items() if v and k != kernel}
    if counts["launches"][kernel] != want or any(counts["plain"].values()) or stray:
        raise AssertionError(f"the resumed run's counts {counts}, want {kernel} {want}")
    hist, ref_hist = json.loads(out.read_text()), ref["history"]
    same = hist == ref_hist
    delta = history_delta(hist, ref_hist)
    decisions = all(hist[k] == ref_hist[k] for k in ("agg_selected_index", "agg_selected_own"))
    runs = [e["status"] for e in events_of_type(run_dir, "run")]
    seam = (runs == ["started", "resumed"] and len(events_of_type(run_dir, "run_resumed")) == 1
            and not (run_dir / "events.jsonl.prev").exists())
    snaps = [(e["action"], e["round"], e["bytes"], e["duration_s"])
             for e in events_of_type(run_dir, "checkpoint")]
    ok = delta <= 1e-4 and decisions and seam and hist["round"] == list(
        range(1, RESUME_ROUNDS + 1))
    print(f"[main:resume_{exchange}] the flagship's Krum {exchange} under resumable_run.yaml's "
          f"durability:, compression: and telemetry: sections, {RESUME_ROUNDS} rounds, a "
          f"snapshot every {RESUME_EVERY}: killed (SIGKILL) after {killed_s:.2f} s with the "
          f"snapshot at round {stopped}, resumed in {resumed_s:.2f} s (process wall); "
          f"{kernel} launched {counts['launches'][kernel]} times in the {RESUME_ROUNDS - stopped} "
          f"resumed rounds, plain-version calls {sum(counts['plain'].values())}; history "
          f"bit-equal to the uninterrupted run {same}, scaled delta {delta:.3g} (limit 1e-4), "
          f"decisions equal {decisions}; telemetry stream {runs}, one run_resumed and appended: "
          f"{seam}; snapshots of the killed and resumed processes "
          + ", ".join(f"{a} round {r} {b:,} B in {d:.3f} s" for a, r, b, d in snaps)
          + f": {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("the resumed flagship run differs from the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(SMOKE_DIR / "ckpts" / f"krum_durable_{exchange}", ignore_errors=True)
    return {f"krum:durable_{exchange}": ref,
            f"krum:resumed_{exchange}": {"launches": {kernel: counts["launches"][kernel]},
                                         "history": hist, "snapshots": snaps,
                                         "stopped": stopped, "bit_equal": same,
                                         "delta": delta}}


# Gangs (core/gang.py): sweep_seeds.yaml as committed, and the flagship as
# a gang of GANG_SEEDS seeds.  The flagship's LEAF shards differ in size
# between seeds (seeds 7-10: 191-231 training samples a node), which a gang
# refuses in both packages, so its gang runs and their single runs pin
# training.max_samples (the test splits take the same cap).
GANG_SEEDS = 4
GANG_MAX_SAMPLES = 48
# Cut from 30 for the script's time budget.
GANG_RESUME_ROUNDS = 10


def _steady(times, first_chunk: int = 1) -> float:
    """Mean seconds a round after the first chunk."""
    import numpy as np

    return float(np.mean(times[first_chunk:]))


def run_gang(label, config, exchange, expect, opts=None) -> dict:
    """Phase 4, a gang: ``config`` through the port's CLI on the card (its
    ``sweep:`` block through ``cli.sweep``, else ``cli.run(...,
    num_seeds=GANG_SEEDS)``), the counters set to 0 just before and read
    just after: every kernel of ``expect`` launched its per-round count
    times the members every round, no other kernel, no plain version, and
    every member's history with the single run's keys, finite
    (``opts["num_seeds"]`` members through ``run --seeds``, default
    GANG_SEEDS).  Unless ``opts["singles"]`` is False, each member then
    runs alone (``cli.run``, its seed, the sweep block dropped) in the same
    call: the members' launches must sum to the gang's, and each member's
    history must agree with its single run's to a scaled 1e-4
    (bit-equality printed); under DMTT each member's final trust state
    (``dmtt_c_hat``, ``dmtt_alpha``, ``dmtt_beta``) within
    DMTT_TRUST_RTOL of its single run's and its mean topology trust column
    too, the TopB masks' equality printed.  Prints the gang's steady
    seconds a round beside the members' summed, and the peak device memory
    of both (a recorded number: no claim)."""
    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch import cli

    opts = opts or {}
    rounds = opts.get("rounds", SMOKE_ROUNDS)
    name = label.replace(":", "_")
    raw, cfg, out = smoke_config(name, config, exchange, None, opts)
    swept = raw.get("sweep") is not None
    chunk = (raw.get("tpu") or {}).get("rounds_per_dispatch", 1)
    mods = _kernel_modules()
    sync_events: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if chunk > 1:
            stack.enter_context(sync_free_chunks(sync_events))
        for mod in mods:
            mod.reset_counts()
        t0 = time.perf_counter()
        if swept:
            histories, gang = cli.sweep(cfg, output=out, device="cuda")
        else:
            histories, gang = cli.run(cfg, output=out, device="cuda",
                                      num_seeds=opts.get("num_seeds", GANG_SEEDS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    size = gang.gang_size
    for kernel, (per_round, _) in expect.items():
        if launches[kernel] != per_round * rounds * size:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times in {rounds} "
                                 f"rounds of {size} members (want {per_round} a member a round)")
    stray = {k: v for k, v in launches.items() if v and k not in expect}
    if any(plain.values()) or stray:
        raise AssertionError(f"plain versions {plain} or stray kernels {stray} on a gang run")
    for member, hist in histories.items():
        if len(hist["round"]) != rounds or not all(
                np.all(np.isfinite(np.asarray(v, dtype=np.float64))) for v in hist.values() if v):
            raise AssertionError(f"member {member}'s history is short or not finite")
    if not torch.isfinite(gang.flats).all():
        raise AssertionError("a member's final parameters are not finite")
    if sync_events:
        raise AssertionError(f"a fused gang chunk synchronised with the host: {sync_events[:5]}")
    members, shape = gang.members, (gang.program.num_nodes, gang.program.model_dim)
    gang_s = _steady(gang.round_times, chunk)
    rec = {"launches": {k: launches[k] for k in expect}, "s_per_round": gang.round_times,
           "peak_gb": peak_gb, "histories": histories, "gang_size": size}
    dmtt = raw.get("dmtt") is not None
    if dmtt:
        from murmura_tpu_torch.core.rounds import DMTT_STATE_KEYS

        gang_trust = [{k: st[k].cpu() for k in DMTT_STATE_KEYS} for st in gang.agg_states]
    # Dropped before the members run alone, so that their peaks are theirs.
    del gang
    gc.collect()
    torch.cuda.empty_cache()
    note = ""
    if opts.get("singles", True):
        single_s, single_peak, same, deltas, summed = [], [], [], [], {k: 0 for k in expect}
        trust_rel, masks_equal = 0.0, []
        for s_idx, member in enumerate(members):
            one = dict(raw)
            one.pop("sweep", None)
            one["experiment"] = dict(raw["experiment"], seed=member.seed)
            if (one.get("attack") or {}).get("enabled"):
                # The gang's one placement: the base seed's, pinned.
                one["attack"] = dict(one["attack"])
                one["attack"]["params"] = {"seed": raw["experiment"]["seed"],
                                           **(one["attack"].get("params") or {})}
            path = SMOKE_DIR / f"{name}_{member.label}.yaml"
            path.write_text(yaml.safe_dump(one, sort_keys=False))
            torch.cuda.reset_peak_memory_stats()
            for mod in mods:
                mod.reset_counts()
            hist, net = cli.run(path, output=SMOKE_DIR / f"history_{path.stem}.json",
                                device="cuda")
            torch.cuda.synchronize()
            for k in expect:
                summed[k] += next(mod.LAUNCHES[k] for mod in mods if k in mod.LAUNCHES)
            single_s.append(_steady(net.round_times, chunk))
            single_peak.append(torch.cuda.max_memory_allocated() / 1e9)
            same.append(hist == histories[member.label])
            deltas.append(history_delta(histories[member.label], hist))
            if dmtt:
                # The member's trust state against its single run's: the
                # scores within DMTT_TRUST_RTOL, the TopB masks printed.
                for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
                    a, b = gang_trust[s_idx][k].double(), net.agg_state[k].cpu().double()
                    trust_rel = max(trust_rel, float(((a - b).abs() / b.abs().clamp(min=1e-30))
                                                     .max()))
                masks_equal.append(all(torch.equal(gang_trust[s_idx][k], net.agg_state[k].cpu())
                                       for k in ("dmtt_collab", "dmtt_selected")))
                col = "agg_dmtt_mean_topo_trust"
                a, b = np.asarray(histories[member.label][col]), np.asarray(hist[col])
                trust_rel = max(trust_rel, float(np.max(np.abs(a - b) / np.abs(b))))
            del net
        gc.collect()
        torch.cuda.empty_cache()
        ok = (summed == {k: launches[k] for k in expect} and max(deltas) <= 1e-4
              and trust_rel <= DMTT_TRUST_RTOL)
        if dmtt:
            note = (f"; each member's dmtt_c_hat, dmtt_alpha, dmtt_beta and mean topology "
                    f"trust within {trust_rel:.3g} relative of its single run's (limit "
                    f"{DMTT_TRUST_RTOL:g}), TopB masks equal {masks_equal}")
            rec.update(trust_rel=trust_rel, masks_equal=masks_equal)
        note += (f"; the members run one by one in this call: launches {summed} (the gang's "
                f"{'==' if summed == rec['launches'] else '!='} their sum), steady s/round "
                f"{', '.join(f'{s:.4f}' for s in single_s)}, summed {sum(single_s):.4f} against "
                f"the gang's {gang_s:.4f} ({sum(single_s) / gang_s:.2f}x; recorded, no claim), "
                f"peak {max(single_peak):.2f} GB alone; each member's history bit-equal to its "
                f"single run {same}, scaled delta {max(deltas):.3g} (limit 1e-4)")
        rec.update(single_s=single_s, summed_single_s=sum(single_s), bit_equal=same,
                   delta=max(deltas), single_peak_gb=max(single_peak))
        if not ok:
            raise AssertionError(f"the gang {label} differs from its members run alone")
    kernels = (f"launches {launches} (want {expect} a member a round)" if expect else
               f"no kernel launched, as none should be (launch counters {launches})")
    print(f"[gang:{label}] {size} members {[m.label for m in members]}, N="
          f"{shape[0]} P={shape[1]}, {rounds} rounds, chunks of "
          f"{chunk}; {kernels}, plain-version calls "
          f"{plain}; round seconds {[round(t, 4) for t in rec['s_per_round']]}, steady s/round "
          f"{gang_s:.4f}; run wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB{note}",
          flush=True)
    return rec


def run_gang_kill_resume() -> dict:
    """Phase 4, a gang's durability: sweep_seeds.yaml (4 members, chunks of
    5) under resumable_run.yaml's durability:, compression: (int8, error
    feedback) and telemetry: sections, GANG_RESUME_ROUNDS rounds, a snapshot
    every 5: first uninterrupted (run_gang), then through ``python -m
    murmura_tpu_torch sweep`` in a subprocess, SIGKILLed once meta.json
    names round 5 or later, and the same command again, which resumes all
    members.  The resumed process must launch the distance kernel twice a
    member a round for the rounds it ran and no plain version, and every
    member's history must be bit-equal to the uninterrupted gang's; each
    member's telemetry stream appended with one ``run_resumed``."""
    from murmura_tpu_torch.telemetry.writer import events_of_type

    kernel = "pairwise_sq_distances"
    opts = {"rounds": GANG_RESUME_ROUNDS, "sections": RESUME_SECTIONS, "singles": False}
    ref = run_gang("krum:gang_durable", SWEEP_SEEDS, None, {kernel: (2, "==")}, opts)
    name = "krum_gang_killed"
    raw, cfg, out = smoke_config(name, SWEEP_SEEDS, None, None, opts)
    ckpt, run_dir = Path(raw["durability"]["checkpoint_dir"]), Path(raw["telemetry"]["dir"])
    cmd = [sys.executable, "-c", _CLI_WITH_COUNTS, "sweep", str(cfg), "--device", "cuda",
           "-o", str(out)]
    t0 = time.perf_counter()
    with open(SMOKE_DIR / f"{name}.killed.log", "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and _snapshot_round(ckpt) < 5:
                time.sleep(0.005)
            running = proc.poll() is None
            proc.kill()
        finally:
            proc.wait()
    killed_s = time.perf_counter() - t0
    stopped = _snapshot_round(ckpt)
    if not running:
        raise AssertionError(f"the gang exited ({proc.returncode}) before it could be killed")
    t0 = time.perf_counter()
    resumed = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    resumed_s = time.perf_counter() - t0
    (SMOKE_DIR / f"{name}.resumed.log").write_text(resumed.stdout + resumed.stderr)
    if resumed.returncode != 0:
        raise AssertionError(f"the resumed gang failed: {resumed.stderr[-3000:]}")
    if f"from round {stopped}" not in resumed.stdout:
        raise AssertionError(f"the gang did not resume from round {stopped}")
    counts = json.loads(resumed.stdout.rsplit("COUNTS ", 1)[1].splitlines()[0])
    size = ref["gang_size"]
    want = 2 * size * (GANG_RESUME_ROUNDS - stopped)
    stray = {k: v for k, v in counts["launches"].items() if v and k != kernel}
    if counts["launches"][kernel] != want or any(counts["plain"].values()) or stray:
        raise AssertionError(f"the resumed gang's counts {counts}, want {kernel} {want}")
    got = json.loads(out.read_text())
    same = got == ref["histories"]
    seams = []
    for label in got:
        runs = [e["status"] for e in events_of_type(run_dir / label, "run")]
        seams.append(runs == ["started", "resumed"]
                     and len(events_of_type(run_dir / label, "run_resumed")) == 1)
    ok = same and all(seams)
    print(f"[gang:resume] sweep_seeds.yaml under resumable_run.yaml's durability:, "
          f"compression: and telemetry: sections, {size} members, {GANG_RESUME_ROUNDS} rounds in "
          f"chunks of 5, a snapshot every 5: killed (SIGKILL) after {killed_s:.2f} s with the "
          f"snapshot at round {stopped}, resumed in {resumed_s:.2f} s (process wall); {kernel} "
          f"launched {counts['launches'][kernel]} times in the {GANG_RESUME_ROUNDS - stopped} "
          f"resumed rounds (want {want}), plain-version calls {sum(counts['plain'].values())}; "
          f"every member's history bit-equal to the uninterrupted gang's: {same}; each "
          f"member's telemetry stream started, resumed, one run_resumed: {all(seams)}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("the resumed gang differs from the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(SMOKE_DIR / "ckpts" / "krum_gang_durable", ignore_errors=True)
    return {"krum:gang_durable": ref,
            "krum:gang_resumed": {"launches": {kernel: counts["launches"][kernel]},
                                  "stopped": stopped, "bit_equal": same}}


def run_gangs() -> dict:
    """Phase 4's gangs: sweep_seeds.yaml as committed (fused chunks of 5)
    with its members alone, the same sweep per round (its histories against
    the fused gang's: bit-equality printed, a scaled 1e-4 gated), the
    flagship as a gang of GANG_SEEDS seeds in both exchanges (3 rounds)
    with its members alone, and the killed and resumed gang."""
    gangs = {}
    sweep_rounds = 10
    gangs["krum:gang_sweep_seeds"] = run_gang(
        "krum:gang_sweep_seeds", SWEEP_SEEDS, None, {"pairwise_sq_distances": (2, "==")},
        {"rounds": sweep_rounds})
    gangs["krum:gang_sweep_seeds_per_round"] = run_gang(
        "krum:gang_sweep_seeds_per_round", SWEEP_SEEDS, None,
        {"pairwise_sq_distances": (2, "==")},
        {"rounds": sweep_rounds, "singles": False,
         "sections": {"tpu": {"rounds_per_dispatch": 1}}})
    fused = gangs["krum:gang_sweep_seeds"]["histories"]
    per_round = gangs["krum:gang_sweep_seeds_per_round"]["histories"]
    delta = max(history_delta(fused[k], per_round[k]) for k in fused)
    print(f"[gang:sweep_seeds] per round against fused in chunks of 5: every member's history "
          f"bit-equal {fused == per_round}, scaled delta {delta:.3g} (limit 1e-4): "
          f"{'ok' if delta <= 1e-4 else 'FAILED'}", flush=True)
    if delta > 1e-4:
        raise AssertionError("the per-round gang differs from the fused one")
    for exchange, kernel in (("allgather", "pairwise_sq_distances"),
                             ("ppermute", "circulant_sq_distances")):
        label = f"krum:gang_flagship_{exchange}"
        gangs[label] = run_gang(label, FLAGSHIP, exchange, {kernel: (2, "==")},
                                {"max_samples": GANG_MAX_SAMPLES})
    gangs.update(run_gang_kill_resume())
    return gangs


# The kernel a frontier cell's rule launches, and how often a round and a
# member (the dense cells take the pairwise pass, the sparse ones the
# circulant pass at the exponential offsets; the medians and fedavg none).
FRONTIER_LAUNCHES = {"krum": 2, "balance": 1}
# The flagship-width frontier: the flagship's scenario under a frontier:
# block, backend: simulation (a sparse gang is refused on backend: tpu),
# so its cells run in float32.
FLAGSHIP_FRONTIER = {"rules": ["krum", "balance"], "attacks": ["alie", "gaussian"],
                     "topologies": ["dense", "sparse"], "points": 2, "seeds": [7],
                     "stages": 2, "rounds": 3}
# The artifact's keys (the JAX package's run_frontier writes these).
FRONTIER_KEYS = {"schema_version", "generated_by", "experiment", "grid", "cells"}
FRONTIER_CELL_KEYS = {"rule", "attack", "topology", "percentage", "degree", "benign_accuracy",
                      "curve", "breaking_point", "declared_influence", "stages", "compiles"}


def run_frontier_smoke(label: str, config: Path, frontier=None) -> dict:
    """Phase 4, a frontier: ``config`` (with ``frontier`` as its frontier:
    block and backend: simulation where given) through the port's
    ``frontier`` command (``murmura_tpu_torch.cli.main``, the function
    ``python -m murmura_tpu_torch frontier`` runs), ``-o`` under SMOKE_DIR.
    The counters are set to 0 just before each cell and read just after:
    each cell must launch its rule's kernel (FRONTIER_LAUNCHES) that many
    times a round for each of its members in every stage it ran, no other
    kernel and no plain version; its ``compiles`` must be 1 (the stage
    reset builds nothing).  The artifact must load with the JAX schema's
    keys and ``report --frontier`` must render it.  Prints each cell's
    breaking point, each stage's seconds a round and the total seconds,
    and the run's peak device memory."""
    import io

    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch import cli
    from murmura_tpu_torch import frontier as frontier_mod
    from murmura_tpu_torch.core.gang import GangNetwork

    raw = yaml.safe_load(config.read_text())
    if frontier is not None:
        raw["frontier"] = dict(frontier)
        raw["backend"] = "simulation"
        raw.pop("tpu", None)
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    name = label.replace(":", "_")
    cfg, out = SMOKE_DIR / f"{name}.yaml", SMOKE_DIR / f"{name}.json"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out.unlink(missing_ok=True)
    f = raw["frontier"]
    members = (1 + f["points"]) * len(f["seeds"])
    rounds = f.get("rounds") or raw["experiment"]["rounds"]
    mods = _kernel_modules()
    cells, stages = [], []
    real_cell, real_train = frontier_mod.run_cell, GangNetwork.train

    def counted_cell(*args, **kwargs):
        for mod in mods:
            mod.reset_counts()
        t0 = time.perf_counter()
        cell = real_cell(*args, **kwargs)
        torch.cuda.synchronize()
        cells.append((cell, {k: v for mod in mods for k, v in mod.LAUNCHES.items()},
                      {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()},
                      time.perf_counter() - t0))
        return cell

    def timed_train(self, rounds, *args, **kwargs):
        out_ = real_train(self, rounds, *args, **kwargs)
        stages.append(float(np.mean(self.round_times)))
        return out_

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    frontier_mod.run_cell, GangNetwork.train = counted_cell, timed_train
    t0 = time.perf_counter()
    try:
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            cli.main(["frontier", str(cfg), "-o", str(out)])
    finally:
        frontier_mod.run_cell, GangNetwork.train = real_cell, real_train
    total = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    art = json.loads(out.read_text())
    if set(art) != FRONTIER_KEYS or any(set(c) != FRONTIER_CELL_KEYS for c in art["cells"]):
        raise AssertionError(f"the frontier artifact's keys {sorted(art)} are not the JAX "
                             "schema's")
    launches = {k: 0 for k in ("pairwise_sq_distances", "circulant_sq_distances")}
    lines, k_stage = [], 0
    for (cell, got, plain, secs), c in zip(cells, art["cells"]):
        kernel = ("pairwise_sq_distances" if cell.topology == "dense"
                  else "circulant_sq_distances")
        want = {kernel: FRONTIER_LAUNCHES.get(cell.rule, 0) * members * rounds
                * cell.stages_run}
        stray = {k: v for k, v in got.items() if v and k not in want}
        if got.get(kernel, 0) != want[kernel] or stray or any(plain.values()):
            raise AssertionError(f"frontier cell {cell.rule} x {cell.attack} x {cell.topology}: "
                                 f"launches {got}, plain {plain}, want {want}")
        if c["compiles"] != 1:
            raise AssertionError(f"frontier cell {cell.rule} x {cell.attack} x "
                                 f"{cell.topology}: compiles {c['compiles']}, want 1")
        launches[kernel] += got[kernel]
        bp = c["breaking_point"]
        per_stage = stages[k_stage:k_stage + cell.stages_run]
        k_stage += cell.stages_run
        lines.append(f"{cell.rule} x {cell.attack} x {cell.topology}: held <= "
                     f"{bp['last_held']}, broken at {bp['first_broken']}, benign "
                     f"{c['benign_accuracy']:.3f}, {cell.stages_run} stage(s) s/round "
                     f"{[round(t, 4) for t in per_stage]}, {want[kernel]} launches, "
                     f"{secs:.2f} s")
    rendered = io.StringIO()
    with contextlib.redirect_stdout(rendered):
        cli.main(["report", "--frontier", str(out)])
    if "Breaking point vs declared influence bound" not in rendered.getvalue():
        raise AssertionError("report --frontier did not render the artifact")
    print(f"[frontier:{label}] {len(art['cells'])} cells, {members} members a gang, "
          f"{rounds} rounds fused a stage, compiles 1 in every cell, 0 plain calls, "
          f"launches {launches}; total {total:.2f} s; peak device memory {peak_gb:.2f} GB; "
          f"report --frontier rendered {len(rendered.getvalue().splitlines())} lines",
          flush=True)
    for line in lines:
        print(f"[frontier:{label}] {line}", flush=True)
    return {"launches": launches, "total_s": total, "peak_gb": peak_gb,
            "stage_s": stages, "cells": len(art["cells"])}


# The grid scheduler and the serve daemon.  serve_grid.yaml's buckets, one
# a rule of 10 cells, and the kernel its dense (allgather) round launches a
# member: Krum's two pairwise passes, BALANCE's one; fedavg, the median and
# the trimmed mean none.
SERVE_GRID = ROOT / "examples" / "configs" / "serve_grid.yaml"
GRID_PAIRWISE = {"krum": 2, "balance": 1}
# The flagship at full width under a grid block, ppermute: per round and
# member Krum's two circulant passes, BALANCE's one, the median's one
# candidate select.
FLAGSHIP_GRID = {"rules": ["krum", "median", "balance"], "attacks": ["gaussian"],
                 "topologies": ["dense"], "strengths": [0.0, 1.0], "seeds": [42, 43],
                 "rounds": 2}
FLAGSHIP_GRID_LAUNCHES = {"krum": ("circulant_sq_distances", 2),
                          "balance": ("circulant_sq_distances", 1),
                          "median": ("candidate_select", 1)}
# The daemon's tenants: serve_grid.yaml's base experiment (Krum on the
# 8-16-4 MLP, 12 nodes) as (seed, lr), one fingerprint, two generations in
# a bucket of capacity 2; 12 rounds each (4 as committed) so that the
# SIGKILL lands inside the first generation, a snapshot every round.
DAEMON_TENANTS = ((7, 0.05), (11, 0.02), (13, 0.05))
DAEMON_ROUNDS = 12


def _run_cli(argv) -> str:
    """``cli.main(argv)`` in this process; returns what it printed."""
    import io

    from murmura_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([str(a) for a in argv])
    return out.getvalue()


def run_serve_grid_smoke() -> dict:
    """Phase 4, the grid: serve_grid.yaml as committed through ``python -m
    murmura_tpu_torch grid`` in a subprocess (the process's counters from
    its start): 50 cells in 5 buckets, one a rule of 10 cells in
    ``expand_cells`` order, gangs of 10 at [12, P] of the MLP; ``compiles``
    1 a bucket plus at most one ``nvcc`` build a kernel in the first bucket
    that launches it; the pairwise kernel launched 2 S (Krum) and S
    (BALANCE) times a round, no other kernel, no plain version; finite
    accuracies; the manifest read back through ``report --grid``."""
    import numpy as np
    import torch

    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.flatten import model_dimension
    from murmura_tpu_torch.serve.scheduler import expand_cells

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    out = SMOKE_DIR / "serve_grid.json"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-c", _CLI_WITH_COUNTS, "grid", str(SERVE_GRID), "-o", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    (SMOKE_DIR / "serve_grid.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"the grid command failed: {proc.stderr[-3000:]}")
    counts = _cli_counts(proc.stdout)
    art = json.loads(out.read_text())
    config = load_config(SERVE_GRID)
    g = config.grid
    cells = expand_cells(config, g)
    p = model_dimension(build_model(config.model.factory, dict(config.model.params))
                        .init(torch.Generator().manual_seed(0), "cpu"))
    buckets = art["buckets"]
    plan_ok = ([b["rule"] for b in buckets] == list(g.rules)
               and [b["cells"] for b in buckets]
               == [[c.cell_id for c in cells if c.rule == rule] for rule in g.rules]
               and all(b["gang_size"] == 10 and b["batch"] == 16 for b in buckets)
               and art["total_cells"] == 50 and len(buckets) == 5)
    first, compiles_ok = set(), art["total_compiles"] == sum(b["compiles"] for b in buckets)
    for b in buckets:
        kernels = {"pairwise_sq_distances"} if b["rule"] in GRID_PAIRWISE else set()
        compiles_ok = compiles_ok and 1 <= b["compiles"] <= 1 + len(kernels - first)
        first |= kernels
    rounds = art["grid"]["rounds"]
    want = sum(GRID_PAIRWISE.get(b["rule"], 0) * b["gang_size"] * rounds for b in buckets)
    got = counts["launches"]
    launches_ok = (got["pairwise_sq_distances"] == want and not any(counts["plain"].values())
                   and not any(v for k, v in got.items() if k != "pairwise_sq_distances"))
    finite = all(np.isfinite(c["final_accuracy"]) for c in art["cells"])
    rendered = _run_cli(["report", "--grid", out])
    read_back = ("Buckets (one gang each)" in rendered
                 and all(c["id"] in rendered for c in art["cells"]))
    ok = plan_ok and compiles_ok and launches_ok and finite and read_back
    for b in buckets:
        mean_round = art["cells"][[c["bucket"] for c in art["cells"]].index(b["key"])][
            "phase_times"]["mean_round_s"]
        print(f"[grid:serve_grid] bucket {b['key']} {b['rule']} x {b['attack']} x "
              f"{b['topology']}: {len(b['cells'])} cells ({b['cells'][0]} .. "
              f"{b['cells'][-1]}), gang {b['gang_size']}/{b['batch']} at [12, {p}], "
              f"compiles {b['compiles']}, wall {b['wall_s']:.4f} s, {mean_round:.4f} s a gang "
              f"round", flush=True)
    print(f"[grid:serve_grid] serve_grid.yaml as committed through the grid command: "
          f"{art['total_cells']} cells in {len(buckets)} buckets (the expected partition "
          f"{plan_ok}), total_compiles {art['total_compiles']} (the rule {compiles_ok}); "
          f"pairwise_sq_distances launched {got['pairwise_sq_distances']} times (want {want}), "
          f"plain calls {sum(counts['plain'].values())}; accuracies finite {finite}; "
          f"buckets' wall {sum(b['wall_s'] for b in buckets):.4f} s, process {wall:.2f} s; "
          f"report --grid read it back ({len(rendered.splitlines())} lines): "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("serve_grid.yaml through the grid command failed its checks")
    return {"launches": {"pairwise_sq_distances": got["pairwise_sq_distances"]},
            "buckets_s": sum(b["wall_s"] for b in buckets), "process_s": wall,
            "compiles": art["total_compiles"]}


def run_flagship_grid_smoke() -> dict:
    """Phase 4, the flagship at full width under FLAGSHIP_GRID (ppermute,
    ``training.max_samples`` GANG_MAX_SAMPLES) through the port's ``grid``
    command in this process: 12 cells in 3 buckets, gangs of 4 at
    [16, 6,603,710]; the counters set to 0 just before each bucket's
    rounds and read just after: its kernel (FLAGSHIP_GRID_LAUNCHES) that
    many times a round a member, no other, no plain version; each bucket's
    wall, seconds a gang round and peak memory (from its gang's build)."""
    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch.core.gang import GangNetwork
    from murmura_tpu_torch.utils import factories

    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["tpu"]["exchange"] = "ppermute"
    raw["training"]["max_samples"] = GANG_MAX_SAMPLES
    raw["grid"] = dict(FLAGSHIP_GRID)
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    cfg, out = SMOKE_DIR / "flagship_grid.yaml", SMOKE_DIR / "flagship_grid.json"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out.unlink(missing_ok=True)
    mods = _kernel_modules()
    rows = []
    real_build, real_train = factories.build_gang_from_config, GangNetwork.train

    def measured_build(*args, **kwargs):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return real_build(*args, **kwargs)

    def counted_train(self, rounds, *args, **kwargs):
        for mod in mods:
            mod.reset_counts()
        t0 = time.perf_counter()
        hist = real_train(self, rounds, *args, **kwargs)
        torch.cuda.synchronize()
        rows.append({"wall": time.perf_counter() - t0,
                     "s_round": float(np.mean(self.round_times)),
                     "launches": {k: v for m in mods for k, v in m.LAUNCHES.items()},
                     "plain": {k: v for m in mods for k, v in m.PLAIN_CALLS.items()},
                     "shape": tuple(self.flats.shape), "dtype": str(self.flats.dtype),
                     "gang_size": self.gang_size, "rounds": rounds,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        return hist

    factories.build_gang_from_config, GangNetwork.train = measured_build, counted_train
    t0 = time.perf_counter()
    try:
        printed = _run_cli(["grid", cfg, "-o", out])
    finally:
        factories.build_gang_from_config, GangNetwork.train = real_build, real_train
    total = time.perf_counter() - t0
    art = json.loads(out.read_text())
    buckets = art["buckets"]
    ok = (art["total_cells"] == 12 and [b["rule"] for b in buckets] == FLAGSHIP_GRID["rules"]
          and len(rows) == 3 and all(np.isfinite(c["final_accuracy"]) for c in art["cells"]))
    launches = {"circulant_sq_distances": 0, "candidate_select": 0}
    for b, row in zip(buckets, rows):
        kernel, per = FLAGSHIP_GRID_LAUNCHES[b["rule"]]
        want = per * row["gang_size"] * row["rounds"]
        stray = {k: v for k, v in row["launches"].items() if v and k != kernel}
        bucket_ok = (row["launches"][kernel] == want and not stray
                     and not any(row["plain"].values()) and row["gang_size"] == 4
                     and row["shape"] == (4, 16, 6_603_710))
        ok = ok and bucket_ok
        launches[kernel] += row["launches"][kernel]
        print(f"[grid:flagship] bucket {b['key']} {b['rule']}: gang {row['gang_size']} at "
              f"{list(row['shape'][1:])} {row['dtype']}, {row['rounds']} rounds fused, {kernel} "
              f"launched {row['launches'][kernel]} times (want {want}), plain "
              f"{sum(row['plain'].values())}, compiles {b['compiles']}; wall {b['wall_s']:.3f} s, "
              f"{row['s_round']:.4f} s a gang round; peak device memory {row['peak_gb']:.2f} GB: "
              f"{'ok' if bucket_ok else 'FAILED'}", flush=True)
    print(f"[grid:flagship] the flagship under a grid block (ppermute, max_samples "
          f"{GANG_MAX_SAMPLES}): {art['total_cells']} cells in {len(buckets)} buckets, "
          f"total_compiles {art['total_compiles']}, {total:.2f} s in all (the buckets' wall "
          f"{sum(b['wall_s'] for b in buckets):.3f} s); the grid command printed "
          f"{len(printed.splitlines())} lines: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("the flagship-width grid failed its checks")
    return {"launches": launches, "total_s": total,
            "s_round": [r["s_round"] for r in rows], "peak_gb": max(r["peak_gb"] for r in rows)}


def _wait_for(pred, timeout: float, what: str, proc=None) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited ({proc.returncode})")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.002)


def _answers(sock: str) -> bool:
    """Whether a daemon answers a ping on ``sock`` (a killed daemon leaves
    its socket file behind)."""
    from murmura_tpu_torch.serve.protocol import send_request

    try:
        return bool(send_request(sock, {"op": "ping"}, retries=0, timeout=5.0)["ok"])
    except OSError:
        return False


def _start_daemon(tag: str, cfg: Path):
    log = open(SMOKE_DIR / f"serve_{tag}.log", "a")
    proc = subprocess.Popen([sys.executable, "-m", "murmura_tpu_torch", "serve", str(cfg)],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def _records(state: Path) -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in sorted((state / "submissions").glob("*.json"))}


def run_serve_daemon_smoke() -> dict:
    """Phase 4, the serve daemon on the card, as ``python -m
    murmura_tpu_torch serve`` subprocesses on serve_grid.yaml's base
    experiment with a serve: block (capacity 2, a snapshot every round):
    a reference daemon runs DAEMON_TENANTS (one fingerprint, two
    generations or more) to the end; a second, given the first two, is
    SIGKILLed once its first generation's first snapshot landed and started
    again over the same state dir, which recovers that generation; the
    third tenant reaches it through the ``submit`` command.  Every submission must end ``done`` with Krum's decisions
    equal to the reference's and the histories within a scaled 1e-4
    (bit-equality printed: a new process may take another cuDNN
    algorithm); the second generation's tenant must record no build.
    Then ``metrics`` (ending ``# EOF``), ``top --iterations 1``, ``runs``
    and ``report --trace`` read the live daemon and its state dir, and
    ``validate_spans`` holds on the trace.  Prints the admission latency
    (``admitted`` to the tenant's first round) and the recovery time."""
    import yaml

    from murmura_tpu_torch.serve.protocol import send_request
    from murmura_tpu_torch.telemetry.spans import build_spans, validate_spans
    from murmura_tpu_torch.telemetry.writer import iter_events

    base = yaml.safe_load(SERVE_GRID.read_text())
    base.pop("grid")
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)

    def setup(tag):
        state = SMOKE_DIR / f"serve_{tag}"
        shutil.rmtree(state, ignore_errors=True)
        raw = dict(base, serve={"state_dir": str(state), "capacity": 2, "checkpoint_every": 1,
                                "poll_interval_s": 0.02})
        cfg = SMOKE_DIR / f"serve_{tag}.yaml"
        cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
        (SMOKE_DIR / f"serve_{tag}.log").unlink(missing_ok=True)
        return state, cfg, str(state / "daemon.sock")

    tenants = []
    for seed, lr in DAEMON_TENANTS:
        raw = yaml.safe_load(yaml.safe_dump(base))
        raw["experiment"].update(name=f"tenant-{seed}", seed=seed, rounds=DAEMON_ROUNDS)
        raw["training"]["lr"] = lr
        tenants.append(raw)
    procs = []

    def finish(sock, proc, log):
        send_request(sock, {"op": "shutdown"}, retries=2)
        proc.wait(timeout=120)
        log.close()

    def wait_done(sock, proc):
        _wait_for(lambda: all(r["state"] in ("done", "failed", "evicted") for r in
                              send_request(sock, {"op": "list"})["submissions"])
                  and len(send_request(sock, {"op": "list"})["submissions"]) == 3,
                  600, "the daemon's submissions", proc)

    try:
        # The reference daemon, uninterrupted.
        ref_state, ref_cfg, ref_sock = setup("ref")
        proc, log = _start_daemon("ref", ref_cfg)
        procs.append(proc)
        t0 = time.perf_counter()
        _wait_for(lambda: _answers(ref_sock), 300, "the reference daemon's socket", proc)
        bound_s = time.perf_counter() - t0
        for raw in tenants:
            send_request(ref_sock, {"op": "submit", "config": raw})
        wait_done(ref_sock, proc)
        ref_ping = send_request(ref_sock, {"op": "ping"})
        finish(ref_sock, proc, log)
        ref = _records(ref_state)

        # The victim: SIGKILLed after its first snapshot, started again.
        state, cfg, sock = setup("victim")
        proc, log = _start_daemon("victim", cfg)
        procs.append(proc)
        _wait_for(lambda: _answers(sock), 300, "the daemon's socket", proc)
        fp = [send_request(sock, {"op": "submit", "config": raw})["bucket"]
              for raw in tenants[:2]][0]
        meta = state / "buckets" / fp / "gen_1" / "meta.json"
        _wait_for(meta.exists, 300, "the first generation's snapshot", proc)
        proc.kill()
        proc.wait()
        log.close()
        killed_round = _snapshot_round(meta.parent)
        at_kill = {k: r["state"] for k, r in _records(state).items()}
        t0 = time.perf_counter()
        proc, log = _start_daemon("victim", cfg)
        procs.append(proc)
        _wait_for(lambda: _answers(sock), 300, "the revived daemon's socket", proc)
        rebound_s = time.perf_counter() - t0
        # The third tenant through the submit command, into the revived daemon.
        path = SMOKE_DIR / "serve_tenant_3.yaml"
        path.write_text(yaml.safe_dump(tenants[2], sort_keys=False))
        sub = subprocess.run([sys.executable, "-m", "murmura_tpu_torch", "submit", str(path),
                              "--socket", sock], cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        if sub.returncode != 0 or f"submitted sub-00003 (bucket {fp})" not in sub.stdout:
            raise AssertionError(f"submit failed: {sub.stdout[-2000:]} {sub.stderr[-2000:]}")
        wait_done(sock, proc)
        recovered_s = time.perf_counter() - t0
        got = _records(state)

        # The observability plane over the live daemon and its state dir.
        metrics = _run_cli(["metrics", sock])
        top = _run_cli(["top", "--socket", sock, "--iterations", "1"])
        runs = _run_cli(["runs", state])
        ping = send_request(sock, {"op": "ping"})
        run_dir = state / "telemetry" / "sub-00001"
        trace = SMOKE_DIR / "serve_trace.json"
        traced = _run_cli(["report", run_dir, "--trace", trace])
        finish(sock, proc, log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    states_ok = all(r["state"] == "done" for r in got.values()) and len(got) == 3
    decisions_ok, bit_equal, delta = True, True, 0.0
    for sub_id, rec in got.items():
        a, b = rec["history"], ref[sub_id]["history"]
        for k in ("agg_selected_index", "agg_selected_own"):
            decisions_ok = decisions_ok and a[k] == b[k]
        bit_equal = bit_equal and a == b
        delta = max(delta, history_delta(a, b))
    # The later generation(s) ran on the warm bucket the recovery rebuilt.
    gen2 = [k for k, r in got.items() if r["gen"] >= 2]
    gen2_built = [json.loads((state / "telemetry" / k / "manifest.json").read_text())
                  ["counters"] for k in gen2]
    no_build = bool(gen2) and all(not c for c in gen2_built)
    total = sum(e["wall_s"] for e in iter_events(run_dir) if e["type"] == "phase_times")
    problems = validate_spans(build_spans(run_dir), phase_total=total)
    chrome = json.loads(trace.read_text())
    plane_ok = (metrics.rstrip().endswith("# EOF") and "murmura_rounds_total{tenant=\"sub-00003\"}"
                in metrics and "murmura top — pid" in top and "sub-00003" in top
                and sum(" submission " in line for line in runs.splitlines()) == 3
                and "trace span(s)" in traced
                and not problems and chrome["traceEvents"])

    def admission(sub_id):
        """From the tenant's submission, or the end of the generation
        before its own (whichever is later; a recovered tenant: its
        ``resumed`` event), to the start of its first round: the member
        programs' build, the writers and the splice into the lanes."""
        events = list(iter_events(state / "telemetry" / sub_id))
        t0 = [e["t"] for e in events if e["type"] == "serve"
              and e["event"] in ("submitted", "resumed")][-1]
        gen = got[sub_id]["gen"]
        t0 = max([t0] + [e["t"] for k, r in got.items() if r["gen"] == gen - 1
                         for e in iter_events(state / "telemetry" / k)
                         if e["type"] == "serve" and e["event"] == "generation_done"])
        first = [e for e in events if e["type"] == "phase_times" and e["t"] > t0][0]
        return first["t"] - first["wall_s"] - t0

    ok = states_ok and decisions_ok and delta <= 1e-4 and no_build and plane_ok
    print(f"[serve:daemon] serve_grid.yaml's base experiment as {len(tenants)} tenants "
          f"({DAEMON_ROUNDS} rounds, capacity 2, a snapshot every round), the reference "
          f"daemon's socket bound in {bound_s:.2f} s, its lifetime counters "
          f"{ref_ping['counters']}; the victim SIGKILLed with generation 1's snapshot at round "
          f"{killed_round} (ledger then {at_kill}), started again: socket bound in "
          f"{rebound_s:.2f} s, every submission done {recovered_s:.2f} s after the restart "
          f"({states_ok}); "
          f"lifetime counters after recovery {ping['counters']}; Krum's decisions equal the "
          f"reference's {decisions_ok}, histories bit-equal {bit_equal}, scaled delta "
          f"{delta:.3g} (limit 1e-4); the later generation ({gen2}) recorded no build "
          f"{no_build}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    print(f"[serve:daemon] admission latency (submitted, or the previous generation's end, or "
          f"resumed, to the first round's start): "
          + ", ".join(f"{k} {admission(k):.4f} s (gen {got[k]['gen']})" for k in got)
          + f"; metrics {len(metrics.splitlines())} lines ending # EOF, top "
          f"{len(top.splitlines())} lines, runs {len(runs.splitlines())} rows, report --trace "
          f"{len(chrome['traceEvents'])} events, validate_spans {problems or 'clean'}",
          flush=True)
    (SMOKE_DIR / "serve_metrics.prom").write_text(metrics)
    if not ok:
        raise AssertionError("the serve daemon failed its checks")
    return {"recovered_s": recovered_s, "rebound_s": rebound_s, "bit_equal": bit_equal,
            "delta": delta, "admission_s": {k: admission(k) for k in got}}


def run_flagship_daemon_smoke() -> dict:
    """Phase 4, one flagship-width daemon in this process (allgather,
    ``training.max_samples`` GANG_MAX_SAMPLES, 2 rounds, capacity 2): a
    first generation of two tenants builds the bucket; a second of the
    same two tenants builds nothing (the daemon's ``_compile_count``
    unchanged), its
    second lane evicted after round 1 (``freeze_member``): the first
    lane's history must equal its run in the first generation (decisions
    equal, a scaled 1e-4, bit-equality printed), the evicted one stop at
    round 1; the counters set to 0 around the second generation: Krum's
    pairwise pass twice a round for both lanes (the frozen one computes),
    no plain version."""
    import torch
    import yaml

    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.serve.daemon import ServeDaemon

    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["training"]["max_samples"] = GANG_MAX_SAMPLES
    raw["experiment"].update(rounds=2, verbose=False)
    state = SMOKE_DIR / "serve_flagship"
    shutil.rmtree(state, ignore_errors=True)
    tenants = []
    for seed, lr in ((42, raw["training"]["lr"]), (43, raw["training"]["lr"] * 0.5)):
        t = yaml.safe_load(yaml.safe_dump(raw))
        t["experiment"].update(seed=seed, name=f"flagship-{seed}")
        t["training"]["lr"] = lr
        tenants.append(t)
    daemon_raw = dict(raw, serve={"state_dir": str(state), "capacity": 2,
                                  "checkpoint_every": 2})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    daemon = ServeDaemon(Config.model_validate(daemon_raw), device="cuda")
    t0 = time.perf_counter()
    first = [daemon.submit_config(t)["id"] for t in tenants]
    daemon.drain()
    gen1_s = time.perf_counter() - t0
    gang = next(iter(daemon._buckets.values()))["gang"]
    built, builds = daemon._compile_count(), gang.program_builds
    second = [daemon.submit_config(t)["id"] for t in tenants]
    real_train = gang.train

    def evicting_train(rounds, **kwargs):
        real_train(rounds=1, **kwargs)
        daemon.evict(second[1], "chip smoke eviction")
        return real_train(rounds=rounds - 1, **kwargs)

    mods = _kernel_modules()
    for mod in mods:
        mod.reset_counts()
    gang.train = evicting_train
    t0 = time.perf_counter()
    try:
        daemon.drain()
    finally:
        del gang.train
    torch.cuda.synchronize()
    gen2_s = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    plain = {k: v for m in mods for k, v in m.PLAIN_CALLS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recs = daemon._ledger
    a, b = recs[second[0]]["history"], recs[first[0]]["history"]
    decisions = all(a[k] == b[k] for k in ("agg_selected_index", "agg_selected_own"))
    delta = history_delta(a, b)
    frozen = json.loads((state / "telemetry" / second[1] / "manifest.json").read_text())
    no_build = daemon._compile_count() == built and gang.program_builds == builds
    want = 2 * 2 * 2
    launches_ok = (launches["pairwise_sq_distances"] == want and not any(plain.values())
                   and not any(v for k, v in launches.items() if k != "pairwise_sq_distances"))
    ok = (no_build and decisions and delta <= 1e-4 and launches_ok
          and recs[second[1]]["state"] == "evicted" and recs[second[0]]["state"] == "done"
          and frozen["history"]["round"] == [1] and gang.member_active == [True, False])
    print(f"[serve:flagship] the flagship as a daemon bucket (allgather, max_samples "
          f"{GANG_MAX_SAMPLES}, 2 tenants x 2 rounds, capacity 2, gang at "
          f"{list(gang.flats.shape)} {gang.flats.dtype}): generation 1 in {gen1_s:.2f} s "
          f"(bucket build included); generation 2 in {gen2_s:.2f} s built nothing {no_build} "
          f"(builds {built}), lane 1 evicted after round 1 (history rounds "
          f"{frozen['history']['round']}), lane 0 against its generation-1 run: decisions "
          f"equal {decisions}, bit-equal {a == b}, scaled delta {delta:.3g} (limit 1e-4); "
          f"pairwise_sq_distances {launches['pairwise_sq_distances']} (want {want}), plain "
          f"{sum(plain.values())}; peak {peak_gb:.2f} GB: {'ok' if ok else 'FAILED'}",
          flush=True)
    del daemon, gang
    shutil.rmtree(state, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the flagship-width daemon failed its checks")
    return {"launches": {"pairwise_sq_distances": launches["pairwise_sq_distances"]},
            "gen1_s": gen1_s, "gen2_s": gen2_s, "peak_gb": peak_gb}


def print_gang_summary(gangs: dict) -> None:
    """Phase 5's gang lines: each gang's steady seconds a round beside its
    members' run alone, summed, and the peaks (recorded, no claim)."""
    for exchange in ("allgather", "ppermute"):
        g = gangs[f"krum:gang_flagship_{exchange}"]
        steady_g = _steady(g["s_per_round"])
        print(f"[gang] the flagship's Krum {exchange} (training.max_samples "
              f"{GANG_MAX_SAMPLES}) as a gang of {g['gang_size']}: steady s/round {steady_g:.4f} "
              f"against its members alone {g['summed_single_s']:.4f} summed "
              f"({g['summed_single_s'] / steady_g:.2f}x), peak {g['peak_gb']:.2f} GB against "
              f"{g['single_peak_gb']:.2f} GB for one member alone; launches "
              f"{g['launches']} in {SMOKE_ROUNDS} rounds; recorded, no claim", flush=True)
    sg = gangs["krum:gang_sweep_seeds"]
    print(f"[gang] sweep_seeds.yaml, {sg['gang_size']} members fused in chunks of 5: steady "
          f"s/round {_steady(sg['s_per_round'], 5):.4f} against its members alone "
          f"{sg['summed_single_s']:.4f} summed; recorded, no claim", flush=True)


def _inject_cpu_draws(network, seed: int, log: list, noise: bool = False):
    """Replace ``network``'s round step by one that feeds it the draws the
    CPU's round generators give (the shuffle key, and with ``noise`` the
    attack's normal draw) and appends each round's (round, agg_state,
    metrics) to ``log``, on the host.  The card and CPU programs then train
    on the same draws."""
    import dataclasses

    import torch

    from murmura_tpu_torch.core.rounds import round_generators

    prog = network.program
    step = prog.train_step
    shape = tuple(prog.data["mask"].shape)
    n_comp = int(network.compromised.sum())

    def wrapped(flat, agg_state, adj, compromised, round_idx, **kwargs):
        gens = round_generators(seed, int(round_idx), "cpu")
        draws = {"u": [torch.rand(shape, generator=gens["train"])]}
        if noise:
            draws["noise"] = torch.randn((n_comp, prog.model_dim), generator=gens["attack"])
        out = step(flat, agg_state, adj, compromised, round_idx, draws=draws, **kwargs)
        log.append((int(round_idx), {k: v.cpu() for k, v in out[1].items()},
                    {k: v.cpu() for k, v in out[2].items()}))
        return out

    network.program = dataclasses.replace(prog, train_step=wrapped)


def _spread_rows(flat, seed: int = 0):
    """Every node near node 0's row at distinct scales: decisions off
    float32 ties (the parity tests' spread)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    base = flat.to(torch.float32).cpu()
    n = base.shape[0]
    scale = 0.05 * (1.0 + torch.arange(n, dtype=torch.float32) / n)[:, None]
    return (base[:1] + scale * torch.randn(base.shape, generator=g)).to(flat.dtype)


# Krum's score noise on the card: the circulant kernel's limit, relative.
KRUM_SCORE_EPS = 1e-5


def check_population_against_cpu(rounds: int = 3, device: str = "cuda") -> dict:
    """Phase 4: population_1m.yaml over ``rounds`` rounds (one swap a
    round) on the card and on the CPU, from one spread initial state (the
    first swap teleports it into every slot) on the CPU's draws: the
    cohorts equal; Krum's picks equal on every node, or, where one
    differs, the two devices' winning scores within KRUM_SCORE_EPS of each
    other (tie-aware); the bank's activation equal and its rows, the
    history and the parameters within a scaled 1e-4 (held when no pick
    differed)."""
    import numpy as np
    import torch

    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.utils.factories import build_network_from_config

    config = load_config(POPULATION_1M)
    config.experiment.rounds = rounds
    config.experiment.verbose = False
    nets = {"card": build_network_from_config(config, device=device),
            "cpu": build_network_from_config(config, device="cpu")}
    spread = _spread_rows(nets["cpu"].flat)
    logs, cohorts = {}, {}
    for dev, net in nets.items():
        net.flat = spread.to(net.device)
        logs[dev], cohorts[dev] = [], []
        _inject_cpu_draws(net, config.experiment.seed, logs[dev])
        swap = net._swap_to

        def recorded(draw_idx, round_idx, net=net, swap=swap, dev=dev):
            swap(draw_idx, round_idx)
            cohorts[dev].append(np.array(net.cohort))

        net._swap_to = recorded
    t0 = time.perf_counter()
    nets["card"].train(rounds)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nets["cpu"].train(rounds)
    cpu_s = time.perf_counter() - t0
    card, cpu = nets["card"], nets["cpu"]
    same_cohorts = (len(cohorts["card"]) == len(cohorts["cpu"]) == rounds
                    and all(np.array_equal(a, b) for a, b in zip(cohorts["card"],
                                                                 cohorts["cpu"])))
    differ, ties = 0, True
    for (_, _, ma), (_, _, mb) in zip(logs["card"], logs["cpu"]):
        diff = ma["agg_selected_index"] != mb["agg_selected_index"]
        differ += int(diff.sum())
        sa, sb = ma["agg_krum_score"][diff].double(), mb["agg_krum_score"][diff].double()
        ties = ties and bool(((sa - sb).abs() <= KRUM_SCORE_EPS * sb.abs().clamp(min=1.0)).all())
    same_activation = np.array_equal(card.bank._has_row, cpu.bank._has_row)
    ids = cpu.bank.activated_users
    rows_ref = cpu.bank.rows_of(ids)
    bank_delta = float(np.abs(card.bank.rows_of(ids) - rows_ref).max()
                       / max(1.0, float(np.abs(rows_ref).max())))
    hist_delta = history_delta(card.history, cpu.history)
    flat_delta = float((card.flat.cpu().double() - cpu.flat.double()).abs().max()
                       / max(1.0, float(cpu.flat.double().abs().max())))
    close = max(bank_delta, hist_delta, flat_delta) <= 1e-4
    ok = same_cohorts and same_activation and ties and (close or differ > 0)
    print(f"[population:card_vs_cpu] population_1m.yaml, {rounds} rounds across {rounds} "
          f"swaps, one spread initial state, the CPU's draws: cohorts equal {same_cohorts}; "
          f"Krum picks differing on {differ} of {rounds * card.program.num_nodes} node-rounds "
          f"(those within the score noise {KRUM_SCORE_EPS:g}: {ties}); activation equal "
          f"{same_activation} ({len(ids):,} users); scaled deltas: bank rows {bank_delta:.3g}, "
          f"history {hist_delta:.3g}, parameters {flat_delta:.3g} (limit 1e-4"
          f"{', not held: a pick differed' if differ else ''}); card {card_s:.2f} s, CPU "
          f"{cpu_s:.2f} s: {'ok' if ok else 'FAILED'}", flush=True)
    for net in nets.values():
        net.bank.close()
    if not ok:
        raise AssertionError("the population run on the card differs from the CPU's")
    return {"cohorts": same_cohorts, "differ": differ, "bank_delta": bank_delta,
            "hist_delta": hist_delta}


# population_1m.yaml under a durability: section for the kill and resume
# (cut from 50 rounds for the script's time budget).
POP_RESUME_ROUNDS, POP_RESUME_EVERY = 20, 5


def _cli_counts(stdout: str) -> dict:
    return json.loads(stdout.rsplit("COUNTS ", 1)[1].splitlines()[0])


def run_population_kill_resume(device: str = "cuda") -> dict:
    """Phase 4: population_1m.yaml as committed (50 rounds) with a snapshot
    every 5 rounds, its 1M-user bank embedded in each snapshot (the bank's
    temporary directory dies with the process): once through ``python -m
    murmura_tpu_torch run`` to the end, once SIGKILLed after a snapshot and
    run again, which resumes.  The resumed history and final snapshot
    (parameters, cohort, bank rows and activation) must be bit-equal to the
    uninterrupted run's, and the resumed process must launch the circulant
    kernel twice a round for the rounds it ran, with no plain call."""
    from murmura_tpu_torch.utils.checkpoint import restore_checkpoint

    opts = {"rounds": POP_RESUME_ROUNDS,
            "sections": {"durability": {"checkpoint_every": POP_RESUME_EVERY,
                                        "resume": True}}}
    runs = {}
    for tag in ("ref", "killed"):
        raw, cfg, out = smoke_config(f"population_{tag}", POPULATION_1M, None, None, opts)
        runs[tag] = (Path(raw["durability"]["checkpoint_dir"]), cfg, out)

    def cmd(tag):
        _, cfg, out = runs[tag]
        return [sys.executable, "-c", _CLI_WITH_COUNTS, "run", str(cfg), "--device", device,
                "--quiet", "-o", str(out)]

    t0 = time.perf_counter()
    ref = subprocess.run(cmd("ref"), cwd=ROOT, capture_output=True, text=True, timeout=900)
    ref_s = time.perf_counter() - t0
    (SMOKE_DIR / "population_ref.log").write_text(ref.stdout + ref.stderr)
    if ref.returncode != 0:
        raise AssertionError(f"the uninterrupted population run failed: {ref.stderr[-3000:]}")
    ckpt = runs["killed"][0]
    t0 = time.perf_counter()
    with open(SMOKE_DIR / "population_killed.log", "w") as log:
        proc = subprocess.Popen(cmd("killed"), cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and _snapshot_round(ckpt) < POP_RESUME_EVERY:
                time.sleep(0.002)
            running = proc.poll() is None
            proc.kill()
        finally:
            proc.wait()
    killed_s = time.perf_counter() - t0
    stopped = _snapshot_round(ckpt)
    if not running:
        raise AssertionError(f"the run exited ({proc.returncode}) before it could be killed")
    t0 = time.perf_counter()
    resumed = subprocess.run(cmd("killed"), cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
    resumed_s = time.perf_counter() - t0
    (SMOKE_DIR / "population_resumed.log").write_text(resumed.stdout + resumed.stderr)
    if resumed.returncode != 0:
        raise AssertionError(f"the resumed population run failed: {resumed.stderr[-3000:]}")
    if f"Resumed from round {stopped}" not in resumed.stdout:
        raise AssertionError(f"the run did not resume from round {stopped}")
    counts = _cli_counts(resumed.stdout)
    want = 2 * (POP_RESUME_ROUNDS - stopped)
    calls = counts["launches"] if device == "cuda" else counts["plain"]
    launches_ok = (calls["circulant_sq_distances"] == want
                   and not any(counts["plain" if device == "cuda" else "launches"].values())
                   and not any(v for k, v in counts["launches"].items()
                               if k != "circulant_sq_distances"))
    hist = json.loads(runs["killed"][2].read_text())
    same_hist = hist == json.loads(runs["ref"][2].read_text())
    a, b = restore_checkpoint(ckpt), restore_checkpoint(runs["ref"][0])
    same_snap = (a[3] == b[3] == POP_RESUME_ROUNDS and bool((a[0] == b[0]).all())
                 and a[6].keys() == b[6].keys()
                 and all(bool((a[6][k] == b[6][k]).all()) for k in a[6])
                 # The bank_path of an embedded bank names each process's
                 # temporary directory.
                 and {**a[7]["population"], "bank_path": None}
                 == {**b[7]["population"], "bank_path": None})
    ok = same_hist and same_snap and launches_ok
    pm = b[7]["population"]
    print(f"[population:resume] population_1m.yaml, {POP_RESUME_ROUNDS} rounds, a snapshot "
          f"every {POP_RESUME_EVERY} (bank {pm['bank_mode']}, {pm['activated']:,} users "
          f"activated at the end): uninterrupted in {ref_s:.2f} s (process wall); killed "
          f"(SIGKILL) after {killed_s:.2f} s with the snapshot at round {stopped}, resumed in "
          f"{resumed_s:.2f} s; circulant_sq_distances launched "
          f"{calls['circulant_sq_distances']} times in the "
          f"{POP_RESUME_ROUNDS - stopped} resumed rounds (want {want}), plain calls "
          f"{sum(counts['plain'].values())}; history bit-equal {same_hist}, final snapshot "
          f"(parameters, cohort, bank rows and activation) bit-equal {same_snap}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    for tag in runs:
        shutil.rmtree(runs[tag][0], ignore_errors=True)
    if not ok:
        raise AssertionError("the resumed population run differs from the uninterrupted one")
    return {"stopped": stopped, "bit_equal": same_hist and same_snap}


# DMTT, card against CPU: rounds compared, and the tolerance of the trust
# state (the card's elementwise kernels may contract a product and a sum
# into one fused multiply-add, one rounding fewer per EMA step).
DMTT_CHECK_ROUNDS = 3
DMTT_TRUST_RTOL = 1e-5
# A TopB pick may differ only where the CPU's collaboration scores of a
# row lie within this of each other at the B-th place (one float32 exp's
# ulp among three terms below 1, a few 1e-8, with room).
DMTT_Q_MARGIN = 1e-5


def _top_b_margins(prev, state, cross, adj, params):
    """Per row, the gap between the B-th and (B+1)-th largest collaboration
    score among the G^t candidates (inf where a row has B or fewer), from
    the trust state before (``prev``) and after (``state``) a round and its
    cross-evaluation, as dmtt_round_update computes them."""
    import torch

    from murmura_tpu_torch.dmtt import protocol as P

    collab = torch.where(prev["dmtt_selected"] > 0, prev["dmtt_collab"], adj) > 0
    exchange = collab & collab.T
    s_model = torch.where(exchange, P.model_score(cross["accuracy"], cross["vacuity"], params),
                          torch.full_like(adj, 0.5))
    t = P.topo_trust(state["dmtt_alpha"], state["dmtt_beta"], params)
    q = P.collab_score(s_model, t, state["dmtt_c_hat"], params)
    n = adj.shape[0]
    cand = (adj > 0) & ~torch.eye(n, dtype=torch.bool)
    out = []
    for i in range(n):
        vals = torch.sort(q[i][cand[i]], descending=True).values
        b = params.budget_B
        out.append(float(vals[b - 1] - vals[b]) if len(vals) > b else float("inf"))
    return out


def check_dmtt_against_cpu(device: str = "cuda") -> dict:
    """Phase 4: dmtt_mobility.yaml (fedavg, the topology liar wrapping
    gaussian std 10, 16 nodes on the mobility graph) over DMTT_CHECK_ROUNDS
    rounds on the card and on the CPU, from the CPU's initial parameters on
    the CPU's draws (the shuffle key and the attack's noise): per round the
    probe cross-evaluation's accuracies, the exchange and collaborator
    masks and the agg_dmtt_* counts equal (a row whose TopB scores lie
    within DMTT_Q_MARGIN at the B-th place may differ: tie-aware), the trust
    state (dmtt_c_hat, dmtt_alpha, dmtt_beta) and the mean topology trust
    within rtol DMTT_TRUST_RTOL, the parameters within a scaled 1e-4."""
    import numpy as np
    import torch

    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.core import rounds as rounds_mod
    from murmura_tpu_torch.utils.factories import build_network_from_config

    config = load_config(DMTT_MOBILITY)
    config.experiment.rounds = DMTT_CHECK_ROUNDS
    config.experiment.verbose = False
    nets = {"card": build_network_from_config(config, device=device),
            "cpu": build_network_from_config(config, device="cpu")}
    nets["card"].flat = nets["cpu"].flat.to(device)
    logs, crosses = {}, {}
    real = rounds_mod.pairwise_probe_eval
    for dev, net in nets.items():
        logs[dev], crosses[dev] = [], []
        _inject_cpu_draws(net, config.experiment.seed, logs[dev], noise=True)

        def capture(bcast, ctx, metric, dev=dev):
            out = real(bcast, ctx, metric)
            crosses[dev].append({k: v.cpu() for k, v in out.items()})
            return out

        rounds_mod.pairwise_probe_eval = capture
        try:
            net.train(DMTT_CHECK_ROUNDS)
        finally:
            rounds_mod.pairwise_probe_eval = real
    from murmura_tpu_torch.dmtt.protocol import init_dmtt_state

    params = nets["cpu"].program.dmtt
    prev = init_dmtt_state(nets["cpu"].program.num_nodes)
    acc_equal, masks_equal, counts_equal, tie_rows = True, True, True, 0
    trust_rel, flat_delta = 0.0, 0.0
    for r in range(DMTT_CHECK_ROUNDS):
        _, sa, ma = logs["card"][r]
        _, sb, mb = logs["cpu"][r]
        ca, cb = crosses["card"][r], crosses["cpu"][r]
        acc_equal = acc_equal and torch.equal(ca["accuracy"], cb["accuracy"])
        diff_rows = (sa["dmtt_collab"] != sb["dmtt_collab"]).any(dim=1)
        if diff_rows.any():
            adj = torch.from_numpy(nets["cpu"].mobility.adjacency_at(r).astype(np.float32))
            margins = _top_b_margins(prev, sb, cb, adj, params)
            tied = all(margins[i] <= DMTT_Q_MARGIN for i in np.flatnonzero(diff_rows.numpy()))
            masks_equal = masks_equal and tied
            tie_rows += int(diff_rows.sum())
        for k in ("agg_dmtt_collab_count", "agg_dmtt_received_count", "agg_num_neighbors"):
            counts_equal = counts_equal and (torch.equal(ma[k], mb[k]) or bool(diff_rows.any()))
        for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
            trust_rel = max(trust_rel, float(((sa[k] - sb[k]).abs()
                                              / sb[k].abs().clamp(min=1e-30)).max()))
        trust_rel = max(trust_rel, float(((ma["agg_dmtt_mean_topo_trust"]
                                           - mb["agg_dmtt_mean_topo_trust"]).abs()
                                          / mb["agg_dmtt_mean_topo_trust"].abs()
                                          .clamp(min=1e-30)).max()))
        prev = sb
    card, cpu = nets["card"], nets["cpu"]
    flat_delta = float((card.flat.cpu().double() - cpu.flat.double()).abs().max()
                       / max(1.0, float(cpu.flat.double().abs().max())))
    ok = (acc_equal and masks_equal and counts_equal and trust_rel <= DMTT_TRUST_RTOL
          and (flat_delta <= 1e-4 or tie_rows > 0))
    print(f"[dmtt:card_vs_cpu] dmtt_mobility.yaml, {DMTT_CHECK_ROUNDS} rounds on G^t, the "
          f"CPU's initial parameters and draws: cross-evaluation accuracies equal {acc_equal}; "
          f"exchange/collaborator masks equal except {tie_rows} row(s) within the TopB margin "
          f"{DMTT_Q_MARGIN:g} ({masks_equal}); agg_dmtt_* counts equal {counts_equal}; trust "
          f"state largest relative difference {trust_rel:.3g} (limit {DMTT_TRUST_RTOL:g}); "
          f"parameters scaled delta {flat_delta:.3g} (limit 1e-4); card history "
          f"collab_count {card.history['agg_dmtt_collab_count']}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("the DMTT round on the card differs from the CPU's")
    return {"trust_rel": trust_rel, "flat_delta": flat_delta, "tie_rows": tie_rows}


# The model surface: the flagship's scenario (16 nodes, k-regular(4), 20%
# gaussian std 10, bfloat16 compute) with its data and model replaced by
# the LEAF Shakespeare char-LSTM (vocab 81, embed 8, hidden 256, 2 layers,
# seq_len 80) and the LEAF CelebA CNN (84x84x3, channels 32-64-128, fc
# 256), each on its adapter's synthetic fallback, training.max_samples
# capped at SURFACE_MAX_SAMPLES, SMOKE_ROUNDS rounds.  The last run is the
# CelebA Krum run under tpu.conv_impl: im2col, held beside the direct one.
SURFACE_MAX_SAMPLES = 64
SHAKESPEARE = {"data": {"adapter": "leaf.shakespeare", "params": {}},
               "model": {"factory": "leaf.shakespeare", "params": {}}}
CELEBA = {"data": {"adapter": "leaf.celeba", "params": {}},
          "model": {"factory": "leaf.celeba", "params": {}}}
SURFACE_RUNS = (
    ("krum:shakespeare", "allgather", None, {"pairwise_sq_distances": (2, "==")}, SHAKESPEARE),
    ("krum:shakespeare_ppermute", "ppermute", None, {"circulant_sq_distances": (2, "==")},
     SHAKESPEARE),
    ("krum:celeba", "allgather", None, {"pairwise_sq_distances": (2, "==")}, CELEBA),
    ("median:celeba_ppermute", "ppermute", {"algorithm": "median", "params": {}},
     {"candidate_select": (1, "==")}, CELEBA),
    ("krum:celeba_im2col", "allgather", None, {"pairwise_sq_distances": (2, "==")},
     {**CELEBA, "sections": {"tpu": {"conv_impl": "im2col"}}}),
)
# The DMTT gang: dmtt_mobility.yaml (DMTT_GANG_ROUNDS rounds) through
# ``run --seeds DMTT_GANG_SEEDS``; its dirichlet shards differ in size between
# seeds, which a gang refuses in both packages, so training.max_samples is
# pinned (every node of seeds 42-44 holds at least 70 training samples).
DMTT_GANG_SEEDS = 3
# 10 of dmtt_mobility.yaml's 30 rounds (cut from 30 for the
# script's time budget).
DMTT_GANG_ROUNDS = 10
DMTT_GANG_MAX_SAMPLES = 64


def check_model_widths(results: dict) -> None:
    """Phase 3 at the two new models' widths, [16, 818,137] (the
    char-LSTM) and [16, 3,370,818] (the CelebA CNN), float32 (the
    parameter dtype at 16 nodes): Krum's four distance calls (k-regular(4)
    offsets), and at the CelebA width the median's candidate select, each
    against its plain version, timed beside its bound.  The phase-4 runs
    of these models make the same calls."""
    import torch

    n, offsets = 16, [1, 2, 14, 15]
    for p, model in ((818_137, "char-LSTM"), (3_370_818, "CelebA CNN")):
        own, bcast = krum_inputs(n, p, p)
        print(f"[kernels] shapes: N={n} P={p} ({model}) offsets={offsets}", flush=True)
        _distance_cases(results, own, bcast, offsets, in_round=False, tag=f" P={p}")
        if p == 3_370_818:
            check_candidate_select(results, own, bcast, offsets, ((torch.float32, True, 0),),
                                   tag=f" P={p}", in_round=False)
        del own, bcast
        torch.cuda.empty_cache()


def check_models_against_cpu(device: str = "cuda") -> dict:
    """Phase 3b for the two new models at full width: one round of dense
    Krum (num_compromised 1, so that it selects) on the card and on the
    CPU from one spread initial state (node 0's parameters plus offsets of
    distinct scales) with injected draws (the shuffle key and the attack's
    noise), float32 compute (in bfloat16 a one-ulp flip of h would carry
    through the 80 recurrent steps), 16 nodes, k-regular(4), the adapter's
    synthetic fallback capped at 8 samples a node (one local step): each
    device trains once (``train_flat``) and its ``train_step`` takes those
    rows (``trained=``).  The picks equal; the post-round parameters within
    a scaled 1e-4 plus the trained rows' own delta (Krum copies a
    candidate, so the rule adds nothing to a training difference; a CNN's
    training can sit at a max-pool or ReLU near-tie, which moves one
    node's update by a discrete step), that delta printed with its node;
    the char-LSTM's tokens int64 on the card."""
    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation.krum import make_krum
    from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.flatten import tree_map

    n, seed, offsets = 16, 7, [1, 2, 14, 15]
    adj = torch.zeros((n, n))
    for o in offsets:
        adj[torch.arange(n), (torch.arange(n) + o) % n] = 1.0
    out = {}
    for name in ("leaf.shakespeare", "leaf.celeba"):
        t0 = time.perf_counter()
        data = build_federated_data(name, {}, num_nodes=n, seed=seed, max_samples=8)
        model = build_model(name, {})
        attack = make_gaussian_attack(n, 0.2, noise_std=10.0, seed=seed)
        comp = torch.from_numpy(attack.compromised.astype(np.float32))
        rng = np.random.default_rng(seed)
        template = model.init(torch.Generator().manual_seed(seed), "cpu")
        scale = 0.05 * (1.0 + np.arange(n) / n)
        init = tree_map(lambda t: (t.numpy()[None] + scale.reshape((n,) + (1,) * t.dim())
                                   * rng.normal(size=(n,) + tuple(t.shape))).astype(np.float32),
                        template)
        kw = {"num_compromised": 1, "max_candidates": len(offsets) + 1}
        res = {}
        for dev in (device, "cpu"):
            prog = build_round_program(model, make_krum(**kw), data, attack=attack,
                                       init_params=init, device=dev, batch_size=8, lr=0.05,
                                       seed=seed)
            if "draws" not in res:
                res["draws"] = {"u": [rng.random(tuple(prog.data["mask"].shape))
                                      .astype(np.float32)],
                                "noise": rng.normal(size=(int(comp.sum()), prog.model_dim))
                                .astype(np.float32)}
            a, c = adj.to(dev), comp.to(dev)
            trained, _ = prog.train_flat(prog.init_flat, prog.init_agg_state, a, c, 0.0,
                                         draws=res["draws"])
            flat, _, metrics = prog.train_step(prog.init_flat, prog.init_agg_state, a, c, 0.0,
                                               draws=res["draws"], trained=trained)
            res[dev] = (trained.cpu(), flat.cpu(), metrics["agg_selected_index"].cpu(),
                        prog.data["x"].dtype, prog.model_dim)
            del prog, trained, flat
        card, cpu = res[device], res["cpu"]

        def scaled(a, b):
            return float((a.double() - b.double()).abs().max()
                         / max(1.0, float(b.abs().max())))

        d_train, d_flat = scaled(card[0], cpu[0]), scaled(card[1], cpu[1])
        node = int((card[0].double() - cpu[0].double()).abs().amax(dim=1).argmax())
        picks = torch.equal(card[2], cpu[2])
        tokens = card[3] == (torch.int64 if "shakespeare" in name else torch.float32)
        limit = 1e-4 + d_train
        ok = picks and d_flat <= limit and tokens
        print(f"[models] {name} krum dense, P={card[4]}, float32, card vs CPU: picks equal "
              f"{picks} {card[2].tolist()}, post-round scaled delta {d_flat:.3g} (limit 1e-4 "
              f"+ the trained rows' {d_train:.3g}, largest at node {node}, "
              f"{'compromised' if comp[node] else 'honest'}, picked by "
              f"{(card[2] == node).sum().item()} node(s)), inputs {card[3]} on the card; "
              f"{time.perf_counter() - t0:.2f} s: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: the card's round differs from the CPU's")
        out[name] = {"delta": d_flat, "train_delta": d_train}
        torch.cuda.empty_cache()
    return out


def run_model_surface() -> dict:
    """Phase 4's model surface (SURFACE_RUNS) through run_main_path, each
    run's wall printed, then the CelebA CNN's im2col run beside its direct
    run: their histories' scaled delta (bfloat16 convolutions against
    bfloat16 products: another rounding, so recorded, not gated) and their
    steady seconds a round."""
    import numpy as np

    runs = {}
    t_all = time.perf_counter()
    for label, exchange, aggregation, expect, opts in SURFACE_RUNS:
        opts = dict(opts, max_samples=SURFACE_MAX_SAMPLES)
        t0 = time.perf_counter()
        runs[label] = run_main_path(label, FLAGSHIP, exchange, aggregation, expect, opts)
        print(f"[models] {label}: {time.perf_counter() - t0:.2f} s of wall", flush=True)
    direct, im2col = runs["krum:celeba"], runs["krum:celeba_im2col"]
    delta = history_delta(im2col["history"], direct["history"])
    print(f"[models] the CelebA CNN, Krum allgather, tpu.conv_impl im2col against direct: "
          f"history scaled delta {delta:.3g} (bfloat16: recorded, not gated), steady s/round "
          f"im2col {np.mean(im2col['s_per_round'][1:]):.4f}, direct "
          f"{np.mean(direct['s_per_round'][1:]):.4f}; peak {im2col['peak_gb']:.2f} GB against "
          f"{direct['peak_gb']:.2f} GB; the surface runs took {time.perf_counter() - t_all:.2f} s",
          flush=True)
    runs["krum:celeba_im2col"]["delta_direct"] = delta
    return runs


def run_dmtt_gang() -> dict:
    """Phase 4's DMTT gang: dmtt_mobility.yaml through ``run --seeds
    DMTT_GANG_SEEDS`` (run_gang: each member also run alone in the call,
    attack.params.seed pinned to the base seed; histories within a scaled
    1e-4, the trust state within DMTT_TRUST_RTOL).  fedavg: no kernel."""
    t0 = time.perf_counter()
    rec = run_gang("fedavg:gang_dmtt_mobility", DMTT_MOBILITY, None, {},
                   {"rounds": DMTT_GANG_ROUNDS, "num_seeds": DMTT_GANG_SEEDS,
                    "max_samples": DMTT_GANG_MAX_SAMPLES})
    print(f"[dmtt] the gang phase took {time.perf_counter() - t0:.2f} s of wall", flush=True)
    return {"fedavg:gang_dmtt_mobility": rec}


# ---------------------------------------------------------------------------
# Param-axis sharding (parallel/): the kernels on column blocks, and
# sharded_model.yaml and bench_scaling.py's acceptance cell in param groups
# on this one card.

SHARDED_MODEL = ROOT / "examples" / "configs" / "sharded_model.yaml"
# Column blocks of the flagship's [16, P] round tensors, as a group of 4
# holds them.
BLOCKS = 4
SHARDED_CHECK_ROUNDS = 5
# bench_scaling.py's --sharded acceptance cell (SHARDED_POINTS[1]): 16
# nodes, the MLP 1000-7200-6200-62 (51.9M parameters a node), Krum, 2
# rounds (3 in bench_scaling.py: cut for the script's time
# budget), batch 4, 8 samples a node, float32, in a group of 8.
ACCEPTANCE_WORLD = 8
ACCEPTANCE = {
    "experiment": {"name": "sharded-krum-16x8", "seed": 7, "rounds": 2},
    "topology": {"type": "k-regular", "num_nodes": 16, "k": 4},
    "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
    "training": {"local_epochs": 1, "batch_size": 4, "lr": 0.05},
    "data": {"adapter": "synthetic",
             "params": {"num_samples": 128, "input_shape": [1000], "num_classes": 62}},
    "model": {"factory": "mlp",
              "params": {"input_dim": 1000, "hidden_dims": [7200, 6200], "num_classes": 62}},
    "backend": "tpu",
    "tpu": {"param_shards": ACCEPTANCE_WORLD, "compute_dtype": "float32",
            "param_dtype": "float32"},
}


def check_column_blocks(results: dict) -> dict:
    """Phase 3, sharded: each of the four kernels on the 4 column blocks of the
    flagship's [16, P] inputs (P padded to a multiple of 4 with zero
    columns, as a param-sharded program pads it), each block a contiguous
    [16, P_pad / 4] tensor, as a rank holds it.  The blocks' results summed
    (pairwise, circulant, count sketch) against the full-width plain
    version within the kernel's limit summed over the blocks (the pairwise
    and sketch limits are sums of per-column norms, so the blocks' limits
    add up to the full width's; the circulant's 1e-5 max(1, |plain_b|)
    per block), and printed beside the full-width kernel call; the
    candidate select's blocks bit-equal to the full-width call's columns.
    Each block call timed (its row in the kernels line, not in a round)."""
    import torch

    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops import agg_kernels as K
    from murmura_tpu_torch.ops import candidate_kernels as C
    from murmura_tpu_torch.ops import sketch_kernels as SK
    from murmura_tpu_torch.ops.flatten import model_dimension, padded_dim
    from murmura_tpu_torch.ops.sketch import build_sketch_tables
    from murmura_tpu_torch.ops.sketch_kernels import SketchTables

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    n, offsets = 16, [1, 2, 14, 15]
    p = model_dimension(build_model("leaf.femnist.baseline", {}).init(
        torch.Generator(device=dev).manual_seed(0), dev))
    p_pad = padded_dim(p, BLOCKS)
    c = p_pad // BLOCKS
    own, bcast = krum_inputs(n, p, 1234)
    own = torch.nn.functional.pad(own, (0, p_pad - p))
    bcast = torch.nn.functional.pad(bcast, (0, p_pad - p))
    cols = [(i * c, (i + 1) * c) for i in range(BLOCKS)]
    blocks = [(own[:, a:b].contiguous(), bcast[:, a:b].contiguous()) for a, b in cols]
    center = own.mean(dim=0)
    centers = [center[a:b].contiguous() for a, b in cols]
    label = f"column block of {BLOCKS} [{n}, {c:,}] (P {p:,} padded to {p_pad:,})"
    print(f"[blocks] {label}", flush=True)
    out = {"p_pad": p_pad, "block": c}

    def summed(fn):
        total = None
        for i in range(BLOCKS):
            part = fn(i)
            total = part if total is None else total + part
        return total

    def verdict(name, max_err, vs_kernel, ok):
        print(f"[blocks] {name}: blocks summed against the full-width plain version "
              f"max |err| {max_err:.6g} (against the full-width kernel call "
              f"{vs_kernel:.6g}): {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} on column blocks disagrees with the full width")

    # Pairwise (own, bcast), centered on own's mean: Krum's second call.
    full = K.pairwise_sq_distances_plain(own, bcast, center=center)
    got = summed(lambda i: K.pairwise_sq_distances(*blocks[i], center=centers[i]))
    sa, sb = ((own - center) ** 2).sum(-1), ((bcast - center) ** 2).sum(-1)
    err = (got - full).abs()
    kern_full = K.pairwise_sq_distances(own, bcast, center=center)
    verdict("pairwise_sq_distances (own, bcast)", float(err.max()),
            float((got - kern_full).abs().max()),
            bool((err <= 1e-5 * (sa[:, None] + sb[None, :])).all()))
    o0, b0 = blocks[0]
    nbytes, flops, tf32 = _pairwise_work(n, n, c, False)
    _record(results, "pairwise_sq_distances", f"(own, bcast) {label}", float(err.max()),
            lambda: K.pairwise_sq_distances(o0, b0, center=centers[0]),
            lambda: K.pairwise_sq_distances_plain(o0, b0, center=centers[0]), None,
            nbytes, flops, in_round=False, tf32_flops=tf32)
    del full, got, err, kern_full
    # Circulant (own, bcast, offsets).
    plains = [K.circulant_sq_distances_plain(o, b, offsets) for o, b in blocks]
    full = K.circulant_sq_distances_plain(own, bcast, offsets)
    got = summed(lambda i: K.circulant_sq_distances(*blocks[i], offsets))
    limit = summed(lambda i: 1e-5 * torch.clamp(plains[i].abs(), min=1.0))
    err = (got - full).abs()
    verdict(f"circulant_sq_distances (own, bcast, {offsets})", float(err.max()),
            float((got - K.circulant_sq_distances(own, bcast, offsets)).abs().max()),
            bool((err <= limit).all()))
    _record(results, "circulant_sq_distances", f"(own, bcast, offsets {offsets}) {label}",
            float(err.max()), lambda: K.circulant_sq_distances(o0, b0, offsets),
            lambda: K.circulant_sq_distances_plain(o0, b0, offsets), None,
            2 * n * c * 4 + len(offsets) * n * 4, 3.0 * len(offsets) * n * c, in_round=False)
    del plains, full, got, limit, err
    # Candidate select: column-local, so each block bit-equal to the full
    # call's columns.
    m = len(offsets) + 1
    for kw, tag in (({"median": True}, "median"), ({"trim": 1}, "trim 1")):
        whole = C.candidate_select(own, bcast, offsets, **kw)
        same = all(torch.equal(C.candidate_select(o, b, offsets, **kw), whole[:, a:e])
                   for (o, b), (a, e) in zip(blocks, cols))
        print(f"[blocks] candidate_select {tag}: every block bit-equal to the full-width "
              f"call's columns: {same}", flush=True)
        if not same:
            raise AssertionError("candidate_select on column blocks differs from the full width")
        _record(results, "candidate_select", f"{tag} {label}", 0.0,
                lambda kw=kw: C.candidate_select(o0, b0, offsets, **kw),
                lambda kw=kw: C.candidate_select_plain(o0, b0, offsets, **kw), None,
                3 * n * c * 4, (m * (m - 1) / 2 + m) * n * c, in_round=False)
        del whole
    # Count sketch: each block with its columns of Sketchguard's tables
    # (S = 1000, seed 42), the [16, S] partials summed.
    tables = build_sketch_tables(p_pad, 1000, 42)
    parts = [SketchTables(tables.hash[a:b], tables.sign[a:b], 1000) for a, b in cols]
    t = tables.plain_on(dev)
    full = SK.count_sketch_plain(own, tables)
    got = summed(lambda i: SK.count_sketch(blocks[i][0], parts[i]))
    scale = torch.zeros((n, 1000), device=dev).index_add_(1, t["hash"], own.abs())
    err = (got - full).abs()
    verdict("count_sketch (own)", float(err.max()),
            float((got - SK.count_sketch(own, tables)).abs().max()),
            bool((err <= 1e-4 * scale).all()))
    nbytes = n * c * 4 + parts[0].entries.nbytes + parts[0].starts.nbytes + n * 1000 * 4
    _record(results, "count_sketch", f"(own) {label}", float(err.max()),
            lambda: SK.count_sketch(o0, parts[0]), lambda: SK.count_sketch_plain(o0, parts[0]),
            None, nbytes, 2.0 * n * c, in_round=False)
    del own, bcast, blocks, o0, b0, full, got, scale, err
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_all
    print(f"[blocks] the column-block checks took {out['seconds']:.2f} s", flush=True)
    return out


def _recording(program, keys, sink: list):
    """Wrap ``program.train_step`` so that each round's ``keys`` metrics
    (per node) land in ``sink`` as numpy arrays."""
    step = program.train_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        sink.append({k: out[2][k].detach().float().cpu().numpy() for k in keys})
        return out

    program.train_step = recording


@contextlib.contextmanager
def _rule_hook(hook):
    """``factories.build_rule`` wrapped while the block runs: the rule it
    builds calls ``hook(aggregate, args, out)`` after every round's call
    (``aggregate`` the unwrapped rule)."""
    import dataclasses

    from murmura_tpu_torch.utils import factories

    real = factories.build_rule

    def build_rule(cfg, model, topology):
        agg, probe = real(cfg, model, topology)

        def aggregate(*args):
            out = agg.aggregate(*args)
            hook(agg.aggregate, args, out)
            return out

        return dataclasses.replace(agg, aggregate=aggregate), probe

    factories.build_rule = build_rule
    try:
        yield
    finally:
        factories.build_rule = real


def _unsharded(config, rounds: int, keep: bool = False) -> dict:
    """``config`` in one process on this card (the unsharded program on the
    padded flat vector; in a rank of a group the caller turns the group
    off first), ``rounds`` rounds one at a time.  Returns the history, the
    round times, the peak device memory, the kernel counts and each
    round's Krum picks; with ``keep``, also what a group's run is held
    against, unpadded, on the host: the round-1 trained rows (the rule's
    ``own``) and the parameters after every round."""
    import torch

    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels
    from murmura_tpu_torch.utils.factories import build_network_from_config

    for mod in (agg_kernels, candidate_kernels, sketch_kernels):
        mod.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    picks, flats, own, dim = [], [], [], []

    def keep_own(_aggregate, args, _out):
        if keep and int(args[3]) == 0:
            own.append(args[0].float().cpu().numpy()[:, :dim[0]])

    with _rule_hook(keep_own):
        net = build_network_from_config(config, device="cuda")
    dim.append(net.program.model_dim)
    _recording(net.program, ("agg_selected_index",), picks)
    for _ in range(rounds):
        net.train(1)
        if keep:
            flats.append(net.flat.float().cpu().numpy()[:, :dim[0]])
    torch.cuda.synchronize()
    out = {"model_dim": net.program.model_dim, "flat_dim": net.program.flat_dim,
           "history": json.loads(json.dumps(net.history)),
           "round_times": list(net.round_times),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": dict(agg_kernels.LAUNCHES),
           "plain": sum(m.PLAIN_CALLS[k] for m in (agg_kernels, candidate_kernels,
                                                   sketch_kernels) for k in m.PLAIN_CALLS),
           "picks": [p_["agg_selected_index"] for p_ in picks]}
    if keep:
        out.update(own=own[0], flats=flats)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _perturbed(config, flats: list) -> list:
    """The yardstick of the chained comparison: ``config`` in one process
    again, its initial parameters each moved by one float32 rounding
    (x (1 + r 2^-23), r = +-1 from a seeded draw), its parameters after
    each round against the unperturbed run's ``flats``, scaled: how far
    the config carries a difference of float32 rounding's size."""
    import torch

    from murmura_tpu_torch.utils.factories import build_network_from_config

    net = build_network_from_config(config, device="cuda")
    g = torch.Generator(device=net.flat.device).manual_seed(0)
    sign = torch.randint(0, 2, net.flat.shape, generator=g, device=net.flat.device) * 2 - 1
    net.flat = net.flat + net.flat * (sign.to(net.flat.dtype) * 2.0 ** -23)
    del sign
    out = []
    for ref in flats:
        net.train(1)
        out.append(_scaled_on(net.flat, ref))
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _scaled_np(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _row_deltas(got, ref):
    """Per row, max |got_i - ref_i| in float64 on ``got``'s device (its first
    ``ref.shape[1]`` columns against the host array ``ref``, a row at a
    time), and the scale max(1, max |ref|)."""
    import numpy as np
    import torch

    rows, den = [], 1.0
    for i in range(ref.shape[0]):
        y = torch.from_numpy(np.array(ref[i], dtype=np.float32)).to(got.device, torch.float64)
        rows.append(float((got[i, :y.shape[0]].double() - y).abs().max()))
        den = max(den, float(y.abs().max()))
        del y
    return rows, den


def _scaled_on(got, ref) -> float:
    """:func:`_scaled_np` of a device tensor against a host array, on the
    device (:func:`_row_deltas`)."""
    rows, den = _row_deltas(got, ref)
    return max(rows) / den


def _chained_check(got, ref, block: int, from_neighbour) -> dict:
    """The parameters after a round (``got``, on the device) against the
    one-process run's (``ref``, on the host), element by element: |got -
    ref| over its bound, 1e-4 max(1, max |ref|) (the parameters' scaled
    1e-4), plus, on a row that took a neighbour's int8-decoded broadcast
    (``from_neighbour[i]``, ``block`` > 0), one code step of its block,
    max |ref block| / 127: a codec input that moved by less than a step can
    round to the adjacent code, which moves the decoded element by a whole
    step.  Returns the scaled distance, the largest ratio and the number
    of elements past the plain 1e-4."""
    import numpy as np
    import torch

    rows, den = _row_deltas(got, ref)
    worst, steps = 0.0, 0
    for i in range(ref.shape[0]):
        y = torch.from_numpy(np.array(ref[i], dtype=np.float32)).to(got.device, torch.float64)
        d = (got[i, :y.shape[0]].double() - y).abs()
        bound = torch.full_like(d, 1e-4 * den)
        if block and from_neighbour[i]:
            pad = -y.shape[0] % block
            amax = torch.nn.functional.pad(y.abs(), (0, pad)).reshape(-1, block).amax(dim=1)
            bound += torch.repeat_interleave(amax / 127.0, block)[:y.shape[0]]
        worst = max(worst, float((d / bound).max()))
        steps += int((d > 1e-4 * den).sum())
        del y, d, bound
    return {"scaled": max(rows) / den, "ratio": worst, "steps": steps}


def _exact_sq(a, b, chunk: int = 1 << 22):
    """[N, M] squared distances between the rows of ``a`` and ``b`` in
    float64 (the Gram identity in float64, P-chunked), as the reference."""
    import torch

    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64, device=a.device)
    for c0 in range(0, a.shape[1], chunk):
        a64, b64 = a[:, c0:c0 + chunk].double(), b[:, c0:c0 + chunk].double()
        out += (a64 * a64).sum(1)[:, None] + (b64 * b64).sum(1)[None, :] - 2.0 * (a64 @ b64.T)
        del a64, b64
    return out


def _sq_norms_about(x, y, chunk: int = 1 << 22):
    """|x_i - mean(x)|^2 and |y_j - mean(x)|^2 in float64, P-chunked: the
    scale of the pairwise kernel's error on (x, y) centred on x's mean (its
    limit is 1e-5 of their sum, PERF.md §2)."""
    import torch

    nx = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    ny = torch.zeros(y.shape[0], dtype=torch.float64, device=y.device)
    for c0 in range(0, x.shape[1], chunk):
        xs = x[:, c0:c0 + chunk].double()
        mu = xs.mean(dim=0)
        nx += ((xs - mu) ** 2).sum(1)
        ny += ((y[:, c0:c0 + chunk].double() - mu) ** 2).sum(1)
        del xs, mu
    return nx, ny


# The float32 unit roundoff: a sum of W partials adds at most (W - 1) of it
# times the partials' magnitudes, each at most 2 (|a - c|^2 + |b - c|^2).
_U32 = 2.0 ** -24


def _krum_lockstep_gate(o, b, adj, c: int, sel, ref_sel, sharded: dict, full: dict,
                        world: int) -> dict:
    """The distance and tie gates of one lockstep round (rank 0, the gathered
    own ``o`` and broadcast ``b``).

    Distances: kappa, the largest |d2 - exact| / (|a_i - mu|^2 + |b_j -
    mu|^2) over a matrix (mu the mean the call centres on: bcast's for
    (bcast, bcast), own's for (own, bcast); float64 exact values; the
    diagonal of (bcast, bcast) left out, as Krum masks it).  The group's
    kappa must stay within delta = 3 kappa_full + 2 (W - 1) u32: three
    times the full-width kernel's measured kappa, plus the float32 sum of
    the W block partials.  A lost or doubled block would put it near 1/W.

    Ties: on each node whose pick differs from the full-width rule's, every
    candidate's exact score s (the sum of its m - c - 2 smallest exact
    distances) is recomputed; a squared distance within delta (|a - mu|^2
    + |b - mu|^2) of the exact one moves the distance by e = min(sqrt(dD2),
    dD2 / d) and a score by E = (m - c - 2) max e, plus its float32
    rounding.  The group's pick p must satisfy s_p - min s <= E_p +
    E_argmin: a pick the measured noise cannot explain fails."""
    import torch

    from murmura_tpu_torch.aggregation.base import candidate_indices

    n = o.shape[0]
    exact = {"bb": _exact_sq(b, b), "ob": _exact_sq(o, b)}
    nb, _ = _sq_norms_about(b, b)
    no, nbo = _sq_norms_about(o, b)
    scale = {"bb": nb[:, None] + nb[None, :], "ob": no[:, None] + nbo[None, :]}
    off = ~torch.eye(n, dtype=torch.bool, device=o.device)
    keep = {"bb": off, "ob": torch.ones_like(off)}

    def kappa(d2):
        return max(float(((d2[k].double() - exact[k]).abs() / scale[k])[keep[k]].max())
                   for k in exact)

    k_full, k_sh = kappa(full), kappa(sharded)
    limit = 3.0 * k_full + 2.0 * (world - 1) * _U32
    delta = {k: limit * scale[k] for k in exact}
    ci, cv = candidate_indices(adj, n)
    worst, ties = 0.0, []
    for i in (sel != ref_sel).nonzero().flatten().tolist():
        idx = ci[i][cv[i]]
        m = len(idx)
        take = max(1, m - c - 2)
        mine = idx == i
        ii, jj = idx[:, None], idx[None, :]

        def pairs(t):
            # Candidate-pair entries: the self candidate's from the (own,
            # bcast) matrix, the others' from (bcast, bcast).
            v = torch.where(mine[:, None], t["ob"][i][jj].expand(m, m), t["bb"][ii, jj])
            return torch.where(mine[None, :], t["ob"][i][ii].expand(m, m), v)

        d = pairs(exact).clamp(min=0.0).sqrt()
        dd = pairs(delta)
        e = torch.minimum(dd.sqrt(), dd / d.clamp(min=1e-300))
        eye = torch.eye(m, dtype=torch.bool, device=d.device)
        s = torch.sort(d.masked_fill(eye, float("inf")), dim=1).values[:, :take].sum(1)
        big_e = take * e.masked_fill(eye, 0.0).max(dim=1).values + (take + 1) * 2 * _U32 * s
        pick = int((idx == int(sel[i])).nonzero()[0, 0])
        best = int(torch.argmin(s))
        gap, tol = float(s[pick] - s[best]), float(big_e[pick] + big_e[best])
        ratio = gap / tol if tol > 0 else (0.0 if gap <= 0 else float("inf"))
        worst = max(worst, ratio)
        ties.append({"node": i, "pick": int(sel[i]), "full_pick": int(ref_sel[i]),
                     "gap": gap, "tol": tol, "rel_gap": gap / max(float(s[best]), 1e-300)})
    del exact, scale, delta
    return {"kappa": (k_sh, k_full), "dist_ok": k_sh <= limit, "tie_worst": worst,
            "tie_ok": worst <= 1.0, "ties": ties}


def _lockstep_check(group, agg_fn, c: int, args, out, checks: list, peak: list,
                    ref_own) -> None:
    """One sharded Krum round against the unsharded rule on the same
    inputs, in rank 0 (own, bcast and the new rows gathered from the
    column blocks; the comparison's kernel launches not counted).  Krum's
    two squared-distance matrices as the group computes them (each rank's
    block through the pairwise kernel, the partials all-reduced) and as
    the full-width kernel computes them on the gathered rows go through
    :func:`_krum_lockstep_gate`.  Rows: where the picks agree, the new rows
    bit-equal to the reference rule's; where a pick differs, the row is the
    picked candidate's, bit for bit.  In round 1 the gathered trained rows
    are also measured against the one-process run's (``ref_own``, rank 0's,
    on the host)."""
    import torch

    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels
    from murmura_tpu_torch.ops.agg_kernels import pairwise_sq_distances
    from murmura_tpu_torch.parallel.mesh import (
        all_reduce_sum_,
        gather_columns,
        param_group_scope,
    )

    own, bcast, adj, round_idx, state, ctx = args
    new, _, stats = out
    cuda = group.device.type == "cuda"
    mods = (agg_kernels, candidate_kernels, sketch_kernels)
    counts = [(dict(m.LAUNCHES), dict(m.PLAIN_CALLS)) for m in mods]
    if cuda:
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())

    def sq(a, b):
        a32, b32 = a.float().contiguous(), None if b is None else b.float().contiguous()
        return pairwise_sq_distances(a32, b32, center=a32.mean(dim=0))

    sharded = {tag: all_reduce_sum_(sq(a, b), group) for tag, (a, b) in
               (("bb", (bcast, None)), ("ob", (own, bcast)))}
    whole = [gather_columns(t.contiguous(), group, dst=0) for t in (own, bcast, new)]
    if group.rank == 0:
        o, b, new_w = whole
        with param_group_scope(None):
            ref_new, _, ref_stats = agg_fn(o, b, adj, round_idx, state, ctx)
            full = {"bb": sq(b, None), "ob": sq(o, b)}
        sel, ref_sel = stats["selected_index"], ref_stats["selected_index"]
        gate = _krum_lockstep_gate(o, b, adj, c, sel, ref_sel, sharded, full, group.world)
        node = torch.arange(len(sel), device=sel.device)
        want = torch.where((sel == node)[:, None], o, b[sel])
        same = sel == ref_sel
        rows_ok = (torch.equal(new_w[same], ref_new[same])
                   and torch.equal(new_w[~same], want[~same]))
        record = {"round": int(round_idx), "differ": int((~same).sum()),
                  "rows_ok": bool(rows_ok), **gate,
                  "ok": bool(rows_ok) and gate["dist_ok"] and gate["tie_ok"],
                  "picks": sel.cpu().numpy()}
        if int(round_idx) == 0:
            rows, den = _row_deltas(o, ref_own)
            record["trained"] = [d / den for d in rows]
        checks.append(record)
        del o, b, new_w, ref_new, ref_stats, full, want
    del whole, sharded
    for m, (launches, plain) in zip(mods, counts):
        m.LAUNCHES.update(launches)
        m.PLAIN_CALLS.update(plain)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _lockstep_rank(config, ref_config, rounds: int) -> dict:
    """A rank of phase 4's sharded runs.  Rank 0 first runs ``ref_config``
    in one process (:func:`_unsharded`, the group turned off, the other
    ranks waiting at a barrier) and the yardstick (:func:`_perturbed`),
    keeping both on the host.  Then every rank runs ``config`` in the
    group, ``rounds`` rounds one at a time, its Krum rule checked every
    round by :func:`_lockstep_check`; after each round rank 0 gathers the
    parameters and holds them against the one-process run's
    (:func:`_chained_check`).  Returns this rank's launches, plain calls,
    peak device memory (the group's rounds, without the checks' and
    gathers' own) and forbidden modules; rank 0's also its history, round
    times, checks, layout, the chained checks and the one-process run's
    picks, yardstick, peak memory, round times and widths."""
    import numpy as np
    import torch

    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels
    from murmura_tpu_torch.parallel.launch import forbidden_modules
    from murmura_tpu_torch.parallel.mesh import (
        active_param_group,
        barrier,
        gather_rows,
        process_group,
        set_process_group,
    )
    from murmura_tpu_torch.utils.factories import build_network_from_config

    group = process_group()
    ref = None
    if group.rank == 0:
        set_process_group(None)
        try:
            ref = _unsharded(ref_config, rounds, keep=True)
            ref["perturbed"] = _perturbed(ref_config, ref["flats"])
        finally:
            set_process_group(group)
    barrier(group)
    c = int(config.aggregation.params.get("num_compromised", 0))
    block = config.compression.block if config.compression.algorithm == "int8" else 0
    checks, peak = [], [0]

    def check(aggregate, args, out):
        _lockstep_check(active_param_group(), aggregate, c, args, out, checks, peak,
                        None if ref is None else ref["own"])

    with _rule_hook(check):
        net = build_network_from_config(config, device=group.device)
    mods = (agg_kernels, candidate_kernels, sketch_kernels)
    cuda = group.device.type == "cuda"
    for m in mods:
        m.reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    chained = []
    for r in range(rounds):
        net.train(1)
        if cuda:
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        flat = gather_rows(net.flat, net.group, dst=0)
        if group.rank == 0:
            picks = checks[-1]["picks"]
            chained.append(_chained_check(flat, ref["flats"][r], block,
                                          picks != np.arange(len(picks))))
        del flat
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    out = {"launches": {k: v for m in mods for k, v in m.LAUNCHES.items()},
           "plain": sum(v for m in mods for v in m.PLAIN_CALLS.values()),
           "peak_bytes": peak[0] if cuda else None, "forbidden_modules": forbidden_modules()}
    if group.rank == 0:
        out.update(history=net.history, round_times=list(net.round_times), checks=checks,
                   layout=net.group.describe(), chained=chained,
                   ref={k: ref[k] for k in ("picks", "perturbed", "peak_bytes", "round_times",
                                            "model_dim", "flat_dim")})
    return out


def _sharded_group(config, ref_config, world: int, rounds: int, label: str) -> dict:
    """``config`` in a group of ``world`` ranks on cuda:0 (gloo, staged)
    against ``ref_config``'s one-process run, which rank 0 makes first
    (:func:`_lockstep_rank`).  Gates: each round's rule in
    lockstep (:func:`_lockstep_check`: the group's distances, a differing
    pick's tie, the rows); the round-1 trained rows, which each rank
    computes for its own rows, within a scaled 1e-4 of the one-process
    run's; the parameters after round 1 (:func:`_chained_check`: a scaled
    1e-4, plus one int8 code step on a row that took a neighbour's decoded
    broadcast), and after each later round before the first whose picks
    differ while the config itself keeps a float32 rounding of its initial
    parameters within 1e-4 (the yardstick, :func:`_perturbed`).  Past
    that, a flipped near-tie or the config's own growth of rounding
    differences makes the two runs different experiments (PERF.md §2):
    their distance is printed beside the yardstick's.  Each rank's
    pairwise launches 2 a round, no plain call, no JAX."""
    import numpy as np

    from murmura_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    ranks = launch(_lockstep_rank, (config, ref_config, rounds), world=world,
                   device_type="cuda", one_device=True)
    wall = time.perf_counter() - t0
    rec = ranks[0]
    ref_picks, perturbed = rec["ref"]["picks"], rec["ref"]["perturbed"]
    checks = rec["checks"]
    lockstep = len(checks) == rounds and all(ch["ok"] for ch in checks)
    picks = [ch["picks"] for ch in checks]
    differing = [r + 1 for r, (a, b) in enumerate(zip(picks, ref_picks))
                 if not np.array_equal(a, b)]
    first = differing[0] if differing else rounds + 1
    last = 0 if first == 1 else 1
    while 0 < last < first - 1 and perturbed[last] <= 1e-4:
        last += 1
    trained = checks[0]["trained"]
    held = rec["chained"][:last]
    chain_ok = max(trained) <= 1e-4 and all(ch["ratio"] <= 1.0 for ch in held)
    launches = [r["launches"] for r in ranks]
    plain = sum(r["plain"] for r in ranks)
    each = all(lc["pairwise_sq_distances"] == 2 * rounds for lc in launches)
    forbidden = sorted({m for r in ranks for m in r["forbidden_modules"]})
    selected = any(not np.array_equal(p_, np.arange(len(p_))) for p_ in picks)
    ok = lockstep and chain_ok and each and plain == 0 and not forbidden and selected
    ties = [t for ch in checks for t in ch["ties"]]
    print(f"[sharded:{label}] {rec['layout']}", flush=True)
    print(f"[sharded:{label}] world {world} on cuda:0, {rounds} rounds in {wall:.2f} s of "
          f"wall (spawn, build, the one-process run in rank 0 and the rounds).  In lockstep with the full-width rule on the "
          f"same inputs: picks differing {[ch['differ'] for ch in checks]}; distance kappa "
          f"(group / full-width kernel) "
          + ", ".join(f"{k[0]:.3g} / {k[1]:.3g}" for k in (ch["kappa"] for ch in checks))
          + "; differing picks' tie gap / tolerance "
          + (", ".join(f"round {ch['round'] + 1} node {t['node']} {t['pick']} not "
                       f"{t['full_pick']}: {t['gap']:.3g} / {t['tol']:.3g} (relative gap "
                       f"{t['rel_gap']:.3g})" for ch in checks for t in ch["ties"])
             or "none")
          + f"; rows bit-equal or the picked candidate's {[ch['rows_ok'] for ch in checks]}.  "
          f"Chained against the one-process run: round-1 trained rows by node "
          f"{[float(f'{d:.3g}') for d in trained]} scaled; picks first differ in round "
          f"{first if differing else None}; parameters after each round (scaled, bound "
          f"ratio, elements past 1e-4) "
          + ", ".join(f"({ch['scaled']:.3g}, {ch['ratio']:.3g}, {ch['steps']})"
                      for ch in rec["chained"])
          + f", gated through round {last}; the one-process run against itself from "
          f"initial parameters one float32 rounding apart "
          f"{[float(f'{d:.3g}') for d in perturbed]}; Krum selected: {selected}; pairwise launches by "
          f"rank {[lc['pairwise_sq_distances'] for lc in launches]}, plain calls {plain}, "
          f"forbidden modules {forbidden}; s a round on rank 0 "
          f"{[round(t, 4) for t in rec['round_times']]}: {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        raise AssertionError(f"the sharded run {label} disagrees with the unsharded rule or run")
    return {"launches": {k: sum(lc[k] for lc in launches) for k in launches[0]},
            "launches_by_rank": launches, "wall": wall, "trained": max(trained),
            "chained": rec["chained"], "gated_through": last, "perturbed": perturbed,
            "first_differing_round": first if differing else None,
            "tie_worst": max((t["gap"] / t["tol"] for t in ties), default=0.0),
            "round_times": rec["round_times"], "peaks": [r["peak_bytes"] for r in ranks],
            "one_process": rec["ref"]}


def run_sharded_smoke() -> dict:
    """Phase 4, param-axis sharding.  (b) ``python -m murmura_tpu_torch run
    examples/configs/sharded_model.yaml`` as committed in a subprocess:
    layout (1, 1, 1) on this one card, 20 rounds, one process on the padded
    flat vector; against the same config at ``tpu.param_shards: 1`` in this
    process (history within a scaled 1e-4, bit-equality printed).  (c)
    the same config in a group of 4 on cuda:0 (:func:`_sharded_group`), 5
    rounds, against the one-process run's first 5.  (d) bench_scaling.py's
    acceptance cell at world 8 on cuda:0 against its one-process run, each
    rank's peak device memory beside the one-process peak and the analytic
    flat bytes."""
    import torch
    import yaml

    from murmura_tpu_torch.config.schema import Config

    t_all = time.perf_counter()
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    # (b) the CLI as committed, in a subprocess with its counters.
    hist_path = SMOKE_DIR / "sharded_model.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_WITH_COUNTS, "run", str(SHARDED_MODEL), "--device",
         "cuda", "-o", str(hist_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sharded_model.yaml failed on the card:\n{proc.stdout[-2000:]}"
                             f"\n{proc.stderr[-4000:]}")
    layout = [ln for ln in proc.stdout.splitlines() if ln.startswith("param layout")]
    counts = _cli_counts(proc.stdout)
    cli_hist = json.loads(hist_path.read_text())
    raw = yaml.safe_load(SHARDED_MODEL.read_text())
    rounds = raw["experiment"]["rounds"]
    one = dict(raw, tpu={**raw["tpu"], "param_shards": 1})
    ref = _unsharded(Config.model_validate(one), rounds)
    delta = max(_scaled_np(cli_hist[k], v) for k, v in ref["history"].items() if v)
    bit_equal = cli_hist == ref["history"]
    launches_ok = (counts["launches"]["pairwise_sq_distances"] == 2 * rounds
                   and not any(counts["plain"].values()))
    ok = (layout == ["param layout (seed, nodes, param) (1, 1, 1) over 1 cuda device(s): "
                     "one process, unsharded, on the padded flat vector"]
          and cli_hist["round"] == list(range(1, rounds + 1)) and delta <= 1e-4
          and launches_ok)
    print(f"[sharded:committed] {layout}; sharded_model.yaml as committed, {rounds} rounds, "
          f"{cli_wall:.2f} s of process wall: history within {delta:.3g} scaled of "
          f"tpu.param_shards 1 (bit-equal {bit_equal}), launches {counts['launches']}, plain "
          f"{counts['plain']}; final mean accuracy {cli_hist['mean_accuracy'][-1]:.4f}; "
          f"param_shards 1 steady s/round {_steady(ref['round_times']):.4f}, peak "
          f"{ref['peak_bytes'] / 1e9:.3f} GB: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("sharded_model.yaml on one card disagrees with param_shards 1")
    out["sharded:committed"] = {"launches": counts["launches"], "wall": cli_wall,
                                "delta": delta, "bit_equal": bit_equal}
    # (c) the same config in a group of 4 on cuda:0.
    out["sharded:world4"] = _sharded_group(Config.model_validate(raw),
                                           Config.model_validate(one), 4,
                                           SHARDED_CHECK_ROUNDS, "world4")
    del ref
    # (d) the acceptance cell in a group of 8, against its one-process run.
    acc = Config.model_validate(ACCEPTANCE)
    res = _sharded_group(acc, acc, ACCEPTANCE_WORLD, acc.experiment.rounds, "acceptance")
    ref = res["one_process"]
    p_pad = ref["flat_dim"]
    whole = 16 * p_pad * 4
    print(f"[sharded:acceptance] P {ref['model_dim']:,} (padded {p_pad:,}): analytic flat "
          f"bytes a rank 16 x P_pad/{ACCEPTANCE_WORLD} x 4 B = {whole // ACCEPTANCE_WORLD:,} "
          f"against 16 x P_pad x 4 B = {whole:,} in one process; peak device memory by rank "
          f"{[round(b / 1e9, 3) for b in res['peaks']]} GB against the one-process "
          f"{ref['peak_bytes'] / 1e9:.3f} GB; one process s/round "
          f"{[round(t, 4) for t in ref['round_times']]}", flush=True)
    res.update(one_process_peak=ref["peak_bytes"], flat_bytes=whole)
    out["sharded:acceptance"] = res
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sharded] the sharding runs took {time.perf_counter() - t_all:.2f} s", flush=True)
    return out



# ---------------------------------------------------------------------------
# The ZMQ multi-process backend (distributed/): one node's round on the card
# against the CPU (phase 3e), and uci_har_byzantine.yaml as one node process
# a peer on this card (phase 4e).

# Phase 4e's cuts of uci_har_byzantine.yaml (50 rounds as committed): the
# rounds, and the wall-clock windows, set from the node processes' boot and
# round times on this card's hosts (the slowest node ready 23.7 to 47.4 s
# after its spawn inside this script over thirteen runs on several hosts; a
# first round's work up to 5.7 s, a later one's under 0.5 s): the grace
# 1.27 times the slowest boot seen (a host slow enough to boot past it runs
# the whole script past its time limit in any case), a window about 1.6
# times the longest first round's work.
DIST_ROUNDS = 2
DIST_ROUND_S = 9.0
DIST_GRACE_S = 60.0
# Per-node eval loss of a node whose picks agree, card against CPU: the
# trained and copied rows differ by float32 rounding (about 1e-7 scaled).
DIST_LOSS_RTOL = 1e-4
# The least card memory a CUDA context takes, MiB (a node process on this
# card's host holds about 840).
CONTEXT_MIB = 300


def _byzantine_inputs():
    """uci_har_byzantine.yaml's config, data (the synthetic fallback), model
    and node 0's initial parameters (a CPU generator of the experiment
    seed), as the ZMQ backend's node 0 builds them."""
    import torch

    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.ops.flatten import tree_to_numpy
    from murmura_tpu_torch.utils.factories import resolve_model

    cfg = load_config(UCI_HAR_BYZANTINE)
    data = build_federated_data(cfg.data.adapter, cfg.data.params,
                                num_nodes=cfg.topology.num_nodes, seed=cfg.experiment.seed,
                                max_samples=cfg.training.max_samples)
    model = resolve_model(cfg, data)
    init = tree_to_numpy(model.init(torch.Generator().manual_seed(cfg.experiment.seed), "cpu"))
    return cfg, data, model, init


def check_node_runtime_against_cpu(device: str = "cuda") -> dict:
    """Phase 3e: node 0 of uci_har_byzantine.yaml (the evidential wearable
    MLP at UCI HAR widths, P = 178,310, dropout 0.3) as the ZMQ backend's
    LocalNode on the card and on the CPU: one start, one draw stream (the
    node's CPU generator), local training, then the rule on its [10, P] mini
    network with the same nine received states (two of them the config's
    gaussian std 1 around the node's trained row, seven honest rows at
    distinct spreads around a point off it).  Krum (f = 2): its two pairwise launches a
    aggregate, no plain call, the pick equal (or, where it differs, each
    device's pick within the tie ``krum_tie_check`` allows on the mini
    network), the parameters within a scaled 1e-4; Sketchguard the same
    with its two count sketches and one pairwise pass on the sketches.  Then
    a DMTTNodeProcess of dmtt_mobility.yaml (node 1, its G^t neighbours'
    states received): the probe evaluation's model scores within rtol 1e-5,
    the claim verification's Beta evidence and the TopB collaborators
    equal."""
    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.attacks.base import select_compromised
    from murmura_tpu_torch.distributed.local import LocalNode
    from murmura_tpu_torch.ops import agg_kernels, sketch_kernels
    from murmura_tpu_torch.ops.flatten import model_dimension

    t_phase = time.perf_counter()
    cfg, data, model, init = _byzantine_inputs()
    n, t = cfg.topology.num_nodes, cfg.training
    dim = model_dimension(init)
    x, y = data.get_client_data(0)
    ex, ey = data.get_client_eval_data(0)
    comp = set(np.flatnonzero(select_compromised(n, cfg.attack.percentage,
                                                 cfg.experiment.seed)).tolist())
    std = float(cfg.attack.params.get("std", 1.0))
    out = {}
    for rule, params, expect in (
        ("krum", dict(cfg.aggregation.params), {"pairwise_sq_distances": 2}),
        ("sketchguard", {}, {"count_sketch": 2, "pairwise_sq_distances": 1}),
    ):
        nodes = {dev: LocalNode(0, model, build_aggregator(rule, params, model_dim=dim), x, y,
                                eval_x=ex, eval_y=ey, max_neighbors=n - 1,
                                local_epochs=t.local_epochs, batch_size=t.batch_size, lr=t.lr,
                                total_rounds=cfg.experiment.rounds,
                                annealing_rounds=max(1, cfg.experiment.rounds // 2),
                                probe_size=t.batch_size, seed=cfg.experiment.seed,
                                device=dev, init_params=init)
                 for dev in (device, "cpu")}
        for node in nodes.values():
            node.local_train(0)
        card, cpu = nodes[device], nodes["cpu"]
        own = cpu.get_flat_state()
        scale = max(1.0, float(np.abs(own).max()))
        trained = float(np.abs(card.get_flat_state() - own).max()) / scale
        # The honest neighbours cluster at distinct spreads around a point
        # off the node's own row, so Krum picks a neighbour, off any tie.
        g = np.random.default_rng(1)
        center = own + 0.05 * g.normal(size=own.shape)
        states = {j: ((own if j in comp else center)
                      + (std if j in comp else 0.01 * (1.0 + j / n)) * g.normal(size=own.shape)
                      ).astype(np.float32) for j in range(1, n)}
        minis = {dev: node.mini_network(states) for dev, node in nodes.items()}
        agg_kernels.reset_counts()
        sketch_kernels.reset_counts()
        card.aggregate_with_neighbors(states, 0)
        launches = {**agg_kernels.LAUNCHES, **sketch_kernels.LAUNCHES}
        plain = {**agg_kernels.PLAIN_CALLS, **sketch_kernels.PLAIN_CALLS}
        cpu.aggregate_with_neighbors(states, 0)
        st_card, st_cpu = card.get_aggregator_statistics(), cpu.get_aggregator_statistics()
        pick_equal = all(st_card[k] == st_cpu[k] for k in ("selected_index", "acceptance_rate")
                         if k in st_cpu)
        tie = ""
        if not pick_equal and rule == "krum":
            # Each device's pick within the score noise of the exact best.
            worst = 0.0
            for dev, node in nodes.items():
                stack, adj, _ = minis[dev]
                with torch.no_grad():
                    new, _, st = node.agg.aggregate(stack, stack, adj, 0.0, {}, node._ctx)
                ok_dev, w, _ = krum_tie_check(stack, stack, adj, int(params.get("f", 2)),
                                              st["selected_index"].long(), new)
                pick_equal = ok_dev if dev == device else (pick_equal and ok_dev)
                worst = max(worst, w)
            tie = f" (picks differ: tie-aware, largest gap/tolerance {worst:.3g})"
        delta = float(np.abs(card.get_flat_state() - cpu.get_flat_state()).max()) / scale
        ok = (pick_equal and all(launches[k] == v for k, v in expect.items())
              and not any(plain.values()) and trained <= 1e-4 and (delta <= 1e-4 or tie))
        print(f"[node-runtime] {rule}: node 0 of uci_har_byzantine.yaml, [{n}, {dim:,}] mini "
              f"network: card train {card.timings['train_s']:.4f} s, aggregate "
              f"{card.timings['aggregate_s']:.4f} s (CPU {cpu.timings['train_s']:.4f} s, "
              f"{cpu.timings['aggregate_s']:.4f} s); launches {launches}, plain {plain}; "
              f"decision {({k: st_card[k] for k in ('selected_index', 'acceptance_rate') if k in st_card})} "
              f"equal {pick_equal}{tie}; trained rows {trained:.3g}, parameters {delta:.3g} "
              f"scaled (limit 1e-4): {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"the {rule} node round on the card differs from the CPU's")
        out[rule] = {"trained": trained, "delta": delta, "train_s": card.timings["train_s"],
                     "aggregate_s": card.timings["aggregate_s"], "launches": launches}
    out["dmtt"] = _check_dmtt_node_against_cpu(device)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[node-runtime] phase 3e in {out['seconds']:.2f} s", flush=True)
    return out


def _check_dmtt_node_against_cpu(device: str) -> dict:
    """Phase 3e's DMTTNodeProcess rows: node 1 of dmtt_mobility.yaml built
    on the card and on the CPU (one initial state: the node's CPU
    generator), its round-0 G^t neighbours' states received: the model
    scores of the probe evaluation within rtol 1e-5, then every other
    node's claim (the liars' through the attack's claims_fn) verified: the
    Beta evidence, the TopB collaborators and the mean topology trust
    equal."""
    import numpy as np
    import torch

    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.dmtt.node_process import DMTTNodeProcess
    from murmura_tpu_torch.utils.factories import build_attack

    cfg = load_config(DMTT_MOBILITY)
    attack = build_attack(cfg)
    comp = np.flatnonzero(attack.compromised).tolist()
    procs = {}
    for dev in (device, "cpu"):
        proc = DMTTNodeProcess(cfg, node_id=1, run_id="smoke", t_start=0.0,
                               compromised_ids=comp, device=dev)
        proc.device = torch.device(dev)
        proc._build_node()
        procs[dev] = proc
    card, cpu = procs[device], procs["cpu"]
    own = cpu.node.get_flat_state()
    true_nb = cpu.current_neighbors(0)
    g = np.random.default_rng(2)
    states = {j: (own + 0.05 * (1 + j) * g.normal(size=own.shape)).astype(np.float32)
              for j in true_nb}
    t0 = time.perf_counter()
    s_card = card._score_models(states)
    probe_s = time.perf_counter() - t0
    s_cpu = cpu._score_models(states)
    score_rel = max(abs(s_card[j] - s_cpu[j]) / max(abs(s_cpu[j]), 1e-30) for j in states)
    n = cfg.topology.num_nodes
    adj = torch.from_numpy(cpu.mobility.adjacency_at(0).astype(np.float32))
    comp_mask = torch.zeros(n)
    comp_mask[comp] = 1.0
    claimed = attack.claims_fn(adj, comp_mask).numpy()
    claims = {j: np.flatnonzero(claimed[j]).tolist() for j in range(n) if j != 1}
    for proc in procs.values():
        proc._verify_claims(claims, 0)
        proc._select_collaborators(true_nb, s_cpu)
    same = (card._alpha == cpu._alpha and card._beta == cpu._beta
            and card._collaborators == cpu._collaborators
            and card._mean_topo_trust(true_nb) == cpu._mean_topo_trust(true_nb))
    ok = score_rel <= 1e-5 and same
    print(f"[node-runtime] dmtt: node 1 of dmtt_mobility.yaml, {len(states)} G^t neighbours' "
          f"states scored on the card in {probe_s:.4f} s, model scores within {score_rel:.3g} "
          f"relative of the CPU's (limit 1e-5); claims of {len(claims)} nodes verified, Beta "
          f"evidence, collaborators {card._collaborators} and mean topology trust equal {same}: "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("the DMTT node round on the card differs from the CPU's")
    return {"score_rel": score_rel, "probe_s": probe_s}


def _compute_apps() -> dict:
    """{pid: used MiB} of the card's compute processes (nvidia-smi), and
    the card's memory.used in MiB under the key -1."""
    def query(args):
        try:
            return subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"],
                                  capture_output=True, text=True, timeout=10).stdout
        except (OSError, subprocess.TimeoutExpired):
            return ""

    apps = {}
    for line in query(["--query-compute-apps=pid,used_memory"]).splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = float(parts[1]) if parts[1].replace(".", "").isdigit() else 0.0
    used = query(["--query-gpu=memory.used"]).strip().splitlines()
    apps[-1] = float(used[0]) if used and used[0].replace(".", "").isdigit() else 0.0
    return apps


def _round_events(run_dir: Path) -> dict:
    """{round: {node: metrics}} from a distributed run's telemetry events
    (the monitor's ``round`` events)."""
    out = {}
    for line in (run_dir / "events.jsonl").read_text().splitlines():
        e = json.loads(line)
        if e.get("type") == "round":
            out[int(e["round"])] = {int(k): v for k, v in e["nodes"].items()}
    return out


def _node_lines(log: str) -> dict:
    """Per node: pid, boot seconds (its ready line) and device, and each
    round's train/aggregate seconds, its allocator peak on the card and its
    kernel counters (its summary line)."""
    import ast
    import re

    nodes = {}
    for m in re.finditer(r"\[node (\d+)\] pid (\d+) ready ([\d.]+) s after spawn", log):
        nodes.setdefault(int(m[1]), {}).update(pid=int(m[2]), boot_s=float(m[3]))
    for m in re.finditer(r"\[node (\d+)\] pid \d+ ready [^\n]*? s before round 0, on (\S+)", log):
        nodes.setdefault(int(m[1]), {}).update(device=m[2])
    for m in re.finditer(r"\[node (\d+)\] rounds \{(.*?)\}; (?:card memory peak ([\d.]+) MiB; )?"
                         r"kernel launches (\{.*?\}); plain calls (\{.*?\})", log):
        rounds = {int(r): (float(a), float(b)) for r, a, b in re.findall(
            r"(\d+): train ([\d.]+) s aggregate ([\d.]+) s", m[2])}
        nodes.setdefault(int(m[1]), {}).update(
            rounds=rounds, peak_mib=float(m[3]) if m[3] else 0.0,
            launches=ast.literal_eval(m[4]), plain=ast.literal_eval(m[5]))
    return nodes


def _replay_distributed(cfg_path: Path, rounds: int) -> dict:
    """The spawned run's protocol in this process on the CPU, one thread
    as a node process on the CPU runs: every node's NodeProcess built as
    there, then each round every node trains (honest only), sends its outgoing
    state (a compromised node's under the attack, its noise from the same
    CPU generator), receives every neighbour's and aggregates, and is
    evaluated.  Returns {round: {node: (mini-network stack, adj, the Krum
    rule's full selected_index and output on it, eval loss)}}: the
    inputs each node's rule took, for the tie check of a pick that differs
    between the card's run and the CPU's."""
    import numpy as np
    import torch

    from murmura_tpu_torch.config import load_config
    from murmura_tpu_torch.distributed.node_process import NodeProcess

    cfg = load_config(cfg_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        attack_nodes = None
        procs = []
        for i in range(cfg.topology.num_nodes):
            proc = NodeProcess(cfg, node_id=i, run_id="replay", t_start=0.0,
                               compromised_ids=[], device="cpu")
            proc.device = torch.device("cpu")
            proc._build_node()
            if attack_nodes is None:
                attack_nodes = np.flatnonzero(proc.attack.compromised).tolist() if proc.attack \
                    else []
            procs.append(proc)
        for proc in procs:
            proc.compromised_ids = set(attack_nodes)
            proc.is_compromised = proc.node_id in proc.compromised_ids
        out = {}
        for r in range(rounds):
            sent = {}
            for proc in procs:
                if not proc.is_compromised:
                    proc.node.local_train(r)
                sent[proc.node_id] = proc._attacked_state(proc.node.get_flat_state(), r)
            out[r + 1] = {}
            for proc in procs:
                received = {j: sent[j] for j in proc.current_neighbors(r)}
                stack, adj, _ = proc.node.mini_network(received)
                with torch.no_grad():
                    new, _, st = proc.node.agg.aggregate(stack, stack, adj, float(r), {},
                                                         proc.node._ctx)
                proc.node.aggregate_with_neighbors(received, r)
                out[r + 1][proc.node_id] = (stack, adj, st["selected_index"].long(), new,
                                            proc.node.evaluate()["loss"])
        return out
    finally:
        torch.set_num_threads(threads)


def run_distributed_smoke(card: str = "cuda") -> dict:
    """Phase 4e: uci_har_byzantine.yaml with ``backend: distributed`` (its
    rounds cut to DIST_ROUNDS, the windows DIST_ROUND_S after
    DIST_GRACE_S, ipc transport, telemetry on for the per-node metrics)
    through ``python -m murmura_tpu_torch run``: the monitor and 10 node
    processes on this card.  Gates:
    exit 0; history rounds 1..DIST_ROUNDS; no node skipped a round (a skip
    fails the phase: arrival sets that differ are not compared); each node
    on the card: its pid among nvidia-smi's compute processes during round
    1, or, where nvidia-smi does not list this container's processes (the
    card's host here lists pid 1 alone), each node reporting its card and a
    nonzero allocator peak and the card's memory.used in round 1 above its
    reading before the spawn by CONTEXT_MIB a node; each node's pairwise kernel
    twice an aggregate, no plain call; card against CPU node by node, the
    CPU side an in-process replay of the same protocol with the same draws
    (``_replay_distributed``; the node processes draw on a CPU generator
    whatever their device, so the replay is what the same run with
    ``--device cpu`` computes): Krum's picks equal, or both within
    ``krum_tie_check``'s tie on that node's mini network as the replay
    rebuilds it, and the eval loss of a node whose picks agree within rtol
    DIST_LOSS_RTOL (round 2 on only while no pick of an earlier round
    differed).  Prints each node's boot (spawn to ready), train and
    aggregate seconds, the node processes' card memory and the wall."""
    import tempfile

    import yaml

    t_phase = time.perf_counter()
    raw = yaml.safe_load(UCI_HAR_BYZANTINE.read_text())
    raw["experiment"].update(rounds=DIST_ROUNDS, verbose=False)
    raw["backend"] = "distributed"
    work = SMOKE_DIR / "distributed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ipc = tempfile.mkdtemp(prefix="mzq")
    raw["distributed"] = {"transport": "ipc", "ipc_dir": ipc,
                          "round_duration_s": DIST_ROUND_S, "startup_grace_s": DIST_GRACE_S}
    raw["telemetry"] = {"enabled": True, "dir": str(work / "telemetry")}
    cfg, out, log_path = work / "card.yaml", work / "card.history.json", work / "card.log"
    cfg.write_text(yaml.safe_dump(raw))
    before = _compute_apps()
    samples = []
    t0 = time.perf_counter()
    # Appends only: the node processes share this file's offset.
    with open(log_path, "a") as log:
        proc = subprocess.Popen([sys.executable, "-m", "murmura_tpu_torch", "run", str(cfg),
                                 "--device", card, "-o", str(out)],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                samples.append((time.monotonic(), _compute_apps()))
                time.sleep(0.5)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            shutil.rmtree(ipc, ignore_errors=True)
    run_wall = time.perf_counter() - t0
    text = log_path.read_text()
    if proc.returncode != 0:
        print(text[-4000:], flush=True)
        raise AssertionError(f"the distributed run ({card}) exited {proc.returncode}")
    h = json.loads(out.read_text())
    nodes = _node_lines(text)
    t_start = float(text.split("t_start=", 1)[1].split()[0])
    events = _round_events(work / "telemetry")
    t_replay = time.perf_counter()
    replay = _replay_distributed(cfg, DIST_ROUNDS)
    replay_s = time.perf_counter() - t_replay
    n = raw["topology"]["num_nodes"]
    c = int(raw["aggregation"]["params"].get("f", 0))
    failures = []
    if h.get("round") != list(range(1, DIST_ROUNDS + 1)):
        failures.append(f"history rounds {h.get('round')}")
    if any(h.get("skipped_nodes", [])) or h.get("reporting_nodes") != [n] * DIST_ROUNDS:
        failures.append(f"a node skipped or did not report a round (skipped "
                        f"{h.get('skipped_nodes')}, reporting {h.get('reporting_nodes')})")
    if sorted(nodes) != list(range(n)) or any(
            "rounds" not in v or "pid" not in v for v in nodes.values()):
        failures.append(f"{len(nodes)} node lines of {n}")
    pids = {v.get("pid") for v in nodes.values()}
    base_pids = set(before) - {-1}
    listed, new_mib, used = set(), 0.0, 0.0
    for t_s, apps in samples:
        if t_start <= t_s < t_start + DIST_ROUND_S:
            listed |= set(apps) - {-1}
            used = max(used, apps.get(-1, 0.0))
            new_mib = max(new_mib, sum(m for p, m in apps.items() if p not in base_pids | {-1}))
    base = before.get(-1, 0.0)
    off = sorted(i for i, v in nodes.items()
                 if not str(v.get("device", "")).startswith("cuda") or not v.get("peak_mib"))
    if pids <= listed:
        on_card = f"all {n} node pids listed by nvidia-smi in round 1"
    elif not off and used - base >= CONTEXT_MIB * n:
        # nvidia-smi on this host does not list this container's processes
        # (it shows pid 1 alone, before the spawn as after): the nodes are
        # on the card by their own report (each on cuda with an allocator
        # peak) and by the card's memory.used, which grows by at least a
        # CUDA context a node process.
        on_card = (f"nvidia-smi lists {sorted(listed)} (ours {sorted(pids)}), so: every node "
                   f"reports cuda and an allocator peak, and memory.used grew by "
                   f"{used - base:.0f} MiB (at least {CONTEXT_MIB} a node)")
    else:
        on_card = (f"nvidia-smi listed {sorted(listed)}, memory.used {base:.0f} -> "
                   f"{used:.0f} MiB")
        failures.append(f"the {n} node processes not shown on the card ({on_card}; nodes {off} "
                        f"report no card)")
    launches = {"pairwise_sq_distances": 0}
    for i, v in nodes.items():
        aggs = sum(1 for _, a in v.get("rounds", {}).values() if a > 0)
        got = v.get("launches", {}).get("pairwise_sq_distances", -1)
        launches["pairwise_sq_distances"] += max(got, 0)
        if got != 2 * aggs or any(v.get("plain", {}).values()):
            failures.append(f"node {i}: {got} pairwise launches for {aggs} aggregates, plain "
                            f"{v.get('plain')}")
    differ, ties, loss_rel, compared, worst, unchecked = 0, True, 0.0, 0, 0.0, 0
    for r in range(1, DIST_ROUNDS + 1):
        got_round = events.get(r, {})
        round_differ = 0
        for i in range(n):
            a = got_round.get(i)
            if a is None:
                continue
            stack, adj, sel, new, loss = replay[r][i]
            pa, pb = a["stats"].get("selected_index"), float(sel[0])
            if pa != pb and differ:
                # After a differing pick the card's inputs are no longer the
                # replay's: not compared.
                unchecked += 1
            elif pa != pb:
                round_differ += 1
                for pick in (pa, pb):
                    selected, rows = sel.clone(), new.clone()
                    selected[0] = int(pick)
                    rows[0] = stack[int(pick)]
                    ok_tie, w, _ = krum_tie_check(stack, stack, adj, c, selected, rows)
                    ties = ties and ok_tie
                    worst = max(worst, w)
            elif differ == 0:
                compared += 1
                loss_rel = max(loss_rel, abs(a["loss"] - loss) / max(abs(loss), 1e-30))
        differ += round_differ
    if not ties:
        failures.append(f"a Krum pick differs between the card and the CPU outside the tie "
                        f"(largest gap/tolerance {worst:.3g})")
    if loss_rel > DIST_LOSS_RTOL:
        failures.append(f"per-node losses {loss_rel:.3g} relative apart")
    boots = {i: v.get("boot_s") for i, v in sorted(nodes.items())}
    per_round = {i: {r: (round(a, 4), round(b, 4)) for r, (a, b) in v.get("rounds", {}).items()}
                 for i, v in sorted(nodes.items())}
    peaks = sum(v.get("peak_mib", 0.0) for v in nodes.values())
    wall = time.perf_counter() - t_phase
    print(f"[distributed] uci_har_byzantine.yaml, backend: distributed, {n} node processes + "
          f"the monitor on this card ({DIST_ROUNDS} rounds of {DIST_ROUND_S} s after a "
          f"{DIST_GRACE_S} s grace): boot s (spawn to ready) {boots} (largest "
          f"{max(boots.values(), default=0.0):.2f}); (train s, aggregate s) by "
          f"node and round {per_round}; on the card: {on_card}; card memory of the node "
          f"processes {new_mib:.0f} MiB (nvidia-smi, round 1), memory.used {base:.0f} MiB "
          f"before the spawn and {used:.0f} MiB in round 1, allocator peaks summed "
          f"{peaks:.1f} MiB; pairwise launches "
          f"{launches['pairwise_sq_distances']}, 0 plain; card vs the CPU replay "
          f"({replay_s:.2f} s): {differ} differing "
          f"pick(s) (within krum_tie_check's tie on the replayed inputs: {ties}, largest "
          f"gap/tolerance {worst:.3g}; {unchecked} later node-round(s) not comparable), "
          f"per-node loss within {loss_rel:.3g} relative on "
          f"{compared} node-rounds (limit {DIST_LOSS_RTOL:g}); run wall {run_wall:.2f} s; "
          f"phase {wall:.2f} s: "
          f"{'ok' if not failures else 'FAILED: ' + '; '.join(failures)}", flush=True)
    if failures:
        raise AssertionError("the distributed backend phase failed: " + "; ".join(failures))
    return {"launches": launches, "plain": {}, "s_per_round": [], "boots": boots,
            "mem_mib": new_mib if pids <= listed else used - base, "wall": wall,
            "differ": differ}


def main() -> int:
    started = time.perf_counter()
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not (ROOT / "murmura_tpu_torch" / "csrc").is_dir() or not FLAGSHIP.exists():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(murmura_tpu_torch/ and examples/configs/ are missing)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this test needs one CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    # Full float32 on the card: cuDNN runs float32 convolutions in TF32 by
    # default, which would blur every float32 comparison below.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from murmura_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, (secs, log) in _build.BUILD_LOG.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln]
        spills = sum("spill stores" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln
                     for ln in log.splitlines())
        print(f"[build] {name}.cu: nvcc {secs:.2f} s; {spills} kernel(s) spill; "
              + " | ".join(usage), flush=True)

    results: dict = {}
    phase_s: dict = {}

    def timed(label, fn, *args):
        t_fn = time.perf_counter()
        value = fn(*args)
        dt = time.perf_counter() - t_fn
        phase_s[label] = phase_s.get(label, 0.0) + dt
        print(f"[time] {label} {dt:.1f} s (elapsed {time.perf_counter() - started:.1f} s)",
              flush=True)
        return value

    timed("3:kernels", check_kernels, results)
    timed("3:model_widths", check_model_widths, results)
    codec_ms = timed("3:codec", check_codec)
    timed("3b:rounds", check_round_against_cpu)
    timed("3b:pipelined", check_pipelined_against_cpu)
    timed("3b:sparse", check_sparse_rounds_against_cpu)
    timed("3b:adaptive", check_adaptive_against_cpu)
    round64 = timed("3c:n64_bf16", check_round_n64_bf16)
    t_models = time.perf_counter()
    model_checks = timed("3b:models", check_models_against_cpu)
    print(f"[models] card against CPU in {time.perf_counter() - t_models:.2f} s", flush=True)
    node_runtime = timed("3e:node_runtime", check_node_runtime_against_cpu)

    mains = {run[0]: timed("4:main_runs", run_main_path, *run) for run in MAIN_RUNS}
    mains.update(timed("4:fused", run_fused_pair))
    mains.update(timed("4:fused", run_fused_pair, "stale_flagship", STALE_SECTIONS))
    mains.update(timed("4:fused", run_fused_pair, "pipelined_flagship", PIPELINE_SECTIONS))
    for exchange in ("allgather", "ppermute"):
        mains.update(timed("4:kill_resume", run_kill_resume, exchange))
    gangs = timed("4:gangs", run_gangs)
    mains.update(gangs)
    print_gang_summary(gangs)
    pop_check = timed("4:population", check_population_against_cpu)
    pop_resume = timed("4:population", run_population_kill_resume)
    dmtt_check = timed("4:dmtt", check_dmtt_against_cpu)
    surface = timed("4:model_surface", run_model_surface)
    mains.update(surface)
    dmtt_gang = timed("4:dmtt_gang", run_dmtt_gang)
    mains.update(dmtt_gang)
    frontiers = {"frontier:frontier_krum": timed("4:frontier", run_frontier_smoke,
                                                 "frontier_krum", FRONTIER_KRUM),
                 "frontier:flagship": timed("4:frontier", run_frontier_smoke, "flagship",
                                            FLAGSHIP, FLAGSHIP_FRONTIER)}
    mains.update(frontiers)
    grids = {"grid:serve_grid": timed("4:grid", run_serve_grid_smoke),
             "grid:flagship": timed("4:grid", run_flagship_grid_smoke)}
    mains.update(grids)
    daemon = timed("4:serve", run_serve_daemon_smoke)
    flagship_daemon = timed("4:serve", run_flagship_daemon_smoke)
    mains["serve:flagship"] = flagship_daemon
    sharded = timed("4:sharded", run_sharded_smoke)
    mains.update(sharded)
    distributed = timed("4e:distributed", run_distributed_smoke)
    mains["krum:distributed_uci_har_byzantine"] = distributed
    pop, scen, dm = (mains["krum:population_1m"], mains["krum:population_1m_scenario"],
                     mains["fedavg:dmtt_mobility"])
    pop_s, scen_s = float(np.mean(pop["s_per_round"][1:])), float(np.mean(scen["s_per_round"][1:]))
    print(f"[population] population_1m.yaml as committed ({len(pop['s_per_round'])} rounds): "
          f"steady s/round {pop_s:.4f}, peak {pop['peak_gb']:.3f} GB; without its population: "
          f"block {scen_s:.4f}, peak {scen['peak_gb']:.3f} GB; the engine's cost "
          f"{(pop_s - scen_s) * 1e3:.2f} ms a round in the round times, which exclude "
          f"the swap (as the JAX package's do): swap_s median "
          f"{float(np.median(pop['swap_s'])):.6f} max {max(pop['swap_s']):.6f} (parts, "
          "median s: " + ", ".join(f"{k} {np.median(v):.6f}"
                                   for k, v in sorted(pop["swap_parts"].items()))
          + f"); steady wall a round with the swap "
          f"{pop_s + float(np.median(pop['swap_s'])):.4f}; "
          f"{pop['activated']:,} users activated; card vs CPU: cohorts equal "
          f"{pop_check['cohorts']}, {pop_check['differ']} picks differing, bank "
          f"{pop_check['bank_delta']:.3g}; killed at round {pop_resume['stopped']} and resumed "
          f"bit-equal {pop_resume['bit_equal']}; no claim", flush=True)
    print(f"[dmtt] dmtt_mobility.yaml as committed ({len(dm['s_per_round'])} rounds): steady "
          f"s/round {float(np.mean(dm['s_per_round'][1:])):.4f}, peak {dm['peak_gb']:.3f} GB; "
          f"the DMTT cross-evaluation {dm['probe_share']:.1%} of the steady rounds "
          f"({dm['probe_ms']:.2f} ms in all); card vs CPU: trust state within "
          f"{dmtt_check['trust_rel']:.3g} relative, parameters {dmtt_check['flat_delta']:.3g}, "
          f"{dmtt_check['tie_rows']} TopB row(s) on a tie; no claim", flush=True)
    dg = dmtt_gang["fedavg:gang_dmtt_mobility"]
    print(f"[dmtt:gang] dmtt_mobility.yaml as a gang of {dg['gang_size']} through run --seeds "
          f"(training.max_samples {DMTT_GANG_MAX_SAMPLES}, {len(dg['s_per_round'])} rounds): "
          f"steady s a gang round {_steady(dg['s_per_round']):.4f} against the members' summed "
          f"single-run rounds {dg['summed_single_s']:.4f}; members bit-equal to their single "
          f"runs {dg['bit_equal']}, history scaled delta {dg['delta']:.3g}, trust state within "
          f"{dg['trust_rel']:.3g} relative, TopB masks equal {dg['masks_equal']}; no kernel "
          f"launched (fedavg); peak {dg['peak_gb']:.3f} GB; no claim", flush=True)
    print("[models] the char-LSTM and the CelebA CNN at full width, 16 nodes, bfloat16 compute, "
          f"max_samples {SURFACE_MAX_SAMPLES}: steady s/round "
          + ", ".join(f"{k} {np.mean(surface[k]['s_per_round'][1:]):.4f} "
                      f"({surface[k]['peak_gb']:.2f} GB)" for k in surface)
          + "; float32 card vs CPU scaled deltas "
          + ", ".join(f"{k} {v['delta']:.3g}" for k, v in model_checks.items())
          + "; no claim", flush=True)
    steady = {k: float(np.mean(mains[k]["s_per_round"][1:]))
              for k in ("krum:allgather", "krum:telemetry_flagship")}
    print(f"[main:telemetry] steady s/round (rounds 2 on), the flagship's Krum allgather "
          f"{steady['krum:allgather']:.4f} plain, {steady['krum:telemetry_flagship']:.4f} with "
          "telemetry_audit_report.yaml's telemetry: section (taps, phase times, memory "
          "events); no claim", flush=True)
    pipe = {k: float(np.mean(mains[k]["s_per_round"][2:]))
            for k in ("krum:per_round_flagship", "krum:per_round_pipelined_flagship",
                      "krum:fused_pipelined_flagship")}
    print(f"[pipeline] steady s/round (rounds 3-{FUSED_ROUNDS}), the flagship's Krum allgather "
          f"per round: serialized {pipe['krum:per_round_flagship']:.4f}, pipelined "
          f"{pipe['krum:per_round_pipelined_flagship']:.4f}, pipelined fused in chunks of 2 "
          f"{pipe['krum:fused_pipelined_flagship']:.4f}; 3 rounds, rounds 2-3: serialized "
          f"{steady['krum:allgather']:.4f}, pipelined "
          f"{float(np.mean(mains['krum:pipelined_flagship']['s_per_round'][1:])):.4f} "
          f"(allgather), {float(np.mean(mains['krum:pipelined_ppermute']['s_per_round'][1:])):.4f}"
          f" (ppermute) against serialized "
          f"{float(np.mean(mains['krum:ppermute']['s_per_round'][1:])):.4f}; one stream, no "
          "overlap: no claim", flush=True)
    for exchange in ("allgather", "ppermute"):
        r, d = mains[f"krum:resumed_{exchange}"], mains[f"krum:durable_{exchange}"]
        print(f"[resume] {exchange}: killed with the snapshot at round {r['stopped']}, resumed: "
              f"bit-equal {r['bit_equal']}, scaled delta {r['delta']:.3g}; the uninterrupted "
              "run's snapshots " + ", ".join(
                  f"round {c['round']} {c['bytes']:,} B in {c['seconds']:.3f} s"
                  for c in d["checkpoints"]) + "; the killed and resumed processes' "
              + ", ".join(f"{a} round {rr} {b:,} B in {s_:.3f} s"
                          for a, rr, b, s_ in r["snapshots"]), flush=True)
    for exchange in ("allgather", "ppermute"):
        ad = mains[f"krum:adaptive_{'flagship' if exchange == 'allgather' else exchange}"]
        print(f"[adaptive] the flagship's Krum {exchange} with attack.adaptive (the bisection "
              f"around gaussian std 10), {ADAPTIVE_FLAGSHIP_ROUNDS} rounds: steady s/round "
              f"{float(np.mean(ad['s_per_round'][1:])):.4f} against the static run's "
              f"{float(np.mean(mains[f'krum:{exchange}']['s_per_round'][1:])):.4f} "
              f"({SMOKE_ROUNDS} rounds); peak {ad['peak_gb']:.2f} GB; no claim", flush=True)
    fk, ff = frontiers["frontier:frontier_krum"], frontiers["frontier:flagship"]
    print(f"[frontier] frontier_krum.yaml as committed: {fk['cells']} cells in "
          f"{fk['total_s']:.2f} s, peak {fk['peak_gb']:.3f} GB; the flagship-width frontier "
          f"(gangs of {1 + FLAGSHIP_FRONTIER['points']} at [16, P] float32): {ff['cells']} cells "
          f"in {ff['total_s']:.2f} s, stage s/round {[round(t, 4) for t in ff['stage_s']]}, "
          f"peak {ff['peak_gb']:.2f} GB; no claim", flush=True)
    sg, fg = grids["grid:serve_grid"], grids["grid:flagship"]
    print(f"[grid] serve_grid.yaml as committed: 50 cells in 5 buckets, {sg['buckets_s']:.3f} s "
          f"of bucket wall ({sg['process_s']:.2f} s the grid process), total_compiles "
          f"{sg['compiles']}; the flagship-width grid (gangs of 4 at [16, 6,603,710], ppermute): "
          f"12 cells in {fg['total_s']:.2f} s, s a gang round "
          f"{[round(t, 4) for t in fg['s_round']]}, peak {fg['peak_gb']:.2f} GB; no claim",
          flush=True)
    print(f"[serve] the daemon on serve_grid.yaml's base experiment: recovered after the SIGKILL, "
          f"socket answering {daemon['rebound_s']:.2f} s and every submission done "
          f"{daemon['recovered_s']:.2f} s after the restart, histories bit-equal "
          f"{daemon['bit_equal']} (scaled delta {daemon['delta']:.3g}); admission latency "
          + ", ".join(f"{k} {v:.4f} s" for k, v in daemon["admission_s"].items())
          + f"; the flagship daemon: generation 1 {flagship_daemon['gen1_s']:.2f} s (the bucket "
          f"built), generation 2 {flagship_daemon['gen2_s']:.2f} s, peak "
          f"{flagship_daemon['peak_gb']:.2f} GB; no claim", flush=True)
    w4, acc = sharded["sharded:world4"], sharded["sharded:acceptance"]
    print(f"[sharded] sharded_model.yaml on this card: one process, {SHARDED_MODEL.stem} "
          f"history within {sharded['sharded:committed']['delta']:.3g} scaled of "
          f"param_shards 1; a group of 4 on cuda:0 (gloo, staged): s a round on rank 0 "
          f"{[round(t, 4) for t in w4['round_times']]}, round-1 trained rows "
          f"{w4['trained']:.3g} scaled from one process, picks first differ in round "
          f"{w4['first_differing_round']}; the acceptance cell in a group of {ACCEPTANCE_WORLD}: s a round "
          f"{[round(t, 4) for t in acc['round_times']]}, peak a rank "
          f"{max(acc['peaks']) / 1e9:.3f} GB against {acc['one_process_peak'] / 1e9:.3f} GB in "
          f"one process; {len(acc['peaks'])} ranks share one card: a check of the collective "
          "code, not a speed of sharding; no claim", flush=True)
    mains.update(round64)
    flagship_s = float(sum(mains["krum:allgather"]["s_per_round"][1:])
                       / (len(mains["krum:allgather"]["s_per_round"]) - 1))
    print("[codec] ms a call on the card beside the flagship Krum allgather round's "
          f"{flagship_s * 1e3:.1f} ms: "
          + ", ".join(f"{k} {v:.3f} ms ({v / (flagship_s * 1e3):.2%})"
                      for k, v in codec_ms.items()), flush=True)
    replaces = {
        "pairwise_sq_distances": "murmura_tpu/ops/pallas_agg.py:319",
        "circulant_sq_distances": "murmura_tpu/ops/pallas_agg.py:225",
        "candidate_select": "murmura_tpu/ops/pallas_agg.py:440",
        "count_sketch": "murmura_tpu/ops/pallas_sketch.py:52",
    }
    sources = {
        "pairwise_sq_distances": "murmura_tpu_torch/csrc/agg_distances.cu",
        "circulant_sq_distances": "murmura_tpu_torch/csrc/agg_distances.cu",
        "candidate_select": "murmura_tpu_torch/csrc/candidate_select.cu",
        "count_sketch": "murmura_tpu_torch/csrc/count_sketch.cu",
    }
    # One entry per kernel: its launches summed over the main-path runs
    # (each run's own count under "launches_by_run"); its times and bound
    # summed over the phase-3 cases that main-path rounds make, one call of
    # each (every case's own numbers under "cases").
    kernels = []
    for name, rows in results.items():
        by_run = {lab: m["launches"][name] for lab, m in mains.items() if name in m["launches"]}
        round_rows = [r for r in rows if r["in_round"]]
        libs = [r["library_ms"] for r in round_rows]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            # The param groups' runs (summed over their ranks), also in the
            # totals above.
            "sharded": {lab: n for lab, n in by_run.items() if lab.startswith("sharded:")},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in round_rows),
            "plain_ms": sum(r["plain_ms"] for r in round_rows),
            "bound_ms": sum(r["bound_ms"] for r in round_rows),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None if None in libs else sum(libs),
            "cases": rows,
        })
    print("[time] by phase, s: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()),
          flush=True)
    print(f"[node-runtime] Krum {node_runtime['krum']['train_s']:.4f} s train, "
          f"{node_runtime['krum']['aggregate_s']:.4f} s aggregate on the card; Sketchguard "
          f"{node_runtime['sketchguard']['aggregate_s']:.4f} s aggregate; [distributed] boot "
          f"largest {max(distributed['boots'].values()):.2f} s, card memory of the 10 node "
          f"processes {distributed['mem_mib']:.0f} MiB, phase {distributed['wall']:.2f} s; "
          "no claim", flush=True)
    print(f"[time] every phase in {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
