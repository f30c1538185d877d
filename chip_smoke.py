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
   bit-equal, each timed;
3b. one round on the card against the same round on the CPU (same initial
   parameters, same injected draws), for each of four seeds, for Krum,
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
   scaled 1e-4, ``agg_pipe_valid`` [0, 1];
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
   each device's pick held within the score noise of the exact best;
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
   ``telemetry:`` sections (6 rounds, a snapshot every 2, both exchanges):
   once uninterrupted, then through ``python -m murmura_tpu_torch run`` in
   a subprocess SIGKILLed after its round-2 snapshot and run again, which
   resumes: the kernel launched twice a round for the rounds it ran,
   decisions equal, the history within a scaled 1e-4 of the uninterrupted
   run's (bit-equality printed), the telemetry stream appended with one
   ``run_resumed``, each snapshot's bytes and save or restore seconds
   printed.  A faulted run holds its alive and
   quarantined counts to the schedule and every kernel input finite; a
   compressed run prints its payload bytes an edge; a telemetry run reads
   its run dir back with the port's report (the memory event's peak equal
   to the allocator's, the audit taps to the schedule) and prints its
   per-node audit and its stale stats.
   The counters are set to 0 before each run and read after it: every
   kernel of that run must launch every round, no other kernel and no
   plain version may run,
   the history must have the JAX package's keys for the rule and finite
   values (and the evidential columns for an evidential model); each run
   prints its peak device memory, and UBAR's and evidential trust's their
   probe forwards' share of the round;
5. output: the pipelined flagship's steady seconds a round beside the
   serialized one's, the resumed runs' equality and snapshot costs, the
   codec's times beside the flagship round's, one
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
        # Read own and bcast once, write the output once; about m^2/2
        # compare-exchanges and m adds per output.
        _record(results, "candidate_select", label, max_err,
                lambda: C.candidate_select(o, b, offsets, trim=trim, median=median),
                lambda: C.candidate_select_plain(o, b, offsets, trim=trim, median=median),
                None, 3 * n * p * item, (m * (m - 1) / 2 + m) * n * p,
                in_round=(dtype == torch.float32 and median) if in_round is None else in_round,
                profile=True)
        del o, b
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


# Phase 3b's seeds: each draws its own data, initial parameters and draws.
ROUND_SEEDS = (7, 11, 19, 23)


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


# Phase 3c's rounds: (rule, exchange, params, {kernel: launches}, spread[,
# config sections: "compression", or "faults" naming the config whose
# faults: section to take]).
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
        cfg = {
            "experiment": {"name": f"n64-{rule}", "seed": 5, "rounds": 1, "verbose": False},
            "topology": {"type": "k-regular", "num_nodes": 64, "k": 4},
            "aggregation": {"algorithm": rule, "params": params},
            "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2,
                       "params": {"noise_std": 10.0}},
            "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.02},
            "data": {"adapter": "leaf.femnist", "params": {"num_samples": 64 * 40}},
            "model": {"factory": "leaf.femnist.tiny", "params": {}},
            "backend": "tpu",
            "tpu": {"exchange": exchange, "compute_dtype": "bfloat16"},
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
        r = bf16_roundings(rule, exchange == "ppermute")
        cpu32, card32 = new_cpu.float(), new_card.cpu().float()
        if rule == "geometric_median":
            ci, _ = candidate_indices(adj.cpu(), 5)
            cand = torch.cat([own.cpu()[:, None], bcast.cpu()[ci[:, 1:]]], dim=1)
            mag = cand.float().abs().max(dim=1).values
            del cand
        else:
            mag = torch.maximum(cpu32.abs(), own.cpu().float().abs())
        diff = (card32 - cpu32).abs()
        extra, trust_note = 0.0, ""
        if rule == "evidential_trust":
            extra, dw = trust_weight_term(state_card, state_cpu, float(stats_cpu["threshold"][0]),
                                          adj, bcast, bf16_weights=exchange == "allgather")
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
# stale_gossip.yaml's lever sections, taken onto the flagship.
STALE_SECTIONS = {"faults": "stale_gossip", "exchange": "stale_gossip",
                  "telemetry": "stale_gossip"}
# pipelined_rounds.yaml's and resumable_run.yaml's lever sections, taken
# onto the flagship.
PIPELINE_SECTIONS = {"exchange": "pipelined_rounds", "tpu": "pipelined_rounds"}
RESUME_SECTIONS = {"durability": "resumable_run", "compression": "resumable_run",
                   "telemetry": "resumable_run"}
# The audit taps each rule adds (telemetry.audit_taps).
RULE_TAPS = {"krum": ("selected_by", "considered_by")}
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
]
# Fused dispatch: the flagship's Krum allgather over FUSED_ROUNDS rounds,
# per round and with tpu.rounds_per_dispatch 2, in the same call.
FUSED_ROUNDS = 6


def _kernel_modules():
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    return (agg_kernels, candidate_kernels, sketch_kernels)


@contextlib.contextmanager
def timed_probes(events: list):
    """While open, the probe forwards of UBAR (the cross-evaluation and the
    own loss) and of evidential trust (the cross-evaluation) record a pair
    of CUDA events around each call into ``events``: device-stream time,
    with no synchronisation added to the round."""
    import torch

    from murmura_tpu_torch.aggregation import evidential_trust, ubar

    patched = [(ubar, "pairwise_probe_eval"), (ubar, "circulant_probe_eval"),
               (ubar, "self_probe_metrics"), (evidential_trust, "pairwise_probe_eval"),
               (evidential_trust, "circulant_probe_eval")]
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
    """While open, every fused chunk after the first of its size runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` (the first makes the
    wrappers' one-time device copies: the attack's compromised rows, the
    circulant offsets), and each synchronising call inside it lands in
    ``events`` as "file:line: message".  The mode's other warning (that it
    is a prototype) is not an event."""
    import warnings

    import torch

    from murmura_tpu_torch.core import network as net_mod

    real_build = net_mod.build_multi_round

    def build(program, chunk, eval_every):
        fn = real_build(program, chunk, eval_every)
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

    net_mod.build_multi_round = build
    try:
        yield
    finally:
        net_mod.build_multi_round = real_build


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
    (emptied first) and ``opts["checkpoint_every"]`` if given."""
    import yaml

    raw = yaml.safe_load(config.read_text())
    raw["experiment"]["rounds"] = opts.get("rounds", SMOKE_ROUNDS)
    if exchange is not None:
        raw["backend"] = "tpu"
        raw.setdefault("tpu", {})["exchange"] = exchange
    if aggregation is not None:
        raw["aggregation"] = aggregation
    if opts.get("attack") is not None:
        raw["attack"] = opts["attack"]
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
    audit = bool(tel.get("enabled") and tel.get("audit_taps"))

    mods = _kernel_modules()
    probe_events: list = []
    finite_flags: list = []
    sync_events: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_probes(probe_events))
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
    if audit:
        want |= {f"agg_tap_{k}" for k in RULE_TAPS.get(rule, ())}
        if faulted:
            want |= {f"agg_tap_{k[4:]}" for k in want & {
                "agg_alive", "agg_quarantined", "agg_attack_scrubbed"}}
        if stale:
            want |= {"agg_tap_stale_used", "agg_tap_stale_age"}
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
    if network.checkpoints:
        extra += "; snapshots " + ", ".join(
            f"{c['action']} round {c['round']} {c['bytes']:,} B in {c['seconds']:.3f} s"
            for c in network.checkpoints)
    if tel.get("enabled"):
        extra += "; " + read_telemetry(label, Path(tel["dir"]), tel, network, rounds, faults,
                                       peak_bytes)
    probe_ms = sum(a.elapsed_time(b) for a, b in probe_events)
    if probe_events:
        steady = float(np.sum(rt[1:]))
        steady_ms = sum(a.elapsed_time(b) for a, b in probe_events[len(probe_events) // len(rt):])
        extra += (f"; probe forwards {probe_ms:.2f} ms in {len(probe_events)} calls, "
                  f"{steady_ms / 1e3 / steady:.1%} of the steady rounds")
    print(f"[main:{label}] P={network.program.model_dim} N={network.program.num_nodes} "
          f"round seconds {[round(t, 4) for t in rt]}; steady s/round "
          f"{np.mean(rt[1:]):.4f}; run wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB "
          f"({base_gb:.2f} GB held before the run); "
          f"final mean accuracy {hist['mean_accuracy'][-1]:.4f}{extra}", flush=True)
    if sync_events:
        raise AssertionError("a fused chunk synchronised with the host")
    checkpoints = list(network.checkpoints)
    del network, history
    held_gb = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    print(f"[main:{label}] held once the run is dropped, before the cycle collector: "
          f"{held_gb:.2f} GB, after it {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] for k in expect}, "s_per_round": rt,
            "peak_gb": peak_gb, "probe_ms": probe_ms, "history": hist,
            "checkpoints": checkpoints}


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


# The flagship under RESUME_SECTIONS: rounds, and the snapshot cadence.
RESUME_ROUNDS, RESUME_EVERY = 6, 2
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


def main() -> int:
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
    check_kernels(results)
    codec_ms = check_codec()
    check_round_against_cpu()
    check_pipelined_against_cpu()
    round64 = check_round_n64_bf16()

    mains = {run[0]: run_main_path(*run) for run in MAIN_RUNS}
    mains.update(run_fused_pair())
    mains.update(run_fused_pair("stale_flagship", STALE_SECTIONS))
    mains.update(run_fused_pair("pipelined_flagship", PIPELINE_SECTIONS))
    for exchange in ("allgather", "ppermute"):
        mains.update(run_kill_resume(exchange))
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
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in round_rows),
            "plain_ms": sum(r["plain_ms"] for r in round_rows),
            "bound_ms": sum(r["bound_ms"] for r in round_rows),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None if None in libs else sum(libs),
            "cases": rows,
        })
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
