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
   timed the other way);
3b. one round of the tiny CNN on the card against the same round on the CPU
   (same initial parameters, same injected draws), for each of four seeds,
   for Krum, median, trimmed mean, geometric median, BALANCE, Sketchguard
   and fedavg;
3c. one round of the tiny CNN at 64 nodes, k-regular(4), ppermute, in the
   parameter dtype the configs take by default from 64 nodes up
   (bfloat16), for the median and the trimmed mean, the counters set to 0
   just before and read just after: one candidate-select launch, no plain
   call, finite parameters, and the kernel equal bit for bit to the plain
   version on the round's own pre-aggregation states;
4. main path: ``examples/configs/femnist_krum_tpu.yaml`` as committed
   (baseline CNN at full width, 16 nodes, k-regular(4), bf16 compute, 20%
   gaussian std 10), rounds cut to 3, through the port's ``run`` entry,
   once per (rule, exchange): Krum, geometric median and BALANCE under
   allgather and ppermute, median and trimmed mean under ppermute,
   Sketchguard under both; then
   ``examples/configs/basic_fedavg.yaml`` as committed, cut to 3 rounds.
   The counters are set to 0 before each run and read after it: every
   kernel of that run must launch every round, no plain version may run,
   the history must have the JAX package's keys for the rule and finite
   values;
5. output: one ``{"kernels": [...]}`` JSON line, the card line, and the
   ``{"ok": true, "device": ...}`` line last.

It imports nothing of JAX or of the JAX package.  Without CUDA, or run
from a directory that lacks the port, it exits non-zero and prints no
result.
"""

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "examples" / "configs" / "femnist_krum_tpu.yaml"
BASIC_FEDAVG = ROOT / "examples" / "configs" / "basic_fedavg.yaml"
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


# Phase 3b's rules: (label, rule, params, stats that must be equal).
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
]


# Phase 3b's seeds: each draws its own data, initial parameters and draws.
ROUND_SEEDS = (7, 11, 19, 23)


def check_round_against_cpu(device: str = "cuda") -> None:
    """Phase 3b: one round of the tiny CNN (16 nodes, k-regular(4), float32
    compute, 20% gaussian std 10) per rule and seed on the card and on the
    CPU, from the same initial parameters and the same injected draws
    (shuffle and noise).  The card runs the kernels, the CPU their plain
    versions; on every seed the post-round parameters must agree to a
    scaled delta of 1e-4, and Krum's selection and the filters' acceptance
    must be equal.  Every seed runs before a failure is raised, so the line
    shows the largest delta."""
    import numpy as np
    import torch

    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.models.cnn import make_femnist_cnn
    from murmura_tpu_torch.ops.flatten import model_dimension, tree_map
    from murmura_tpu_torch.topology.generators import create_topology

    n, offsets = 16, [1, 2, 14, 15]
    model = make_femnist_cnn(variant="tiny")
    adj = create_topology("k-regular", n, k=4).mask()
    inputs = {}
    for seed in ROUND_SEEDS:
        data = build_federated_data("leaf.femnist", {"num_samples": 640}, num_nodes=n, seed=seed)
        rng = np.random.default_rng(seed)
        template = model.init(torch.Generator().manual_seed(seed), "cpu")
        # One common model plus per-node offsets of distinct scales, so that
        # Krum's scores are far apart compared with float32 summation noise.
        scale = 0.02 * (1.0 + np.arange(n) / n)
        init = tree_map(
            lambda t: (t.numpy()[None] + scale.reshape((n,) + (1,) * t.dim())
                       * rng.normal(size=(n,) + tuple(t.shape))).astype(np.float32),
            template,
        )
        u = rng.random(data.mask.shape).astype(np.float32)
        inputs[seed] = (data, init, u, model_dimension(template))
    for label, rule, params, equal_stats in ROUND_RULES:
        kw = {k: v for k, v in params.items() if k != "circulant"}
        if params.get("circulant"):
            kw["exchange_offsets"] = offsets
        if rule in ("krum", "median", "trimmed_mean", "geometric_median"):
            kw["max_candidates"] = len(offsets) + 1
        deltas, unequal, ok = [], [], True
        for seed, (data, init, u, model_dim) in inputs.items():
            out = {}
            for dev in (device, "cpu"):
                attack = make_gaussian_attack(n, 0.2, noise_std=10.0, seed=seed)
                prog = build_round_program(
                    model, build_aggregator(rule, kw, model_dim=model_dim), data,
                    attack=attack, local_epochs=1, batch_size=16, lr=0.05, seed=seed,
                    device=dev, init_params=init,
                )
                noise = np.random.default_rng(seed + 1).normal(
                    size=(int(attack.compromised.sum()), prog.model_dim)).astype(np.float32)
                comp = torch.as_tensor(attack.compromised.astype(np.float32)).to(dev)
                flat, _, metrics = prog.train_step(
                    prog.init_flat, prog.init_agg_state, torch.as_tensor(adj).to(dev), comp, 0.0,
                    draws={"u": [u], "noise": noise},
                )
                out[dev] = (flat.cpu().double(), {k: v.cpu() for k, v in metrics.items()})
            (f_card, m_card), (f_cpu, m_cpu) = out[device], out["cpu"]
            delta = float((f_card - f_cpu).abs().max() / max(1.0, float(f_cpu.abs().max())))
            deltas.append(delta)
            unequal += [f"{k} (seed {seed})" for k in equal_stats
                        if not torch.equal(m_card[k], m_cpu[k])]
            ok = ok and delta <= 1e-4 and bool(torch.isfinite(f_card).all())
        ok = ok and not unequal
        shown = ""
        if equal_stats:
            shown = (f"; {', '.join(equal_stats)} == CPU on every seed" if not unequal
                     else f"; differs from the CPU: {', '.join(unequal)}")
        print(f"[round] {label}, tiny CNN, card vs CPU, seeds {list(ROUND_SEEDS)}: scaled "
              f"param delta {', '.join(f'{d:.3g}' for d in deltas)} (largest "
              f"{max(deltas):.3g}, limit 1e-4){shown}: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"a {label} round on the card disagrees with the CPU round")


def check_round_n64_bf16() -> dict:
    """Phase 3c: one tiny-CNN round at 64 nodes, k-regular(4), ppermute,
    parameters in the dtype the configs take by default from 64 nodes up,
    for the median and the trimmed mean, through ``cli.run``.  The counters
    are set to 0 just before each run and read just after; the states the
    rule hands the candidate kernel are kept and the kernel is held against
    the plain version on them afterwards (bit-equal)."""
    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch import cli
    from murmura_tpu_torch.aggregation import robust_stats

    mods = _kernel_modules()
    C = robust_stats.candidate_kernels
    runs = {}
    for rule, params in (("median", {}), ("trimmed_mean", {"trim_ratio": 0.2})):
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
            "tpu": {"exchange": "ppermute", "compute_dtype": "bfloat16"},
        }
        SMOKE_DIR.mkdir(parents=True, exist_ok=True)
        path = SMOKE_DIR / f"n64_{rule}.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        seen = []
        kernel = C.candidate_select

        def keep(own, bcast, offsets, trim=0, median=False):
            seen.append((own.clone(), bcast.clone(), list(offsets), trim, median))
            return kernel(own, bcast, offsets, trim=trim, median=median)

        C.candidate_select = keep
        try:
            for mod in mods:
                mod.reset_counts()
            _, network = cli.run(path, output=SMOKE_DIR / f"history_n64_{rule}.json",
                                 device="cuda")
            torch.cuda.synchronize()
            launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
            plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
        finally:
            C.candidate_select = kernel
        own, bcast, offsets, trim, median = seen[0]
        got = C.candidate_select(own, bcast, offsets, trim=trim, median=median)
        ref = C.candidate_select_plain(own, bcast, offsets, trim=trim, median=median)
        equal = torch.equal(got, ref)
        finite = bool(torch.isfinite(network.flat).all())
        ok = (launches["candidate_select"] == 1 and not any(plain.values()) and equal and finite
              and len(seen) == 1 and own.dtype == torch.bfloat16)
        print(f"[round64] {rule}: tiny CNN, 64 nodes, ppermute, parameters "
              f"{str(network.flat.dtype).replace('torch.', '')}, state [{own.shape[0]}, "
              f"{own.shape[1]}] {str(own.dtype).replace('torch.', '')}, offsets {offsets}, "
              f"{'median' if median else f'trim {trim}'}; launches {launches}, plain-version "
              f"calls {plain}; kernel == plain on the round's states: {equal}; final "
              f"parameters finite: {finite}; round seconds "
              f"{[round(t, 4) for t in network.round_times]}: {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            raise AssertionError(f"the 64-node bfloat16 {rule} round failed its checks")
        runs[f"{rule}:n64-bf16"] = {"launches": {"candidate_select": launches["candidate_select"]},
                                    "s_per_round": list(np.asarray(network.round_times))}
        del network, seen, own, bcast, got, ref
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
}
# Phase 4's runs: (label, config, exchange, aggregation or None for the
# config's own, {kernel: launches a round, exact or at least}).
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
]


def _kernel_modules():
    from murmura_tpu_torch.ops import agg_kernels, candidate_kernels, sketch_kernels

    return (agg_kernels, candidate_kernels, sketch_kernels)


def run_main_path(label, config, exchange, aggregation, expect) -> dict:
    """Phase 4: one config through ``murmura_tpu_torch.cli.run`` on the card,
    the kernel counters set to 0 just before and read just after."""
    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch import cli
    from murmura_tpu_torch.core.network import empty_history

    raw = yaml.safe_load(config.read_text())
    raw["experiment"]["rounds"] = SMOKE_ROUNDS
    if exchange is not None:
        raw["tpu"]["exchange"] = exchange
    if aggregation is not None:
        raw["aggregation"] = aggregation
    rule = raw["aggregation"]["algorithm"]
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    name = label.replace(":", "_")
    cfg = SMOKE_DIR / f"{name}.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out = SMOKE_DIR / f"history_{name}.json"

    mods = _kernel_modules()
    for mod in mods:
        mod.reset_counts()
    t0 = time.perf_counter()
    history, network = cli.run(cfg, output=out, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}

    print(f"[main:{label}] launches {launches}, plain-version calls {plain}", flush=True)
    for kernel, (per_round, op) in expect.items():
        want = per_round * SMOKE_ROUNDS
        if not (launches[kernel] == want if op == "==" else launches[kernel] >= want):
            raise AssertionError(f"{kernel} launched {launches[kernel]} times in "
                                 f"{SMOKE_ROUNDS} rounds (want {op} {per_round} a round)")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card path: {plain}")
    hist = json.loads(out.read_text())
    want = set(empty_history()) | {f"agg_{k}" for k in RULE_STATS[rule]}
    if set(hist) != want:
        raise AssertionError(f"history keys {sorted(hist)} != {sorted(want)}")
    if len(hist["round"]) != SMOKE_ROUNDS:
        raise AssertionError(f"history has {len(hist['round'])} rounds")
    for k, v in hist.items():
        if v and not np.all(np.isfinite(np.asarray(v, dtype=np.float64))):
            raise AssertionError(f"history[{k!r}] is not finite: {v}")
    if not torch.isfinite(network.flat).all():
        raise AssertionError("final parameters are not finite")
    rt = network.round_times
    extra = ""
    if "agg_acceptance_rate" in hist:
        extra = f"; acceptance rate {hist['agg_acceptance_rate']}"
    print(f"[main:{label}] P={network.program.model_dim} N={network.program.num_nodes} "
          f"round seconds {[round(t, 4) for t in rt]}; steady s/round "
          f"{np.mean(rt[1:]):.4f}; run wall {wall:.2f} s; final mean accuracy "
          f"{hist['mean_accuracy'][-1]:.4f}{extra}", flush=True)
    del network
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] for k in expect}, "s_per_round": rt}


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
    check_round_against_cpu()
    round64 = check_round_n64_bf16()

    mains = {run[0]: run_main_path(*run) for run in MAIN_RUNS}
    mains.update(round64)
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
