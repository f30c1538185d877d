#!/usr/bin/env python3
"""Time the port's two distance kernels, ``pairwise_l2_distances`` around
the pairwise one, the count sketch and fused candidate selection, on one
CUDA card, for the ``murmura_tpu_torch`` package found under ``--root``
(default: this checkout).

    python3 bench_torch_distances.py [--root DIR] [--reps 20]

Inputs are built as chip_smoke.py builds them, at two shapes: the
flagship's [16, 6,603,710] float32 (P of leaf.femnist.baseline) and
[64, 1,048,576], with k-regular(4) offsets.  Cases at each: pairwise
(bcast, bcast) and (own, bcast), circulant (own, bcast, offsets) and
(bcast, bcast, deltas), ``pairwise_l2_distances(bcast)`` and
``(own, bcast)``, which include the centering, and ``count_sketch`` of own
and of bcast with Sketchguard's tables (S = 1000, seed 42, built once per
shape by the package under test); then ``candidate_select`` at
[16, 6,603,710] (float32 median and trim 1, bfloat16 trim 1 and median)
and [64, 6,603,710] bfloat16 (trim 1 and median), k-regular(4) offsets.  A
package whose pairwise wrapper takes
no center gets its rows centered before the timed kernel calls.  To
compare two trees, unpack the other one into a directory that .gitignore
lists, pass it as ``--root`` and run the two in turns (A, B, B, A) in one
call on one card.  Prints the card line, then one JSON line per case:
CUDA-event ms, profiler device ms per call and the device ms by kernel.

    python3 bench_torch_distances.py --sketch-variants

times this checkout's count-sketch kernel beside variants built from its
source with a few lines replaced (``SKETCH_VARIANTS``): the copies alone,
the walk alone, and the designs it was chosen over.  They run in turns,
five rounds of ``--reps`` calls each, on the same inputs; each line has the
median CUDA-event ms of the rounds, and, for the variants that compute the
whole sketch, whether they agree with the plain version and with
themselves on a repeat call.

    python3 bench_torch_distances.py --candidate-variants

does the same for the candidate-select kernel (``CANDIDATE_VARIANTS``: the
copies alone, the sort alone, the NaN-aware comparator on every warp, the
window with median and trim known only at run time) at [16, 6,603,710]
float32 median and trim 1 and bfloat16 trim 1, and at [64, 6,603,710]
bfloat16 trim 1; the variants that compute the whole result are checked
bit-equal to the plain version and to themselves.

    python3 bench_torch_distances.py --circulant-split --reps 5

times the circulant pass (two tensors, k-regular(4) offsets) as one
launch and as the wrapper's split into 138-row launches, at every tile
width one launch takes on the way to the row cap (``SPLIT_ROWS``) and at
P = 4,096 and 262,144: CUDA-event and device ms of each, both checked
against the plain version.
"""

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FLAGSHIP_P = 6_603_710

_FLAT_WALK = """      for (int j = 0; j < n; ++j) {"""
_V_COPY = """for (int i = threadIdx.x; i < lenv; i += NT) cp_async<4 * VEC>(dst + i * VEC, src + i * VEC);"""
_PAIR_WALK = """    for (int k = 0; k < KB; k += 2) {
      const int k1 = k + 1 < KB ? k + 1 : k;
      const int n0 = se[k] - sb[k];
      const int n = n0 + (k1 != k ? se[k1] - sb[k1] : 0);
      for (int j = 0; j < n; ++j) {
        const bool first = j < n0;
        const unsigned int e = ent[first ? sb[k] + j : sb[k1] + j - n0];"""
_ONE_WALK = """    for (int k = 0; k < KB; ++k) {
      const int k1 = k;
      for (int q = sb[k]; q < se[k]; ++q) {
        const bool first = true;
        const unsigned int e = ent[q];"""
_ROW_COPY = """  for (int r = 0; r < nrows; ++r) {
    const float* src = v + (long long)(r0 + r) * p + p0;
    float* dst = slot + r * l;
    """ + _V_COPY + """
  }"""
_INTERLEAVED_COPY = """  (void)lenv;
  const int len = (int)min((long long)l, p - p0);
  for (int i = threadIdx.x; i < R_G * len; i += NT) {
    const int c = i / R_G, r = i % R_G;
    if (r < nrows) cp_async<4>(slot + i, v + (long long)(r0 + r) * p + p0 + c);
  }"""
# (label, {source text: replacement}, slice length, rows a walk, ring slots).
SKETCH_VARIANTS = [
    ("kernel", {}, 4096, 4, 3),
    ("copies only (no walk)", {_FLAT_WALK: "      for (int j = 0; j < 0; ++j) {"}, 4096, 4, 3),
    ("walk only (no copies of v)", {_V_COPY: ";"}, 4096, 4, 3),
    ("one bucket a walk", {_PAIR_WALK: _ONE_WALK}, 4096, 4, 3),
    ("rows interleaved, one 16-byte gather an entry",
     {_ROW_COPY: _INTERLEAVED_COPY,
      "const float* xp = x + (e & 0x7fffu);":
      "const float4 xv = reinterpret_cast<const float4*>(x)[e & 0x7fffu];"
      " const float xr[4] = {xv.x, xv.y, xv.z, xv.w};",
      "xp[r * l]": "xr[r]"}, 4096, 4, 3),
    ("8 rows a walk", {"constexpr int R_G = 4;": "constexpr int R_G = 8;"}, 2048, 8, 3),
    ("4 ring slots", {"constexpr int STAGES = 3;": "constexpr int STAGES = 4;"}, 3072, 4, 4),
]


_FAST_F32 = """  const float lo = fminf(a, b);
  const float hi = max_nan(a, b);"""
_AFTER_F32 = """  const bool s = after(a, b);
  const float lo = s ? b : a;
  const float hi = s ? a : b;"""
_FAST_BF16 = """  const __nv_bfloat162 lo = __hmin2(a, b);
  const __nv_bfloat162 hi = __hmax2_nan(a, b);"""
_AFTER_BF16 = """  const bool s0 = after(__low2float(a), __low2float(b));
  const bool s1 = after(__high2float(a), __high2float(b));
  const __nv_bfloat162 lo = __halves2bfloat162(s0 ? b.x : a.x, s1 ? b.y : a.y);
  const __nv_bfloat162 hi = __halves2bfloat162(s0 ? a.x : b.x, s1 ? a.y : b.y);"""
_GENERIC = "// Generic m: insertion sort"
_WINDOW_RT = """template <int M, int C>
__device__ __forceinline__ float window_rt(const float (&v)[M][C], int c, int trim, int median,
                                           float inv_keep) {
  if (median) return __fmul_rn(0.5f, __fadd_rn(v[(M - 1) / 2][c], v[M / 2][c]));
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (j == trim) acc = v[j][c];
    else if (j > trim && j < M - trim) acc = __fadd_rn(acc, v[j][c]);
  }
  return __fmul_rn(acc, inv_keep);
}

"""
# (label, {source text of csrc/candidate_select.cu: replacement}).
CANDIDATE_VARIANTS = [
    ("kernel", {}),
    ("copies only (no sort)",
     {"for (int e = tid; e < items; e += NT) {": "for (int e = tid; e < 0; e += NT) {"}),
    ("sort only (copies of the first three tiles only)",
     {"if (next < count) load(next,": "if (next < count && next < STAGES) load(next,"}),
    ("NaN-aware comparator of PR 2 (a > b, or a NaN and b not; two selects)",
     {_FAST_F32: _AFTER_F32, _FAST_BF16: _AFTER_BF16}),
    ("median and trim at run time",
     {_GENERIC: _WINDOW_RT + _GENERIC,
      "window<M, MODE, CPT>(x, cc, inv_keep)": "window_rt<M, CPT>(x, cc, trim, median, inv_keep)"}),
]


def _build_variants(name: str, variants) -> list:
    """Build each variant of csrc/<name>.cu (its source with a few lines
    replaced), one nvcc a variant, all at once; their loaded libraries."""
    import ctypes
    import subprocess

    from murmura_tpu_torch.ops import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, subs, *_rest) in enumerate(variants):
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {label!r}: its source text is gone from {name}.cu")
            text = text.replace(old, new)
        (out_dir / f"{name}_v{i}.cu").write_text(text)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}_v{i}.so"),
             str(out_dir / f"{name}_v{i}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, proc in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {variants[i][0]!r} does not build:\n{log}")
        libs.append(ctypes.CDLL(str(out_dir / f"{name}_v{i}.so")))
    return libs


def candidate_variants(reps: int) -> int:
    """Build CANDIDATE_VARIANTS from csrc/candidate_select.cu, time them in
    turns."""
    import torch

    import chip_smoke
    from murmura_tpu_torch.ops import candidate_kernels as C

    libs = [C.bind(lib) for lib in _build_variants("candidate_select", CANDIDATE_VARIANTS)]
    print(chip_smoke.card_line(), flush=True)
    for n, cases in ((16, ((torch.float32, True, 0), (torch.float32, False, 1),
                           (torch.bfloat16, False, 1))),
                     (64, ((torch.bfloat16, False, 1),))):
        offsets = [1, 2, n - 2, n - 1]
        own, bcast = chip_smoke.krum_inputs(n, FLAGSHIP_P, 1234 if n == 16 else 6464)
        for dtype, median, trim in cases:
            o, b = own.to(dtype), bcast.to(dtype)
            out = torch.empty_like(o)
            calls = [(label, lambda lib=lib: C.launch(lib, o, b, offsets, trim, median, out))
                     for lib, (label, _) in zip(libs, CANDIDATE_VARIANTS)]
            ref = C.candidate_select_plain(o, b, offsets, trim=trim, median=median)
            times = {label: [] for label, _ in calls}
            for _ in range(5):
                for label, call in calls:
                    times[label].append(chip_smoke.time_ms(call, reps))
            case = (f"[{n}, {FLAGSHIP_P}] {str(dtype).replace('torch.', '')} "
                    f"{'median' if median else f'trim {trim}'}")
            for label, call in calls:
                rec = {"case": case, "variant": label, "ms": sorted(times[label])[2],
                       "ms_rounds": times[label]}
                if "only" not in label:
                    call()
                    got = out.clone()
                    call()
                    rec["equal_to_plain"] = bool(torch.equal(got, ref))
                    rec["repeat_bit_equal"] = bool(torch.equal(got, out))
                print(json.dumps(rec), flush=True)
            del o, b, out, ref, calls
            torch.cuda.empty_cache()
        del own, bcast
        torch.cuda.empty_cache()
    return 0


# Circulant rows N of a two-tensor call at which one launch's plan takes
# each tile width on the way to the row cap (8-byte copies): 16 columns
# (139, 260), 8 (469), 4 (782), 2 (1,173), then one block an SM: 4 (1,614)
# and 2 (2,421, the cap); and the P of the sweep.
SPLIT_ROWS = (139, 260, 469, 782, 1173, 1614, 2421)
SPLIT_P = (4096, 262_144)


def circulant_split_sweep(reps: int) -> int:
    """Time the circulant pass (own, bcast, k-regular(4) offsets) as one
    launch and as the split into circulant_split_rows-row launches, at each
    N of SPLIT_ROWS and P of SPLIT_P: CUDA-event and profiler device ms,
    both checked against the plain version."""
    import torch

    import chip_smoke
    from murmura_tpu_torch.ops import agg_kernels as K

    print(chip_smoke.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for p in SPLIT_P:
        for n in SPLIT_ROWS:
            own, bcast = chip_smoke.krum_inputs(n, p, n)
            offsets = [1, 2, n - 2, n - 1]
            vec = K._vec(p, own, bcast)
            plan = K.circulant_plan(n, p, len(offsets), False, vec, sms)
            rows = K.circulant_split_rows(vec)
            ref = K.circulant_sq_distances_plain(own, bcast, offsets)
            limit = 1e-5 * torch.clamp(ref.abs(), min=1.0)
            ways = (
                ("one launch", lambda: K.circulant_launch(own, bcast, offsets)),
                ("split", lambda: K.circulant_split_call(own, bcast, offsets, rows,
                                                         K.circulant_launch)),
            )
            for way, fn in ways:
                ok = bool(((fn() - ref).abs() <= limit).all())
                ms = chip_smoke.time_ms(fn, reps)
                dev = chip_smoke.device_split(fn, reps)
                print(json.dumps({
                    "n": n, "p": p, "way": way, "tile_columns": 1 << plan["tc_log2"],
                    "blocks": plan["gx"] * plan["gy"], "smem": plan["smem"],
                    "launches": 1 if way == "one launch" else len(K.circulant_split(n, offsets, rows)),
                    "ms": ms, "device_ms": sum(dev.values()) if dev else None,
                    "within_limit": ok,
                }), flush=True)
            del own, bcast, ref, limit
            torch.cuda.empty_cache()
    return 0


def sketch_variants(reps: int) -> int:
    """Build SKETCH_VARIANTS from csrc/count_sketch.cu, time them in turns."""
    import ctypes
    import math

    import torch

    import chip_smoke
    from murmura_tpu_torch.ops import sketch_kernels as SK
    from murmura_tpu_torch.ops.sketch import make_sketch_tables

    libs = []
    for lib in _build_variants("count_sketch", SKETCH_VARIANTS):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sketch_count.argtypes = [vp, vp, vp, i32, i64, i32, i32, i32, i32, i32, i32, i32,
                                     vp, vp, vp]
        libs.append(lib)
    print(chip_smoke.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    s = 1000
    for n, p, seed in ((16, FLAGSHIP_P, 1234), (64, 1 << 20, 4321)):
        own, _ = chip_smoke.krum_inputs(n, p, seed)
        h, sign = make_sketch_tables(p, s, 42)
        tables = {}
        calls = []
        for lib, (label, subs, slice_len, rg, stages) in zip(libs, SKETCH_VARIANTS):
            if slice_len not in tables:
                tables[slice_len] = SK.SketchTables(h, sign, s, slice_len)
            t = tables[slice_len].kernel_on(own.device)
            plan = SK.sketch_plan(n, p, s, slice_len, sms)
            gx = max(1, min(math.ceil(p / slice_len), sms // math.ceil(n / rg)))
            smem = stages * (rg * slice_len * 4 + slice_len * 2)
            work = torch.empty(n * s * (1 + gx), device=own.device)

            def call(lib=lib, t=t, slice_len=slice_len, kb=plan["kb"], gx=gx, smem=smem,
                     work=work, label=label):
                err = lib.sketch_count(
                    own.data_ptr(), t["entries"].data_ptr(), t["starts"].data_ptr(), n, p, s,
                    slice_len, SK._vec(p, own), kb, gx, 1, smem,
                    work.data_ptr() + 4 * n * s, work.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                SK.raise_on(label, err)
                return work[:n * s].view(n, s)
            calls.append((label, call, "only" not in label))
        ref = SK.count_sketch_plain(own, tables[4096])
        scale = torch.zeros((n, s), device=own.device).index_add_(
            1, tables[4096].plain_on(own.device)["hash"], own.abs())
        times = {label: [] for label, _, _ in calls}
        for _ in range(5):
            for label, call, _ in calls:
                times[label].append(chip_smoke.time_ms(call, reps))
        for label, call, whole in calls:
            rec = {"n": n, "p": p, "variant": label, "ms": sorted(times[label])[2],
                   "ms_rounds": times[label]}
            if whole:
                got, again = call().clone(), call()
                rec["within_limit"] = bool(((got - ref).abs() <= 1e-4 * scale).all())
                rec["repeat_bit_equal"] = bool(torch.equal(got, again))
            print(json.dumps(rec), flush=True)
        del own, tables, ref, scale, calls
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="directory holding murmura_tpu_torch/")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sketch-variants", action="store_true",
                    help="time this checkout's count-sketch kernel beside SKETCH_VARIANTS")
    ap.add_argument("--candidate-variants", action="store_true",
                    help="time this checkout's candidate-select kernel beside CANDIDATE_VARIANTS")
    ap.add_argument("--circulant-split", action="store_true",
                    help="time the circulant pass as one launch and split, over SPLIT_ROWS x SPLIT_P")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not (root / "murmura_tpu_torch").is_dir():
        print(f"no murmura_tpu_torch/ under {root}", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_distances.py: needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke

    if args.sketch_variants:
        return sketch_variants(args.reps)
    if args.candidate_variants:
        return candidate_variants(args.reps)
    if args.circulant_split:
        return circulant_split_sweep(args.reps)
    sys.path.insert(0, str(root))
    from murmura_tpu_torch.aggregation.base import pairwise_l2_distances
    from murmura_tpu_torch.ops import agg_kernels as K
    from murmura_tpu_torch.ops import sketch_kernels as SK
    from murmura_tpu_torch.ops.sketch import build_sketch_tables

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    fused = "center" in inspect.signature(K.pairwise_sq_distances).parameters
    for n, p, seed in ((16, FLAGSHIP_P, 1234), (64, 1 << 20, 4321)):
        own, bcast = chip_smoke.krum_inputs(n, p, seed)
        offsets = [1, 2, n - 2, n - 1]
        deltas = sorted({abs(b - a) for a in offsets for b in offsets if a != b})
        cb, co = bcast.mean(dim=0), own.mean(dim=0)
        tables = build_sketch_tables(p, 1000, 42)
        if fused:
            pw_same = lambda: K.pairwise_sq_distances(bcast, None, center=cb)  # noqa: E731
            pw_two = lambda: K.pairwise_sq_distances(own, bcast, center=co)  # noqa: E731
        else:
            bb, ob, bo = bcast - cb, own - co, bcast - co
            pw_same = lambda: K.pairwise_sq_distances(bb)  # noqa: E731
            pw_two = lambda: K.pairwise_sq_distances(ob, bo)  # noqa: E731
        cases = [
            ("pairwise_sq_distances (bcast, bcast)", pw_same),
            ("pairwise_sq_distances (own, bcast)", pw_two),
            (f"circulant_sq_distances (own, bcast, offsets {offsets})",
             lambda: K.circulant_sq_distances(own, bcast, offsets)),
            (f"circulant_sq_distances (bcast, bcast, deltas {deltas})",
             lambda: K.circulant_sq_distances(bcast, bcast, deltas)),
            ("pairwise_l2_distances (bcast)", lambda: pairwise_l2_distances(bcast)),
            ("pairwise_l2_distances (own, bcast)", lambda: pairwise_l2_distances(own, bcast)),
            ("count_sketch (own, S 1000)", lambda: SK.count_sketch(own, tables)),
            ("count_sketch (bcast, S 1000)", lambda: SK.count_sketch(bcast, tables)),
        ]
        for label, fn in cases:
            ms = chip_smoke.time_ms(fn, args.reps)
            split = chip_smoke.device_split(fn, args.reps)
            print(json.dumps({"root": str(root), "n": n, "p": p, "case": label, "ms": ms,
                              "device_ms": sum(split.values()) if split else None,
                              "device_split": split}), flush=True)
        del own, bcast, cb, co, tables
        if not fused:
            del bb, ob, bo
        torch.cuda.empty_cache()
    from murmura_tpu_torch.ops import candidate_kernels as C

    for n, cases in ((16, ((torch.float32, True, 0), (torch.float32, False, 1),
                           (torch.bfloat16, False, 1), (torch.bfloat16, True, 0))),
                     (64, ((torch.bfloat16, False, 1), (torch.bfloat16, True, 0)))):
        offsets = [1, 2, n - 2, n - 1]
        own, bcast = chip_smoke.krum_inputs(n, FLAGSHIP_P, 1234 if n == 16 else 6464)
        for dtype, median, trim in cases:
            o, b = own.to(dtype), bcast.to(dtype)
            fn = lambda: C.candidate_select(o, b, offsets, trim=trim, median=median)  # noqa: E731
            ms = chip_smoke.time_ms(fn, args.reps)
            split = chip_smoke.device_split(fn, args.reps)
            label = (f"candidate_select ({str(dtype).replace('torch.', '')}, "
                     f"{'median' if median else f'trim {trim}'}, offsets {offsets})")
            print(json.dumps({"root": str(root), "n": n, "p": FLAGSHIP_P, "case": label, "ms": ms,
                              "device_ms": sum(split.values()) if split else None,
                              "device_split": split}), flush=True)
            del o, b
            torch.cuda.empty_cache()
        del own, bcast
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
