#!/usr/bin/env python3
"""Time the port's two distance kernels, ``pairwise_l2_distances`` around
the pairwise one, and the count sketch, on one CUDA card, for the
``murmura_tpu_torch`` package found under ``--root`` (default: this
checkout).

    python3 bench_torch_distances.py [--root DIR] [--reps 20]

Inputs are built as chip_smoke.py builds them, at two shapes: the
flagship's [16, 6,603,710] float32 (P of leaf.femnist.baseline) and
[64, 1,048,576], with k-regular(4) offsets.  Cases at each: pairwise
(bcast, bcast) and (own, bcast), circulant (own, bcast, offsets) and
(bcast, bcast, deltas), ``pairwise_l2_distances(bcast)`` and
``(own, bcast)``, which include the centering, and ``count_sketch`` of own
and of bcast with Sketchguard's tables (S = 1000, seed 42, built once per
shape by the package under test).  A package whose pairwise wrapper takes
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


def sketch_variants(reps: int) -> int:
    """Build SKETCH_VARIANTS from csrc/count_sketch.cu, time them in turns."""
    import ctypes
    import math
    import subprocess

    import torch

    import chip_smoke
    from murmura_tpu_torch.ops import _build
    from murmura_tpu_torch.ops import sketch_kernels as SK
    from murmura_tpu_torch.ops.sketch import make_sketch_tables

    src = (_build.CSRC / "count_sketch.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, subs, *_rest) in enumerate(SKETCH_VARIANTS):
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {label!r}: its source text is gone from count_sketch.cu")
            text = text.replace(old, new)
        (out_dir / f"v{i}.cu").write_text(text)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"v{i}.so"),
             str(out_dir / f"v{i}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, proc in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {SKETCH_VARIANTS[i][0]!r} does not build:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"v{i}.so"))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
