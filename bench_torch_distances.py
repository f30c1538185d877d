#!/usr/bin/env python3
"""Time the port's two distance kernels, and ``pairwise_l2_distances``
around the pairwise one, on one CUDA card, for the ``murmura_tpu_torch``
package found under ``--root`` (default: this checkout).

    python3 bench_torch_distances.py [--root DIR] [--reps 20]

Inputs are built as chip_smoke.py builds them, at two shapes: the
flagship's [16, 6,603,710] float32 (P of leaf.femnist.baseline) and
[64, 1,048,576], with k-regular(4) offsets.  Cases at each: pairwise
(bcast, bcast) and (own, bcast), circulant (own, bcast, offsets) and
(bcast, bcast, deltas), and ``pairwise_l2_distances(bcast)`` and
``(own, bcast)``, which include the centering.  A package whose pairwise
wrapper takes no center gets its rows centered before the timed kernel
calls.  To compare two trees, unpack the other one into a directory that
.gitignore lists, pass it as ``--root`` and run the two in turns (A, B, B,
A) in one call on one card.  Prints the card line, then one JSON line per
case: CUDA-event ms and profiler device ms per call.
"""

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FLAGSHIP_P = 6_603_710


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="directory holding murmura_tpu_torch/")
    ap.add_argument("--reps", type=int, default=20)
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

    sys.path.insert(0, str(root))
    from murmura_tpu_torch.aggregation.base import pairwise_l2_distances
    from murmura_tpu_torch.ops import agg_kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    fused = "center" in inspect.signature(K.pairwise_sq_distances).parameters
    for n, p, seed in ((16, FLAGSHIP_P, 1234), (64, 1 << 20, 4321)):
        own, bcast = chip_smoke.krum_inputs(n, p, seed)
        offsets = [1, 2, n - 2, n - 1]
        deltas = sorted({abs(b - a) for a in offsets for b in offsets if a != b})
        cb, co = bcast.mean(dim=0), own.mean(dim=0)
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
        ]
        for label, fn in cases:
            ms = chip_smoke.time_ms(fn, args.reps)
            dev_ms = chip_smoke.device_ms(fn, args.reps)
            print(json.dumps({"root": str(root), "n": n, "p": p, "case": label,
                              "ms": ms, "device_ms": dev_ms}), flush=True)
        del own, bcast, cb, co
        if not fused:
            del bb, ob, bo
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
