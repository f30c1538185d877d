#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (murmura_tpu_torch) on one card.

    python3 chip_smoke.py     # every phase, on one CUDA card

Phases, each of which raises (and exits non-zero) on failure:

1. card: name and power limit (``nvidia-smi``);
2. build: every kernel from ``murmura_tpu_torch/csrc`` with nvcc, in
   parallel, timed;
3. kernels against their plain PyTorch versions at the flagship's shapes
   ([16, 6,603,710] float32, the inputs the main path hands each kernel),
   each timed with CUDA events beside its plain version, a one-call PyTorch
   yardstick where one exists, and its memory/compute bound; plus Krum's
   selection on the same round inputs through the kernels and through the
   plain versions; then one round of the tiny CNN on the card against the
   same round on the CPU (same initial parameters, same injected draws);
4. main path, ``tpu.exchange: allgather``: ``examples/configs/
   femnist_krum_tpu.yaml`` as committed (baseline CNN at full width, 16
   nodes, bf16 compute), rounds cut to 3, through the port's ``run`` entry;
   the launch counters must show the pairwise kernel on every round and no
   plain-version call;
5. main path, ``tpu.exchange: ppermute``: the same for the circulant kernel;
6. output: one ``{"kernels": [...]}`` JSON line, the card line, and the
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
SMOKE_DIR = ROOT / "build" / "murmura_tpu_torch" / "smoke"
SMOKE_ROUNDS = 3
REPS = 20

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


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


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(results: dict) -> None:
    """Phase 3: each kernel against its plain version on the main path's
    inputs, its times, and Krum's selection through both."""
    import torch

    from murmura_tpu_torch.aggregation.base import AggContext
    from murmura_tpu_torch.aggregation.krum import make_krum
    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops import agg_kernels as K
    from murmura_tpu_torch.ops.flatten import model_dimension

    dev = torch.device("cuda")
    model = build_model("leaf.femnist.baseline", {})
    p = model_dimension(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    n = 16
    offsets = [1, 2, 14, 15]  # k-regular(4) on 16 nodes
    deltas = sorted({abs(b - a) for a in offsets for b in offsets if a != b})
    print(f"[kernels] shapes: N={n} P={p} offsets={offsets} deltas={deltas}", flush=True)

    # Nodes scattered around a common model with distinct spreads (so that
    # Krum's scores have no near-ties), three of them broadcasting noise.
    g = torch.Generator(device=dev).manual_seed(1234)
    spread = 0.01 * (1.0 + torch.arange(n, device=dev, dtype=torch.float32) / n)
    own = 0.05 * torch.randn((1, p), generator=g, device=dev) + spread[:, None] * torch.randn(
        (n, p), generator=g, device=dev
    )
    bcast = own.clone()
    bcast[:3] += 10.0 * torch.randn((3, p), generator=g, device=dev)  # 3 noisy rows
    # The pairwise kernel sees rows centered on the mean of its first
    # operand (aggregation/base.pairwise_l2_distances).
    ca = bcast - bcast.mean(dim=0, keepdim=True)
    co = own - bcast.mean(dim=0, keepdim=True)
    torch.cuda.synchronize()
    bytes_1 = n * p * 4  # one [16, P] float32 tensor

    cases = [
        ("pairwise_sq_distances", "(bcast, bcast)", (ca, None),
         lambda a, b: K.pairwise_sq_distances(a, b),
         lambda a, b: K.pairwise_sq_distances_plain(a, b),
         lambda a, b: torch.cdist(a, a if b is None else b,
                                  compute_mode="use_mm_for_euclid_dist") ** 2,
         bytes_1 + n * n * 4, 2.0 * n * n * p + 2.0 * n * p),
        ("pairwise_sq_distances", "(own, bcast)", (co, ca),
         lambda a, b: K.pairwise_sq_distances(a, b),
         lambda a, b: K.pairwise_sq_distances_plain(a, b),
         lambda a, b: torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist") ** 2,
         2 * bytes_1 + n * n * 4, 2.0 * n * n * p + 4.0 * n * p),
        ("circulant_sq_distances", f"(own, bcast, offsets {offsets})", (own, bcast),
         lambda a, b: K.circulant_sq_distances(a, b, offsets),
         lambda a, b: K.circulant_sq_distances_plain(a, b, offsets),
         None, 2 * bytes_1 + len(offsets) * n * 4, 3.0 * len(offsets) * n * p),
        ("circulant_sq_distances", f"(bcast, bcast, deltas {deltas})", (bcast, bcast),
         lambda a, b: K.circulant_sq_distances(a, b, deltas),
         lambda a, b: K.circulant_sq_distances_plain(a, b, deltas),
         None, bytes_1 + len(deltas) * n * 4, 3.0 * len(deltas) * n * p),
    ]
    for name, label, (a, b), kern, plain, library, nbytes, flops in cases:
        got = kern(a, b)
        torch.cuda.synchronize()
        ref = plain(a, b)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        if name == "pairwise_sq_distances":
            sa = (a * a).sum(-1)
            sb = sa if b is None else (b * b).sum(-1)
            limit = 1e-5 * (sa[:, None] + sb[None, :])
            rule = "|d2 - plain| <= 1e-5 (|a_i|^2 + |b_j|^2)"
        else:
            limit = 1e-5 * torch.clamp(ref.abs(), min=1.0)
            rule = "|d2 - plain| <= 1e-5 max(1, |plain|)"
        max_err = float(err.max())
        ok = bool((err <= limit).all()) and bool(torch.isfinite(got).all())
        print(f"[kernels] {name} {label}: max |d2 - plain| = {max_err:.6g}, "
              f"limit {rule} (max limit {float(limit.max()):.6g}): "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        ms = time_ms(lambda: kern(a, b))
        plain_ms = time_ms(lambda: plain(a, b))
        lib_ms = time_ms(lambda: library(a, b)) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"[kernels] {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)
        results.setdefault(name, []).append({
            "case": label, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        })

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
    del own, bcast, ca, co
    torch.cuda.empty_cache()


def check_round_against_cpu(device: str = "cuda") -> None:
    """Phase 3b: one round of the tiny CNN (16 nodes, k-regular(4), float32
    compute, 20% gaussian, Krum c=1) on the card and on the CPU, from the
    same initial parameters and the same injected draws (shuffle and
    noise).  The card runs the kernels, the CPU their plain versions; the
    post-round parameters must agree to a scaled delta of 1e-4 and Krum's
    selection must be equal."""
    import numpy as np
    import torch

    from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack
    from murmura_tpu_torch.aggregation.krum import make_krum
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.models.cnn import make_femnist_cnn
    from murmura_tpu_torch.ops.flatten import tree_map
    from murmura_tpu_torch.topology.generators import create_topology

    n, seed, offsets = 16, 7, [1, 2, 14, 15]
    data = build_federated_data("leaf.femnist", {"num_samples": 640}, num_nodes=n, seed=seed)
    model = make_femnist_cnn(variant="tiny")
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
    adj = create_topology("k-regular", n, k=4).mask()
    u = rng.random(data.mask.shape).astype(np.float32)
    for circ in (False, True):
        kw = {"num_compromised": 1, "max_candidates": len(offsets) + 1}
        if circ:
            kw["exchange_offsets"] = offsets
        out = {}
        for dev in (device, "cpu"):
            attack = make_gaussian_attack(n, 0.2, noise_std=10.0, seed=seed)
            prog = build_round_program(
                model, make_krum(**kw), data, attack=attack, local_epochs=1,
                batch_size=16, lr=0.05, seed=seed, device=dev, init_params=init,
            )
            noise = np.random.default_rng(seed + 1).normal(
                size=(int(attack.compromised.sum()), prog.model_dim)).astype(np.float32)
            comp = torch.as_tensor(attack.compromised.astype(np.float32)).to(dev)
            flat, _, metrics = prog.train_step(
                prog.init_flat, {}, torch.as_tensor(adj).to(dev), comp, 0.0,
                draws={"u": [u], "noise": noise},
            )
            out[dev] = (flat.cpu().double(), metrics["agg_selected_index"].cpu())
        (f_card, s_card), (f_cpu, s_cpu) = out[device], out["cpu"]
        delta = float((f_card - f_cpu).abs().max() / max(1.0, float(f_cpu.abs().max())))
        ok = torch.equal(s_card, s_cpu) and delta <= 1e-4
        print(f"[round] {'circulant' if circ else 'dense'} Krum, tiny CNN, card vs CPU: "
              f"scaled param delta {delta:.3g} (limit 1e-4), selected_index "
              f"{s_card.tolist()} {'==' if torch.equal(s_card, s_cpu) else '!='} CPU: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError("a round on the card disagrees with the CPU round")


def run_main_path(exchange: str) -> dict:
    """Phases 4/5: the flagship through ``murmura_tpu_torch.cli.run``."""
    import numpy as np
    import torch
    import yaml

    from murmura_tpu_torch import cli
    from murmura_tpu_torch.core.network import empty_history
    from murmura_tpu_torch.ops import agg_kernels as K

    raw = yaml.safe_load(FLAGSHIP.read_text())
    raw["experiment"]["rounds"] = SMOKE_ROUNDS
    raw["tpu"]["exchange"] = exchange
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    cfg = SMOKE_DIR / f"femnist_krum_{exchange}.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out = SMOKE_DIR / f"history_{exchange}.json"

    K.reset_counts()
    t0 = time.perf_counter()
    history, network = cli.run(cfg, output=out, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    plain = dict(K.PLAIN_CALLS)

    kernel = "pairwise_sq_distances" if exchange == "allgather" else "circulant_sq_distances"
    print(f"[main:{exchange}] launches {launches}, plain-version calls {plain}", flush=True)
    if launches[kernel] < 2 * SMOKE_ROUNDS:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times in "
                             f"{SMOKE_ROUNDS} rounds (want >= 2 per round)")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card path: {plain}")
    hist = json.loads(out.read_text())
    want = {k for k in empty_history()} | {"agg_selected_index", "agg_krum_score",
                                           "agg_selected_own"}
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
    print(f"[main:{exchange}] P={network.program.model_dim} round seconds "
          f"{[round(t, 4) for t in rt]}; steady s/round {np.mean(rt[1:]):.4f}; "
          f"run wall {wall:.2f} s; final mean accuracy "
          f"{hist['mean_accuracy'][-1]:.4f}", flush=True)
    return {"kernel": kernel, "launches": launches[kernel], "s_per_round": rt}


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
        print(f"[build] {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage), flush=True)

    results: dict = {}
    check_kernels(results)
    check_round_against_cpu()

    mains = {ex: run_main_path(ex) for ex in ("allgather", "ppermute")}
    launches = {m["kernel"]: m["launches"] for m in mains.values()}
    replaces = {
        "pairwise_sq_distances": "murmura_tpu/ops/pallas_agg.py:319",
        "circulant_sq_distances": "murmura_tpu/ops/pallas_agg.py:225",
    }
    # One entry per kernel; its times are those of the two calls a round
    # makes (summed), with each call's own numbers under "cases".
    kernels = []
    for name, rows in results.items():
        libs = [r["library_ms"] for r in rows]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "murmura_tpu_torch/csrc/agg_distances.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
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
