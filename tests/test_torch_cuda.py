"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py pins JAX to the CPU.)  Beside the
kernels: the CLI runs launch them (a pipelined Krum round too, from its
warm-up round on; a sparse Krum run twice a round; a gang once a member;
a population run twice a round; an adaptive Krum round, card against CPU,
in both exchanges; a gang's stage reset; a serve bucket's warm admission
and a one-bucket grid), and ``tpu.transfer_guard`` raises on a
synchronising call forced inside a fused chunk and not across a
population run's swaps.  The population engine's swap on the card (pinned
prefetch buffers, the teleport composition, the write-back) and the DMTT
trust update, card against CPU, have their tests too, as do the
char-LSTM's and the CelebA CNN's forward and backward at their published
widths (both ``conv_impl``s), ``im2col`` against ``direct``, and one DMTT
gang round under mobility, each card against CPU within a scaled 1e-4
(``im2col`` against ``direct`` 1e-5 in float32, 2e-2 in bfloat16).
Tolerances are chip_smoke.py's: |d2 - plain| <= 1e-5 (|a_i|^2 + |b_j|^2)
for the pairwise kernel (norms of the centered rows when it takes a
center), whose Gram identity cancels in float32;
|d2 - plain| <= 1e-5 max(1, |plain|) for the circulant kernel's direct sums;
bit-equal for candidate selection (no reduction across threads, the same
sum order and reciprocal as the plain version); and for the count sketch
|Δ out[s]| <= 1e-4 Σ_{p: hash=s} |v_p|, float32 reordering over a bucket.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from murmura_tpu_torch.aggregation.base import AggContext, pairwise_l2_distances
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.ops import agg_kernels as K
from murmura_tpu_torch.ops import candidate_kernels as C
from murmura_tpu_torch.ops import sketch_kernels as SK
from murmura_tpu_torch.ops.sketch import build_sketch_tables

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(seed, n, p, dev):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=(n, p)).astype(np.float32)).to(dev)


def _pairwise_ok(got, ref, a, b):
    sa = (a * a).sum(-1)
    sb = sa if b is None else (b * b).sum(-1)
    return bool(torch.all((got - ref).abs() <= 1e-5 * (sa[:, None] + sb[None, :]) + 1e-6))


@pytest.mark.parametrize(
    "n,p,m",
    [(16, 100_003, 16), (5, 1, 5), (33, 4099, 20), (1, 300, 17), (16, 128, 16),
     (256, 20_011, 256)],
)
def test_pairwise_kernel_matches_plain(dev, n, p, m):
    a, b = _rows(p, n, p, dev), _rows(p + 1, m, p, dev)
    for bb in (None, b):
        before = K.LAUNCHES["pairwise_sq_distances"]
        got = K.pairwise_sq_distances(a, bb)
        torch.cuda.synchronize()
        assert K.LAUNCHES["pairwise_sq_distances"] == before + 1
        assert got.shape == (n, n if bb is None else m)
        assert _pairwise_ok(got, K.pairwise_sq_distances_plain(a, bb), a, bb)


@pytest.mark.parametrize(
    "n,p,offsets",
    [(16, 100_003, [1, 2, 14, 15]), (16, 5000, [1, 12, 13, 14]), (3, 1, [1, 2]),
     (70, 5000, [1, 35, 69]), (40, 777, list(range(1, 40)))],
)
def test_circulant_kernel_matches_plain(dev, n, p, offsets):
    own, b = _rows(p, n, p, dev), _rows(p + 1, n, p, dev)
    for o in (own, b):
        before = K.LAUNCHES["circulant_sq_distances"]
        got = K.circulant_sq_distances(o, b, offsets)
        torch.cuda.synchronize()
        assert K.LAUNCHES["circulant_sq_distances"] == before + 1
        ref = K.circulant_sq_distances_plain(o, b, offsets)
        assert got.shape == (len(offsets), n)
        assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))


@pytest.mark.parametrize(
    "n,p,m", [(16, 100_003, 16), (33, 4099, 20), (1, 300, 17), (256, 20_000, 256)]
)
def test_pairwise_kernel_with_center_matches_plain(dev, n, p, m):
    # Rows far from the origin: the kernel subtracts the center as it loads.
    a, b = _rows(p, n, p, dev) + 5.0, _rows(p + 1, m, p, dev) + 5.0
    c = a.mean(dim=0)
    for bb in (None, b):
        got = K.pairwise_sq_distances(a, bb, center=c)
        torch.cuda.synchronize()
        ref = K.pairwise_sq_distances_plain(a, bb, center=c)
        assert got.shape == (n, n if bb is None else m)
        assert _pairwise_ok(got, ref, a - c, None if bb is None else bb - c)


def _unaligned(x):
    """x's values in a tensor whose storage starts one float later (4 bytes
    off an 8-byte boundary)."""
    flat = torch.empty(x.numel() + 1, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


@pytest.mark.parametrize("p", [100_001, 100_002, 100_003, 100_004])  # P = 1, 2, 3, 0 mod 4
def test_distance_kernels_at_every_alignment(dev, p):
    # Odd rows start 4 (odd P) or 8 (P = 2 mod 4) bytes off a 16-byte line.
    n, offs = 5, [1, 2, 3, 4]
    a, b = _rows(p, n, p, dev) + 1.0, _rows(p + 1, n, p, dev) + 1.0
    c = a.mean(dim=0)
    for x, y, cc in ((a, b, c), (_unaligned(a), _unaligned(b), _unaligned(c))):
        for bb in (None, y):
            for center in (None, cc):
                got = K.pairwise_sq_distances(x, bb, center=center)
                ref = K.pairwise_sq_distances_plain(x, bb, center=center)
                xc = x if center is None else x - center
                bc = None if bb is None else (bb if center is None else bb - center)
                assert _pairwise_ok(got, ref, xc, bc), (p, bb is None, center is None)
        for o in (x, y):
            got = K.circulant_sq_distances(o, y, offs)
            ref = K.circulant_sq_distances_plain(o, y, offs)
            assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))


@pytest.mark.parametrize("n,same", [(2500, False), (5000, True), (1000, False), (600, True)])
def test_circulant_kernel_beyond_the_row_cap(dev, n, same):
    # Past the rows shared memory holds (2,421 for two tensors, 4,842 for
    # one, 8-byte copies), and wherever the plan's tiles would be narrower
    # than 16 columns (past 260 rows for two tensors, 521 for one), the
    # wrapper splits the call into launches of at most circulant_split_rows
    # rows.
    p, offsets = 300, [1, 2, n - 2, n - 1]
    b = _rows(p + 1, n, p, dev)
    own = b if same else _rows(p, n, p, dev)
    vec = K._vec(p, own, b)
    assert K.circulant_needs_split(n, same, vec)
    before = K.LAUNCHES["circulant_sq_distances"]
    got = K.circulant_sq_distances(own, b, offsets)
    torch.cuda.synchronize()
    rows = K.circulant_split_rows(vec)
    assert K.LAUNCHES["circulant_sq_distances"] - before == len(K.circulant_split(n, offsets, rows))
    ref = K.circulant_sq_distances_plain(own, b, offsets)
    assert got.shape == (len(offsets), n)
    assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))
    assert torch.equal(got, K.circulant_sq_distances(own, b, offsets))
    if n <= (2 * K.circulant_row_cap(vec) if same else K.circulant_row_cap(vec)):
        one = K.circulant_launch(own, b, offsets)  # one launch still fits: within the limit
        assert bool(torch.all((one - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))


def test_kernels_are_deterministic(dev):
    a, b = _rows(0, 16, 200_000, dev), _rows(1, 16, 200_000, dev)
    c = a.mean(dim=0)
    assert torch.equal(K.pairwise_sq_distances(a, b), K.pairwise_sq_distances(a, b))
    for bb in (None, b):
        assert torch.equal(K.pairwise_sq_distances(a, bb, center=c),
                           K.pairwise_sq_distances(a, bb, center=c))
    offs = [1, 2, 14, 15]
    for o in (a, b):
        assert torch.equal(K.circulant_sq_distances(o, b, offs),
                           K.circulant_sq_distances(o, b, offs))


@pytest.mark.parametrize("same", [True, False])
def test_l2_distances_make_no_centered_copy(dev, same):
    n, p = 16, 4_000_000
    a, b = _rows(0, n, p, dev), _rows(1, n, p, dev)
    args = (a,) if same else (a, b)
    pairwise_l2_distances(*args)  # builds the kernel and caches its plan
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d = pairwise_l2_distances(*args)
    torch.cuda.synchronize()
    # A centered copy of a or b would add a whole [16, P] float32 tensor.
    assert torch.cuda.max_memory_allocated() - before < 0.5 * n * p * 4
    assert d.shape == (n, n) and bool(torch.isfinite(d).all())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = _rows(0, 4, 64, dev)
    with pytest.raises(TypeError, match="float32"):
        K.pairwise_sq_distances(a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K.pairwise_sq_distances(a.t().contiguous().t())
    with pytest.raises(ValueError, match="offsets"):
        K.circulant_sq_distances(a, a, list(range(K.MAX_OFFSETS + 1)))
    with pytest.raises(ValueError, match="different devices"):
        K.circulant_sq_distances(a, a.cpu(), [1])
    with pytest.raises(ValueError, match="center"):
        K.pairwise_sq_distances(a, center=a[0, :60].contiguous())
    with pytest.raises(ValueError, match="center"):
        K.pairwise_sq_distances(a, center=a[:, 0])  # not contiguous
    with pytest.raises(TypeError, match="float32"):
        K.pairwise_sq_distances(a, center=a[0].to(torch.bfloat16))


@pytest.mark.parametrize("circulant", [False, True])
def test_krum_selection_kernel_equals_plain(dev, circulant):
    n, p, offsets = 16, 50_000, [1, 2, 14, 15]
    g = np.random.default_rng(5)
    spread = (0.01 * (1.0 + np.arange(n) / n))[:, None]
    own = (0.05 * g.normal(size=(1, p)) + spread * g.normal(size=(n, p))).astype(np.float32)
    bcast = own.copy()
    bcast[:3] += 10.0 * g.normal(size=(3, p)).astype(np.float32)
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
    kw = {"num_compromised": 1, "max_candidates": len(offsets) + 1}
    if circulant:
        kw["exchange_offsets"] = offsets
    agg = make_krum(**kw)
    t = [torch.from_numpy(x) for x in (own, bcast, adj)]
    _, _, on_card = agg.aggregate(*(x.to(dev) for x in t), 0.0, {}, AggContext())
    _, _, on_cpu = agg.aggregate(*t, 0.0, {}, AggContext())
    assert torch.equal(on_card["selected_index"].cpu(), on_cpu["selected_index"])
    assert not bool(on_cpu["selected_own"].all())


def _offsets(n, k):
    """k offsets in 1..n-1, repeating once k reaches n."""
    return [1 + j % (n - 1) for j in range(k)]


# P = 1, 3, 3, 1, 2, 0, 1, 0, 1 mod 4 (16-, 8- and 4-byte copies; bfloat16
# rows on 4 bytes at P = 2 mod 4 and on 2 bytes, the direct path, at odd P);
# (7, 64) and (1300, 257) give fewer column tiles than blocks; N = 300 is
# the staged path at one block an SM, N = 1,300 the direct path; m = 17
# the generic sort.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 5, 9, 17])
@pytest.mark.parametrize(
    "n,p",
    [(5, 1001), (16, 100_003), (33, 4099), (1300, 257), (16, 100_002), (16, 100_004),
     (16, 100_001), (7, 64), (300, 4097)],
)
def test_candidate_kernel_equals_plain(dev, n, p, m, dtype):
    own, b = (x.to(dtype) for x in (_rows(p, n, p, dev), _rows(p + 1, n, p, dev)))
    offsets = _offsets(n, m - 1)
    for median, trim in ((True, 0), (False, 0), (False, (m - 1) // 2)):
        before = C.LAUNCHES["candidate_select"]
        got = C.candidate_select(own, b, offsets, trim=trim, median=median)
        torch.cuda.synchronize()
        assert C.LAUNCHES["candidate_select"] == before + 1
        assert got.dtype == dtype and got.shape == (n, p)
        ref = C.candidate_select_plain(own, b, offsets, trim=trim, median=median)
        assert torch.equal(got, ref), (median, trim)
        again = C.candidate_select(own, b, offsets, trim=trim, median=median)
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_candidate_kernel_on_rows_one_element_off(dev, dtype):
    # 4-byte copies (float32) or the direct path (bfloat16 on 2 bytes).
    n, p = 16, 100_002
    flat = torch.empty(n * p + 1, dtype=dtype, device=dev)
    flat[1:] = _rows(0, n, p, dev).to(dtype).reshape(-1)
    own, b = flat[1:].view(n, p), _rows(1, n, p, dev).to(dtype)
    for median, trim in ((True, 0), (False, 1)):
        got = C.candidate_select(own, b, [1, 2, 14, 15], trim=trim, median=median)
        ref = C.candidate_select_plain(own, b, [1, 2, 14, 15], trim=trim, median=median)
        assert torch.equal(got, ref)


# bfloat16 is sorted in bf16x2 pairs: NaN and +-inf fall in both halves of a
# pair (every 3rd, 5th, 7th, 11th column), on rows that start on 16 bytes
# (P = 5,000) and on 4 (P = 5,002 = 2 mod 4); m = 3 and 5 are the static
# networks, m = 9 the generic sort.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [5000, 5002])
@pytest.mark.parametrize("offsets", [[1, 15], [1, 2, 14, 15], list(range(1, 9))])
def test_candidate_kernel_sorts_nan_and_inf_as_plain(dev, dtype, p, offsets):
    own, b = _rows(0, 16, p, dev), _rows(1, 16, p, dev)
    own[3, ::7] = float("nan")
    b[5, ::5] = float("inf")
    b[9, ::3] = -float("inf")
    b[2, ::11] = float("nan")
    own, b = own.to(dtype), b.to(dtype)
    for median, trim in ((True, 0), (False, 1)):
        got = C.candidate_select(own, b, offsets, trim=trim, median=median)
        ref = C.candidate_select_plain(own, b, offsets, trim=trim, median=median)
        assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(ref, nan=7.0))
        assert torch.equal(torch.isnan(got), torch.isnan(ref))


def _check_count_sketch(v, tables):
    """The kernel against the plain version within the limit, one launch
    a call, and bit-equal on a repeat call."""
    rows, s = v.shape[0], tables.sketch_size
    before = SK.LAUNCHES["count_sketch"]
    got = SK.count_sketch(v, tables)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["count_sketch"] == before + 1
    ref = SK.count_sketch_plain(v, tables)
    h = tables.plain_on(v.device)["hash"]
    scale = torch.zeros((rows, s), device=v.device).index_add_(1, h, v.abs())
    assert got.shape == (rows, s)
    assert bool(torch.all((got - ref).abs() <= 1e-4 * scale))
    assert torch.equal(got, SK.count_sketch(v, tables))  # the same from run to run
    assert SK.LAUNCHES["count_sketch"] == before + 2


# P = 0, 1, 2, 3 mod 4 (8- and 4-byte copies, tail slices); R = 1, 5, 16, 33
# (33 leaves a row group of one row); S = 7, 1000, 4096 (1, 2 and 8 buckets
# a thread) and 5000 (two bucket chunks); P = 20,011 and 16,384 give fewer
# slices than blocks.
@pytest.mark.parametrize(
    "rows,p,s",
    [(16, 100_003, 1000), (5, 40_000, 7), (33, 20_011, 4096), (1, 16_384, 1000),
     (16, 100_004, 1000), (16, 100_001, 7), (16, 100_002, 4096), (1, 100_002, 7),
     (5, 100_001, 4096), (33, 100_000, 1000), (16, 20_011, 1000), (16, 1_000_002, 1000),
     (5, 30_000, 5000), (1, 1, 3)],
)
def test_count_sketch_kernel_matches_plain(dev, rows, p, s):
    _check_count_sketch(_rows(p + s, rows, p, dev), build_sketch_tables(p, s, 42))


@pytest.mark.parametrize("p", [100_001, 100_003])
def test_count_sketch_kernel_on_rows_one_float_off(dev, p):
    # The rows v[1:] of an odd-P tensor: contiguous, 4-byte aligned only.
    v = _rows(p, 6, p, dev)[1:]
    assert v.is_contiguous() and v.data_ptr() % 8 == 4
    _check_count_sketch(v, build_sketch_tables(p, 1000, 42))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = _rows(0, 8, 64, dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        C.candidate_select(a.to(torch.float16), a.to(torch.float16), [1], median=True)
    with pytest.raises(TypeError, match="one dtype"):
        C.candidate_select(a, a.to(torch.bfloat16), [1], median=True)
    with pytest.raises(ValueError, match="contiguous"):
        C.candidate_select(a, a.t().contiguous().t(), [1], median=True)
    with pytest.raises(ValueError, match="different devices"):
        C.candidate_select(a, a.cpu(), [1], median=True)
    with pytest.raises(ValueError, match="leaves no candidate"):
        C.candidate_select(a, a, [1, 2], trim=2)
    tables = build_sketch_tables(64, 5, 0)
    with pytest.raises(TypeError, match="float32"):
        SK.count_sketch(a.to(torch.bfloat16), tables)
    with pytest.raises(ValueError, match="expected \\[rows, 64\\]"):
        SK.count_sketch(a[:, :60].contiguous(), tables)
    with pytest.raises(ValueError, match="contiguous"):
        SK.count_sketch(_rows(1, 64, 8, dev).t(), tables)


@pytest.mark.parametrize("exchange", ["allgather", "ppermute"])
def test_cli_run_goes_through_the_kernel(dev, tmp_path, exchange):
    from murmura_tpu_torch import cli

    cfg = {
        "experiment": {"name": "cuda-tiny", "seed": 7, "rounds": 2, "verbose": False},
        "topology": {"type": "k-regular", "num_nodes": 16, "k": 4},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2,
                   "params": {"noise_std": 10.0}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.02},
        "data": {"adapter": "leaf.femnist", "params": {"num_samples": 640}},
        "model": {"factory": "leaf.femnist.tiny", "params": {}},
        "backend": "tpu",
        "tpu": {"exchange": exchange, "compute_dtype": "bfloat16"},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    K.reset_counts()
    history, _ = cli.run(path, output=tmp_path / "h.json", device="cuda")
    kernel = "pairwise_sq_distances" if exchange == "allgather" else "circulant_sq_distances"
    assert K.LAUNCHES[kernel] == 4  # two per round
    assert not any(K.PLAIN_CALLS.values())
    assert json.loads((tmp_path / "h.json").read_text()) == history
    assert all(np.isfinite(history["mean_accuracy"]))


@pytest.mark.parametrize(
    "algorithm,exchange,kernel,per_round",
    [("median", "ppermute", "candidate_select", 1),
     ("trimmed_mean", "ppermute", "candidate_select", 1),
     ("sketchguard", "allgather", "count_sketch", 2),
     ("sketchguard", "ppermute", "count_sketch", 2)],
)
def test_cli_run_of_the_new_rules_goes_through_their_kernels(
    dev, tmp_path, algorithm, exchange, kernel, per_round
):
    from murmura_tpu_torch import cli

    cfg = {
        "experiment": {"name": "cuda-tiny", "seed": 7, "rounds": 2, "verbose": False},
        "topology": {"type": "k-regular", "num_nodes": 16, "k": 4},
        "aggregation": {"algorithm": algorithm, "params": {}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2,
                   "params": {"noise_std": 10.0}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.02},
        "data": {"adapter": "leaf.femnist", "params": {"num_samples": 640}},
        "model": {"factory": "leaf.femnist.tiny", "params": {}},
        "backend": "tpu",
        "tpu": {"exchange": exchange, "compute_dtype": "bfloat16"},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    mods = (K, C, SK)
    for mod in mods:
        mod.reset_counts()
    history, _ = cli.run(path, output=tmp_path / "h.json", device="cuda")
    launches = {**K.LAUNCHES, **C.LAUNCHES, **SK.LAUNCHES}
    assert launches[kernel] == 2 * per_round
    if algorithm == "sketchguard":
        assert launches["pairwise_sq_distances"] == 2  # the sketch-space filter
    assert not any(v for mod in mods for v in mod.PLAIN_CALLS.values())
    assert all(np.isfinite(history["mean_accuracy"]))


@pytest.mark.parametrize("circulant", [False, True])
def test_ubar_decisions_on_the_card_equal_the_cpu(dev, circulant):
    # A tiny UBAR call (the plain MLP, 12 nodes, k-regular(4), two std-10
    # broadcasts, rho 0.8): stage 1 through the distance kernel on the
    # card, its plain version on the CPU; equal acceptances, the probe
    # losses and the output within float32 rounding.
    from murmura_tpu_torch.aggregation.ubar import make_ubar
    from murmura_tpu_torch.models.mlp import make_mlp
    from murmura_tpu_torch.ops.flatten import make_flatteners

    n, offsets = 12, [1, 2, 10, 11]
    model = make_mlp(20, (32, 16), 5)
    template = model.init(torch.Generator().manual_seed(0), "cpu")
    ravel, unravel, p = make_flatteners(template)
    g = np.random.default_rng(0)
    spread = 0.05 * (1.0 + np.arange(n) / n)
    own = (ravel(template).numpy()[None] + spread[:, None] * g.normal(size=(n, p)))
    own = own.astype(np.float32)
    bcast = own.copy()
    bcast[[2, 7]] += (10.0 * g.normal(size=(2, p))).astype(np.float32)
    probe = (g.normal(size=(n, 10, 20)).astype(np.float32), g.integers(0, 5, size=(n, 10)),
             (g.random((n, 10)) < 0.9).astype(np.float32))
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
    kw = {"rho": 0.8, "exchange_offsets": offsets} if circulant else {"rho": 0.8}
    rule = make_ubar(**kw)
    out = {}
    for d in (dev, torch.device("cpu")):
        px, py, pm = (torch.as_tensor(a).to(d) for a in probe)
        ctx = AggContext(apply_fn=model.apply, unravel=unravel, probe_x=px,
                         probe_y=py.long(), probe_mask=pm, num_classes=5)
        K.reset_counts()
        new, _, stats = rule.aggregate(torch.from_numpy(own).to(d), torch.from_numpy(bcast).to(d),
                                       torch.from_numpy(adj).to(d), 0.0, {}, ctx)
        out[d.type] = (new.cpu(), {k: v.cpu() for k, v in stats.items()}, dict(K.LAUNCHES),
                       dict(K.PLAIN_CALLS))
    kernel = "circulant_sq_distances" if circulant else "pairwise_sq_distances"
    (new_c, st_c, launches, plain), (new_p, st_p, _, _) = out["cuda"], out["cpu"]
    assert launches[kernel] == 1 and not any(plain.values())
    for k in ("stage1_acceptance_rate", "stage2_acceptance_rate"):
        assert torch.equal(st_c[k], st_p[k]), k
    assert float(st_c["stage2_acceptance_rate"].min()) < 1.0
    torch.testing.assert_close(st_c["own_loss"], st_p["own_loss"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new_c, new_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "name,exchange,kernel,per_round",
    [("uci_har_evidential_trust", None, None, 0),
     ("alie_geometric_median", None, "pairwise_sq_distances", 9),
     ("label_flip_poisoning", None, None, 0),
     # m = 10 candidates on the fully-connected 10-node graph: the generic path.
     ("label_flip_poisoning", "ppermute", "candidate_select", 1)],
)
def test_cli_run_of_the_lever_free_configs(dev, tmp_path, name, exchange, kernel, per_round):
    # As committed but for fewer synthetic samples and two rounds.
    from pathlib import Path

    from murmura_tpu_torch import cli

    root = Path(__file__).resolve().parents[1]
    raw = yaml.safe_load((root / "examples" / "configs" / f"{name}.yaml").read_text())
    raw["experiment"].update(rounds=2, verbose=False)
    raw["data"]["params"]["num_samples"] = 400
    if exchange is not None:
        raw["backend"] = "tpu"
        raw["tpu"] = {"exchange": exchange}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    mods = (K, C, SK)
    for mod in mods:
        mod.reset_counts()
    history, network = cli.run(path, output=tmp_path / "h.json", device="cuda")
    launches = {**K.LAUNCHES, **C.LAUNCHES, **SK.LAUNCHES}
    assert launches == {k: (2 * per_round if k == kernel else 0) for k in launches}
    assert not any(v for mod in mods for v in mod.PLAIN_CALLS.values())
    assert all(np.isfinite(v).all() for v in history.values())
    assert bool(torch.isfinite(network.flat).all())


# The compressed exchange's codec: plain tensor code, held bit-equal between
# the card and the CPU on the same inputs (a code that moved would move its
# element by a whole scale step).

def _codec_rows(seed, n, p, dtype):
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, p)) * g.uniform(1e-3, 1e2, size=(n, 1))
    x[1, : p // 3] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,block", [(1_000_003, 256), (4096, 256), (77, 64)])
def test_int8_codec_card_equals_cpu(dev, dtype, p, block):
    from murmura_tpu_torch.ops.compress import quantize_int8

    x = _codec_rows(p, 8, p, dtype)
    cpu, card = quantize_int8(x, block), quantize_int8(x.to(dev), block)
    assert torch.equal(card.q.cpu(), cpu.q) and torch.equal(card.scale.cpu(), cpu.scale)
    assert torch.equal(card.dequantize_f32().cpu(), cpu.dequantize_f32())


def test_topk_card_equals_cpu_with_ties(dev):
    from murmura_tpu_torch.ops.compress import topk_mask

    g = np.random.default_rng(3)
    p, k = 200_003, 10_000
    x = g.normal(size=(6, p)).astype(np.float32)
    for i in range(5):
        kth = np.sort(np.abs(x[i]))[::-1][k - 1]
        pos = g.choice(p, size=3 * k // 2, replace=False)
        x[i, pos] = np.where(g.random(len(pos)) < 0.5, kth, -kth)
    x[5] = 0.25
    t = torch.from_numpy(x)
    mask = topk_mask(t.abs(), k)
    assert (mask.sum(dim=1) == k).all()
    assert torch.equal(topk_mask(t.abs().to(dev), k).cpu(), mask)


@pytest.mark.parametrize("algorithm", ["int8", "topk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_exchange_card_equals_cpu(dev, algorithm, dtype):
    from murmura_tpu_torch.ops.compress import (
        CompressionSpec, compress_exchange, init_compress_state)

    spec = CompressionSpec(algorithm, block=256, topk_ratio=0.05, error_feedback=True)
    init = _codec_rows(5, 8, 300_007, dtype)
    states = {"cpu": init_compress_state(spec, init),
              "card": init_compress_state(spec, init.to(dev))}
    g = np.random.default_rng(9)
    for r in range(3):
        x = (init.float() + torch.from_numpy(
            (0.1 * (r + 1) * g.normal(size=tuple(init.shape))).astype(np.float32))).to(dtype)
        out = {}
        for where, t in (("cpu", x), ("card", x.to(dev))):
            ex, dec, up, stats = compress_exchange(spec, t, states[where], True)
            states[where] = {**states[where], **up}
            out[where] = (ex, dec, up, stats)
        for a, b in zip(out["card"][:2], out["cpu"][:2]):
            assert torch.equal(a.cpu(), b)
        for key in out["cpu"][2]:
            assert torch.equal(out["card"][2][key].cpu(), out["cpu"][2][key]), (r, key)
        for key in out["cpu"][3]:
            torch.testing.assert_close(out["card"][3][key].cpu(), out["cpu"][3][key],
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("discount", [0.7, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stale_fold_card_equals_cpu(dev, discount, dtype):
    """Three chained folds on k-regular(4) at N = 16, P = 300,007: stragglers
    with warm and cold caches, a scrubbed sender, a dead receiver.  The
    served rows, the cache, the ages, the re-added edges and the stats
    bit-equal; the weights discount ** age within rtol 1e-6 (each device's
    float32 exp)."""
    from murmura_tpu_torch.core.stale import (
        AGE_KEY, CACHE_KEY, StalenessSpec, init_stale_state, make_stale_fold)
    from murmura_tpu_torch.topology.generators import create_topology

    n, p = 16, 300_007
    base = create_topology("k-regular", n, k=4).mask()
    spec = StalenessSpec(2, discount, base_mask=base)
    folds = {"cpu": make_stale_fold(spec, audit=True),
             "card": make_stale_fold(spec, audit=True, device=dev)}
    states = {"cpu": init_stale_state(spec, n, p, dtype),
              "card": init_stale_state(spec, n, p, dtype, dev)}
    g = np.random.default_rng(4)
    for r in range(3):
        bcast = torch.from_numpy(g.normal(size=(n, p)).astype(np.float32)).to(dtype)
        adj = base.copy()
        adj[:, [1, 6] if r else [6]] = 0.0  # 1 delivers in round 0, 6 never
        recv, scrub = np.ones(n, np.float32), np.ones(n, np.float32)
        recv[9] = 0.0
        adj[9, :] = 0.0
        if r == 2:
            scrub[3] = 0.0
            adj[:, 3] = 0.0
        out = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            b, a, up, st = folds[where](
                bcast.to(d), torch.from_numpy(adj).to(d), states[where],
                torch.from_numpy(recv).to(d), torch.from_numpy(scrub).to(d))
            states[where] = up
            out[where] = (b, a, up, st)
        (cb, ca, cu, cs), (gb, ga, gu, gs) = out["cpu"], out["card"]
        assert torch.equal(gb.cpu(), cb) and torch.equal(gu[CACHE_KEY].cpu(), cu[CACHE_KEY])
        assert torch.equal(gu[AGE_KEY].cpu(), cu[AGE_KEY])
        assert torch.equal(ga.cpu() > 0, ca > 0)
        torch.testing.assert_close(ga.cpu(), ca, rtol=1e-6, atol=0)
        for k in cs:
            assert torch.equal(gs[k].cpu(), cs[k]), (r, k)
    assert float(cs["stale_used"]) > 0 and float(cs["stale_expired"]) > 0


def test_memory_event_reads_the_card(dev, tmp_path):
    from murmura_tpu_torch.telemetry.writer import TelemetryWriter, events_of_type

    x = torch.empty((64, 1 << 20), device=dev)  # 256 MiB
    w = TelemetryWriter(tmp_path / "run", memory_stats=True)
    w.memory_event(0, dev)
    w.close()
    (e,) = events_of_type(tmp_path / "run", "memory")
    assert e["device_kind"] == torch.cuda.get_device_name(dev)
    stats = e["stats"]
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(dev)
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= x.numel() * 4
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(dev).total_memory
    del x


def _tiny_krum(mode, **sections):
    cfg = {
        "experiment": {"name": "cuda-tiny", "seed": 7, "rounds": 2, "verbose": False},
        "topology": {"type": "k-regular", "num_nodes": 16, "k": 4},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 1}},
        "attack": {"enabled": True, "type": "gaussian", "percentage": 0.2,
                   "params": {"noise_std": 10.0}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.02},
        "data": {"adapter": "leaf.femnist", "params": {"num_samples": 640}},
        "model": {"factory": "leaf.femnist.tiny", "params": {}},
        "backend": "tpu",
        "tpu": {"exchange": mode, "compute_dtype": "bfloat16"},
    }
    for k, v in sections.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return cfg


@pytest.mark.parametrize("exchange", ["allgather", "ppermute"])
def test_pipelined_krum_round_launches_its_kernel(dev, tmp_path, exchange):
    # Round 0 aggregates the placeholder buffer through the rule too: two
    # distance calls a round from the first round on.
    from murmura_tpu_torch import cli

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_tiny_krum(exchange, exchange={"pipeline": True})))
    K.reset_counts()
    history, network = cli.run(path, output=tmp_path / "h.json", device="cuda")
    kernel = "pairwise_sq_distances" if exchange == "allgather" else "circulant_sq_distances"
    assert K.LAUNCHES[kernel] == 4 and not any(K.PLAIN_CALLS.values())
    assert history["agg_pipe_valid"] == [0.0, 1.0]
    assert network.program.pipelined and bool(torch.isfinite(network.flat).all())


@pytest.mark.parametrize("force_sync", [False, True])
def test_transfer_guard_raises_on_a_sync_inside_a_chunk(dev, force_sync):
    from murmura_tpu_torch.config import Config
    from murmura_tpu_torch.utils.factories import build_network_from_config

    config = Config.model_validate(_tiny_krum("allgather", tpu={"transfer_guard": True}))
    network = build_network_from_config(config, device="cuda")
    assert network.transfer_guard
    step = network.program.train_step

    def step_that_syncs(*args, **kwargs):
        out = step(*args, **kwargs)
        if force_sync:
            float(out[0][0, 0])  # a device-to-host copy inside the round
        return out

    network.program.train_step = step_that_syncs
    # The first chunk of a key may synchronise: the one-time device copies.
    network.train(2, rounds_per_dispatch=2)
    if force_sync:
        with pytest.raises(RuntimeError, match="synchroniz"):
            network.train(2, rounds_per_dispatch=2)
    else:
        network.train(2, rounds_per_dispatch=2)
        assert network.history["round"] == [1, 2, 3, 4]
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("n,p", [(16, 100_003), (64, 20_011), (256, 2_762)])
def test_circulant_kernel_at_the_exponential_offsets(dev, n, p):
    # The sparse exchange's distance pass: offsets 2^i mod N (k = 4, 6, 8),
    # Krum's bcast-bcast pass at their differences too.  N = 256 stays under
    # the wrapper's 260-row limit: one launch a call.
    from murmura_tpu_torch.topology.sparse import exponential_offsets

    offsets = list(exponential_offsets(n))
    deltas = sorted({abs(a - b) for a in offsets for b in offsets if a != b})
    own, b = _rows(n + p, n, p, dev), _rows(n + p + 1, n, p, dev)
    for a, offs in ((own, offsets), (b, deltas)):
        before = K.LAUNCHES["circulant_sq_distances"]
        got = K.circulant_sq_distances(a, b, offs)
        torch.cuda.synchronize()
        assert K.LAUNCHES["circulant_sq_distances"] == before + 1
        ref = K.circulant_sq_distances_plain(a, b, offs)
        assert got.shape == (len(offs), n)
        assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))


@pytest.mark.parametrize("kind", ["exponential", "one_peer"])
def test_sparse_krum_run_launches_its_kernel(dev, tmp_path, kind):
    from murmura_tpu_torch import cli

    cfg = _tiny_krum("allgather")
    cfg["topology"] = {"type": kind, "num_nodes": 16}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    K.reset_counts()
    history, network = cli.run(path, output=tmp_path / "h.json", device="cuda")
    # Own-to-broadcast at the 4 offsets, broadcast-to-broadcast at their
    # differences: two launches a round.
    assert K.LAUNCHES["circulant_sq_distances"] == 2 * len(history["round"])
    assert not K.LAUNCHES["pairwise_sq_distances"] and not any(K.PLAIN_CALLS.values())
    assert network.program.sparse_offsets == (1, 2, 4, 8)
    assert bool(torch.isfinite(network.flat).all())


@pytest.mark.parametrize("exchange", ["allgather", "ppermute"])
def test_gang_launches_each_kernel_once_a_member(dev, tmp_path, exchange):
    from murmura_tpu_torch import cli

    # The synthetic adapter's equal shards: a gang refuses members whose
    # LEAF shards differ in size between seeds.
    cfg = _tiny_krum(exchange)
    cfg["data"] = {"adapter": "synthetic",
                   "params": {"num_samples": 640, "input_shape": [28, 28, 1], "num_classes": 62}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    kernel = "pairwise_sq_distances" if exchange == "allgather" else "circulant_sq_distances"
    K.reset_counts()
    history, _ = cli.run(path, output=tmp_path / "h.json", device="cuda")
    single = K.LAUNCHES[kernel]
    K.reset_counts()
    histories, gang = cli.run(path, output=tmp_path / "g.json", device="cuda", num_seeds=3)
    assert single == 2 * len(history["round"])
    assert K.LAUNCHES[kernel] == 3 * single and not any(K.PLAIN_CALLS.values())
    assert list(histories) == [m.label for m in gang.members]
    assert bool(torch.isfinite(gang.flats).all())


def _population_cfg(**population):
    return {
        "experiment": {"name": "cuda-pop", "seed": 3, "rounds": 3, "verbose": False},
        "topology": {"type": "exponential", "num_nodes": 8},
        "aggregation": {"algorithm": "krum", "params": {"num_compromised": 0}},
        "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 320, "input_dim": 16, "num_classes": 4}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 16, "hidden_dims": [16], "num_classes": 4}},
        "backend": "tpu",
        "tpu": {"transfer_guard": True},
        "population": {"enabled": True, "virtual_size": 24, "sampler": "uniform", "seed": 9,
                       **population},
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_population_swap_on_the_card(dev, dtype):
    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.utils.factories import build_network_from_config

    raw = _population_cfg()
    raw["tpu"]["param_dtype"] = dtype
    config = Config.model_validate(raw)
    net = build_network_from_config(config, device="cuda")
    cpu = build_network_from_config(config, device="cpu")
    # One spread initial state for both (the first swap teleports it into
    # the cohort), so that Krum's picks sit off float32 ties.
    g = torch.Generator().manual_seed(0)
    base = cpu.flat.to(torch.float32)
    scale = 0.05 * (1.0 + torch.arange(8.0) / 8)[:, None]
    spread = (base[:1] + scale * torch.randn(base.shape, generator=g)).to(cpu.flat.dtype)
    cpu.flat, net.flat = spread, spread.to(dev)
    # The card draws the CPU's shuffle keys, copied to it before the run
    # (a copy inside a round would trip tpu.transfer_guard).
    from murmura_tpu_torch.core.rounds import round_generators

    train_step = net.program.train_step
    shape = tuple(cpu.program.data["mask"].shape)
    keys = [torch.rand(shape, generator=round_generators(3, r, "cpu")["train"]).to(dev)
            for r in range(3)]

    def cpu_draws(*args, **kwargs):
        return train_step(*args, **kwargs, draws={"u": [keys[int(args[4])]]})

    import dataclasses

    net.program = dataclasses.replace(net.program, train_step=cpu_draws)
    K.reset_counts()
    # Three swaps under tpu.transfer_guard: the write-backs sit outside its
    # region, so nothing raises.
    history = net.train(3)
    assert K.LAUNCHES["circulant_sq_distances"] == 6 and not any(K.PLAIN_CALLS.values())
    cpu.train(3)
    assert np.array_equal(net.cohort, cpu.cohort)
    assert np.array_equal(net.bank._has_row, cpu.bank._has_row)
    ids = net.bank.activated_users
    delta = np.abs(net.bank.rows_of(ids) - cpu.bank.rows_of(ids)).max()
    assert delta <= 1e-4 * max(1.0, float(np.abs(cpu.bank.rows_of(ids)).max()))
    assert all(np.isfinite(v).all() for v in history.values())
    # The prefetch: pinned host buffers, the copy queued without a wait.
    net._prefetch(3)
    rows_host, known_host = net._prefetched[4]
    assert rows_host.is_pinned() and known_host.is_pinned()
    assert net._prefetched[2].device.type == "cuda"
    # The swap: the write-back of the outgoing rows, then the teleport
    # composition on the card.
    outgoing = net.flat.to(torch.float32).cpu().numpy()
    out_users = net.cohort.copy()
    incoming = net._draw(3)
    net.bank.scatter(out_users, outgoing)
    known = net.bank.has_rows(incoming)[:, None]
    rows = net.bank.gather(incoming, net._slot_init)
    net._swap_to(3, 3)
    assert np.array_equal(net.bank.rows_of(out_users), outgoing)
    want = torch.from_numpy(np.where(known, rows, outgoing)).to(getattr(torch, dtype))
    assert net.flat.device.type == "cuda" and torch.equal(net.flat.cpu(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_dmtt_round_update_card_equals_cpu(dev, seed):
    from murmura_tpu_torch.attacks.topology_liar import false_claims
    from murmura_tpu_torch.dmtt import protocol as P
    from murmura_tpu_torch.topology.dynamic import MobilityModel

    n = 16
    rng = np.random.default_rng(seed)
    params = P.DMTTParams()
    mob = MobilityModel(n, comm_range=40.0, seed=seed)
    comp = torch.from_numpy((rng.random(n) < 0.25).astype(np.float32))
    states = {"cpu": P.init_dmtt_state(n), "cuda": P.init_dmtt_state(n, dev)}
    for r in range(5):
        adj = torch.from_numpy(mob.adjacency_at(r).astype(np.float32))
        acc = torch.from_numpy(rng.integers(0, 17, (n, n)).astype(np.float32) / 16.0)
        vac = torch.from_numpy(rng.random((n, n)).astype(np.float32))
        out = {}
        for name, d in (("cpu", "cpu"), ("cuda", dev)):
            out[name] = P.dmtt_round_update(
                states[name], adj.to(d), false_claims(adj, comp).to(d), acc.to(d),
                vac.to(d), params)
            states[name] = out[name][1]
        (ex_a, st_a, stats_a), (ex_b, st_b, stats_b) = out["cpu"], out["cuda"]
        assert torch.equal(ex_a, ex_b.cpu()), r
        assert torch.equal(st_a["dmtt_collab"], st_b["dmtt_collab"].cpu()), r
        for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
            np.testing.assert_allclose(st_b[k].cpu().numpy(), st_a[k].numpy(), rtol=1e-6)
        for k in ("dmtt_collab_count", "dmtt_received_count"):
            assert torch.equal(stats_a[k], stats_b[k].cpu()), k
        np.testing.assert_allclose(stats_b["dmtt_mean_topo_trust"].cpu().numpy(),
                                   stats_a["dmtt_mean_topo_trust"].numpy(), rtol=1e-6)


def test_dmtt_mobility_run_on_the_card(dev, tmp_path):
    from murmura_tpu_torch import cli

    cfg = yaml.safe_load(open("examples/configs/dmtt_mobility.yaml"))
    cfg["experiment"].update(rounds=3, verbose=False)
    path = tmp_path / "dmtt.yaml"
    path.write_text(yaml.safe_dump(cfg))
    K.reset_counts()
    history, network = cli.run(path, output=tmp_path / "h.json", device="cuda")
    assert not any(K.LAUNCHES.values()) and not any(K.PLAIN_CALLS.values())
    assert network.mobility is not None and network.flat.device.type == "cuda"
    assert len(history["agg_dmtt_collab_count"]) == 3
    assert all(np.isfinite(v).all() for v in history.values())


def _adaptive_cfg(mode, members=None):
    cfg = _tiny_krum(mode)
    cfg["attack"].update(percentage=0.4, params={"noise_std": 0.02, "seed": 7},
                         adaptive={"enabled": True})
    cfg["data"] = {"adapter": "synthetic",
                   "params": {"num_samples": 320, "input_shape": [8], "num_classes": 4}}
    cfg["model"] = {"factory": "mlp",
                    "params": {"input_dim": 8, "hidden_dims": [16], "num_classes": 4}}
    if members is not None:
        cfg["sweep"] = {"members": members}
    return cfg


@pytest.mark.parametrize("exchange", ["allgather", "ppermute"])
def test_adaptive_krum_round_card_equals_cpu(dev, exchange):
    # Three chained rounds of the bisection around gaussian std 0.02 (40%
    # compromised) from one spread start and the same injected draws: the
    # card's kernel against the CPU's plain version, the picks and the
    # bracket equal, the acceptance EMA within rtol 1e-6.
    from murmura_tpu_torch.config import Config
    from murmura_tpu_torch.core.rounds import build_round_program
    from murmura_tpu_torch.data.registry import build_federated_data
    from murmura_tpu_torch.models.mlp import make_mlp
    from murmura_tpu_torch.utils.factories import build_attack, build_rule, build_topology

    config = Config.model_validate(_adaptive_cfg(exchange))
    topology = build_topology(config)
    model = make_mlp(8, [16], 4)
    agg, _ = build_rule(config, model, topology)
    data = build_federated_data("synthetic", dict(config.data.params), num_nodes=16, seed=7)
    rng = np.random.default_rng(7)
    template = model.init(torch.Generator().manual_seed(7), "cpu")
    scale = 0.05 * (1.0 + np.arange(16) / 16)
    from murmura_tpu_torch.ops.flatten import tree_map

    init = tree_map(lambda t: (t.numpy()[None] + scale.reshape((16,) + (1,) * t.dim())
                               * rng.normal(size=(16,) + tuple(t.shape))).astype(np.float32),
                    template)
    u = rng.random(data.mask.shape).astype(np.float32)
    runs = {}
    for d in (dev, torch.device("cpu")):
        attack = build_attack(config)
        prog = build_round_program(model, agg, data, attack=attack, batch_size=16, lr=0.02,
                                   seed=7, device=d, init_params=init)
        comp = torch.as_tensor(attack.compromised.astype(np.float32)).to(d)
        adj = torch.as_tensor(topology.mask()).to(d)
        flat, state, rows = prog.init_flat, prog.init_agg_state, []
        K.reset_counts()
        for r in range(3):
            noise = np.random.default_rng(r).normal(
                size=(int(comp.sum()), prog.model_dim)).astype(np.float32)
            flat, state, m = prog.train_step(flat, state, adj, comp, float(r),
                                             draws={"u": [u], "noise": noise})
            rows.append((flat.cpu().double(), m["agg_selected_index"].cpu(),
                         {k: state[k].cpu() for k in attack.state_keys}))
        runs[d.type] = (rows, dict(K.LAUNCHES), dict(K.PLAIN_CALLS))
    kernel = "pairwise_sq_distances" if exchange == "allgather" else "circulant_sq_distances"
    (card, launches, plain), (cpu, _, _) = runs["cuda"], runs["cpu"]
    assert launches[kernel] == 6 and not any(plain.values())
    for (f_card, p_card, s_card), (f_cpu, p_cpu, s_cpu) in zip(card, cpu):
        assert torch.equal(p_card, p_cpu)
        for k in ("atk_scale", "atk_lo", "atk_hi"):
            assert torch.equal(s_card[k], s_cpu[k]), k
        np.testing.assert_allclose(s_card["atk_accept_ema"], s_cpu["atk_accept_ema"], rtol=1e-6)
        assert float((f_card - f_cpu).abs().max()) / max(1.0, float(f_cpu.abs().max())) <= 1e-4


def test_gang_stage_reset_on_the_card(dev):
    # A stage reset builds nothing and launches each member's kernel as a
    # fresh gang of the new members does, to the same decisions.
    from murmura_tpu_torch.config import Config
    from murmura_tpu_torch.core.gang import GangMember
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    first = [{"seed": 7, "attack_scale": 0.0}, {"seed": 7, "attack_scale": 1.0}]
    second = [{"seed": 7, "attack_scale": 0.0}, {"seed": 7, "attack_scale": 3.0}]
    gang = build_gang_from_config(Config.model_validate(_adaptive_cfg("allgather", first)),
                                  device="cuda", retain_init=True)
    K.reset_counts()
    gang.train(2, eval_every=2, rounds_per_dispatch=2)
    gang.reset_run([GangMember(**m) for m in second])
    got = gang.train(2, eval_every=2, rounds_per_dispatch=2)
    assert gang.program_builds == 1
    assert K.LAUNCHES["pairwise_sq_distances"] == 2 * 2 * 2 * 2 and not any(K.PLAIN_CALLS.values())
    fresh = build_gang_from_config(Config.model_validate(_adaptive_cfg("allgather", second)),
                                   device="cuda")
    ref = fresh.train(2, eval_every=2, rounds_per_dispatch=2)
    for g, r in zip(got, ref):
        assert g["agg_selected_index"] == r["agg_selected_index"]
        assert g["agg_atk_scale"] == r["agg_atk_scale"]
    for s in range(2):
        for k in ("atk_scale", "atk_lo", "atk_hi"):
            assert torch.equal(gang.agg_states[s][k], fresh.agg_states[s][k]), k
    delta = (gang.flats - fresh.flats).abs().max() / max(1.0, float(fresh.flats.abs().max()))
    assert float(delta) <= 1e-5


def _serve_grid_raw():
    from pathlib import Path

    return yaml.safe_load((Path(__file__).resolve().parents[1] / "examples" / "configs"
                           / "serve_grid.yaml").read_text())


def test_warm_bucket_admission_on_the_card(dev):
    # A serve bucket's second generation splices new tenants into the warm
    # lanes: no chunk program, no nvcc build, each member's kernel launched
    # as in the first, and the same decisions as a fresh gang of those
    # tenants.
    from murmura_tpu_torch.config import Config
    from murmura_tpu_torch.core.gang import GangMember
    from murmura_tpu_torch.ops import _build
    from murmura_tpu_torch.utils.factories import (
        build_gang_from_config,
        build_gang_member_programs,
    )

    raw = _serve_grid_raw()
    raw.pop("grid")
    raw["experiment"]["rounds"] = 2
    raw["sweep"] = {"members": [{"seed": 7, "lr": 0.05}]}
    cfg = Config.model_validate(raw)
    gang = build_gang_from_config(cfg, device="cuda", min_batch=2)
    gang.train(2)
    built = (gang.program_builds, len(_build.STARTED))
    tenants = [GangMember(seed=11, lr=0.05), GangMember(seed=13, lr=0.02)]
    progs = [build_gang_member_programs(cfg, [m], device="cuda")[0] for m in tenants]
    K.reset_counts()
    gang.reset_run(tenants, member_programs=progs)
    got = gang.train(2)
    assert (gang.program_builds, len(_build.STARTED)) == built and gang.batch == 2
    assert K.LAUNCHES["pairwise_sq_distances"] == 2 * 2 * 2 and not any(K.PLAIN_CALLS.values())
    fresh_raw = dict(raw, sweep={"members": [{"seed": 11, "lr": 0.05}, {"seed": 13, "lr": 0.02}]})
    ref = build_gang_from_config(Config.model_validate(fresh_raw), device="cuda").train(2)
    for g, r in zip(got, ref):
        assert g["agg_selected_index"] == r["agg_selected_index"]
        np.testing.assert_allclose(g["mean_loss"], r["mean_loss"], rtol=1e-4)


def test_one_bucket_grid_on_the_card(dev, tmp_path):
    # serve_grid.yaml's Krum bucket at [12, P] through the grid command: one
    # chunk program, Krum's two pairwise passes a round for each member.
    from murmura_tpu_torch import cli
    from murmura_tpu_torch.serve.scheduler import load_grid

    raw = _serve_grid_raw()
    raw["grid"].update(rules=["krum"], rounds=2)
    path = tmp_path / "grid.yaml"
    path.write_text(yaml.safe_dump(raw))
    K.reset_counts()
    cli.main(["grid", str(path), "-o", str(tmp_path / "grid.json")])
    art = load_grid(tmp_path / "grid.json")
    (bucket,) = art["buckets"]
    assert bucket["gang_size"] == 10 and bucket["batch"] == 16 and bucket["compiles"] >= 1
    assert K.LAUNCHES["pairwise_sq_distances"] == 2 * 10 * 2 and not any(K.PLAIN_CALLS.values())
    assert all(np.isfinite(c["final_accuracy"]) for c in art["cells"])


def _scaled(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("factory", ["leaf.shakespeare", "leaf.celeba", "celeba_im2col"])
def test_new_models_forward_and_backward_card_equals_cpu(dev, factory):
    # The published widths in float32 (TF32 off): logits and every
    # gradient within a scaled 1e-4 of the CPU's (float32 sums in another
    # order; the LSTM's over 80 steps), int64 tokens into the embedding.
    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops.flatten import tree_leaves, tree_map
    from murmura_tpu_torch.ops.losses import masked_cross_entropy

    params = {"conv_impl": "im2col"} if factory == "celeba_im2col" else {}
    model = build_model(factory.replace("celeba_im2col", "leaf.celeba"), params)
    cpu_params = model.init(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    if "shakespeare" in factory:
        x = torch.from_numpy(rng.integers(0, 81, size=(4, 80))).long()
    else:
        x = torch.from_numpy(rng.random((4, 84, 84, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, model.num_classes, size=4)).long()
    m = torch.ones(4)
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d), cpu_params)

        def loss(q):
            logits = model.apply(q, x.to(d))
            return masked_cross_entropy(logits, y.to(d), m.to(d))[0], logits

        grads, logits = torch.func.grad(loss, has_aux=True)(p)
        out[str(d)] = (logits, tree_leaves(grads))
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["cuda"]
    assert _scaled(l_card, l_cpu) <= 1e-4
    for a, b in zip(g_card, g_cpu):
        assert _scaled(a, b) <= 1e-4


def test_im2col_equals_direct_on_the_card(dev):
    from murmura_tpu_torch.models.core import conv2d

    rng = np.random.default_rng(5)
    for k, cin, cout in ((3, 3, 32), (3, 32, 64), (5, 1, 32)):
        p = {"w": torch.from_numpy(rng.normal(size=(k, k, cin, cout)).astype(np.float32)
                                   * 0.1).to(dev),
             "b": torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)}
        x = torch.from_numpy(rng.normal(size=(4, cin, 21, 21)).astype(np.float32)).to(dev)
        assert _scaled(conv2d(p, x, None, "im2col"), conv2d(p, x, None, "direct")) <= 1e-5
        bf = torch.bfloat16
        got, ref = conv2d(p, x, bf, "im2col"), conv2d(p, x, bf, "direct")
        assert _scaled(got, ref) <= 2e-2


def test_dmtt_gang_round_card_equals_cpu(dev):
    # One gang round of dmtt_mobility shrunk to 8 nodes (2 seeds), the
    # card's gang and the CPU's from the same parameters on the same
    # injected draws: parameters within a scaled 1e-4, the TopB masks
    # equal, the trust state within rtol 1e-5 (the DMTT card tolerance).
    from murmura_tpu_torch.config import Config
    from murmura_tpu_torch.core.network import effective_adjacency
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    raw = yaml.safe_load(open("examples/configs/dmtt_mobility.yaml"))
    raw["experiment"].update(rounds=1, verbose=False)
    raw["topology"]["num_nodes"] = 8
    raw["data"]["params"]["num_samples"] = 960
    raw["training"]["max_samples"] = 24
    raw["attack"]["params"]["seed"] = 42
    gangs = {d: build_gang_from_config(Config.model_validate(raw), seeds=[42, 43], device=d)
             for d in ("cpu", "cuda")}
    cpu_gang, card_gang = gangs["cpu"], gangs["cuda"]
    s_count, n, p = cpu_gang.flats.shape
    rng = np.random.default_rng(1)
    masks = [prog.data["mask"] for prog in cpu_gang.programs]
    draws = [{"u": [rng.random(tuple(mk.shape)).astype(np.float32)],
              "noise": rng.normal(size=(int(cpu_gang.compromised.sum()), p)).astype(np.float32)}
             for mk in masks]
    adj = torch.from_numpy(effective_adjacency(cpu_gang.topology, cpu_gang.mobility, None, 0))
    out = {}
    for d, gang in gangs.items():
        flats = cpu_gang.flats.clone().to(d)
        out[d] = gang._step(flats, gang.agg_states, adj.to(d), 0, draws=draws)
    (f_cpu, st_cpu, _), (f_card, st_card, m_card) = out["cpu"], out["cuda"]
    assert card_gang.flats.device.type == "cuda"
    assert _scaled(f_card, f_cpu) <= 1e-4
    for s in range(s_count):
        for k in ("dmtt_collab", "dmtt_selected"):
            assert torch.equal(st_card[s][k].cpu(), st_cpu[s][k]), k
        for k in ("dmtt_c_hat", "dmtt_alpha", "dmtt_beta"):
            np.testing.assert_allclose(st_card[s][k].cpu().numpy(), st_cpu[s][k].numpy(),
                                       rtol=1e-5)
        assert m_card[s]["agg_dmtt_collab_count"].device.type == "cuda"


@pytest.mark.parametrize("rule,exchange", [("krum", "allgather"), ("median", "ppermute")])
def test_sharded_group_on_one_card_matches_unsharded(dev, rule, exchange):
    # A param group of 2 gloo ranks on cuda:0 (parallel/launch.py's test
    # seam, its all_to_all staged through pinned host memory) against the
    # unsharded program on the card, one round of tests/torch_sharding_cases
    # .rule_case: the decisions equal, the parameters within a scaled 1e-4,
    # each rank's kernels launched (Krum's two pairwise calls, the median's
    # candidate select), no plain call and no JAX in a rank.
    import torch_sharding_cases as cases
    from murmura_tpu_torch.parallel.launch import launch

    spec = {"rule": rule, "exchange": exchange, "device": "cuda", "rounds": 1}
    group = launch(cases.counted_cases, ([("rule", spec)],), world=2, device_type="cuda",
                   one_device=True)
    ref = cases.run_cases([("rule", spec)])["results"][0]
    got = group[0]["results"][0]
    assert _scaled(torch.from_numpy(got["flat"]), torch.from_numpy(ref["flat"])) <= 1e-4
    for k in ("agg_selected_index", "agg_selected_own", "agg_num_candidates"):
        if k in ref["rounds"][0]:
            np.testing.assert_array_equal(got["rounds"][0][k], ref["rounds"][0][k], err_msg=k)
    kernel = "pairwise_sq_distances" if rule == "krum" else "candidate_select"
    for rank in group:
        assert rank["launches"][kernel] == (2 if rule == "krum" else 1)
        assert not any(rank["plain_calls"].values())
        assert rank["forbidden_modules"] == []


@pytest.mark.parametrize("rule,params,kernels", [
    ("krum", {"num_compromised": 1}, {"pairwise_sq_distances": 2}),
    ("sketchguard", {"sketch_size": 64}, {"count_sketch": 2, "pairwise_sq_distances": 1}),
])
def test_local_node_on_the_card_equals_the_cpu(dev, rule, params, kernels):
    # The ZMQ backend's LocalNode (distributed/local.py): one node with the
    # UCI HAR evidential MLP (dropout 0.3) trains on the card and on the CPU
    # from one start with one draw stream (its CPU generator), then
    # aggregates on its [5, P] mini network with the same four received
    # states: the rule's kernels launch on the card, no plain call; picks
    # equal, parameters within a scaled 1e-4.
    from murmura_tpu_torch.aggregation import build_aggregator
    from murmura_tpu_torch.distributed.local import LocalNode
    from murmura_tpu_torch.models.registry import build_model
    from murmura_tpu_torch.ops import sketch_kernels
    from murmura_tpu_torch.ops.flatten import model_dimension, tree_to_numpy

    g = np.random.default_rng(3)
    x = g.normal(size=(96, 561)).astype(np.float32)
    y = g.integers(0, 6, size=96).astype(np.int32)
    model = build_model("wearables.uci_har", {})
    init = tree_to_numpy(model.init(torch.Generator().manual_seed(3), "cpu"))
    dim = model_dimension(init)
    out = {}
    for d in (dev, torch.device("cpu")):
        node = LocalNode(0, model, build_aggregator(rule, params, model_dim=dim), x, y,
                         max_neighbors=4, batch_size=32, lr=0.01, local_epochs=2, seed=3,
                         device=d, init_params=init)
        node.local_train(0)
        own = node.get_flat_state()
        states = {j: (own + 0.02 * (1 + j) * g.normal(size=own.shape)).astype(np.float32)
                  for j in (1, 2, 3, 4)} if d.type == "cuda" else out["states"]
        K.reset_counts()
        sketch_kernels.reset_counts()
        node.aggregate_with_neighbors(states, 0)
        launches = {**K.LAUNCHES, **sketch_kernels.LAUNCHES}
        plain = {**K.PLAIN_CALLS, **sketch_kernels.PLAIN_CALLS}
        out[d.type] = (own, node.get_flat_state(), node.get_aggregator_statistics(),
                       launches, plain)
        out["states"] = states
    (own_c, flat_c, st_c, launches, plain), (own_p, flat_p, st_p, _, _) = out["cuda"], out["cpu"]
    for k, n in kernels.items():
        assert launches[k] == n, (k, launches)
    assert not any(plain.values()), plain
    scale = max(1.0, float(np.abs(flat_p).max()))
    assert float(np.abs(own_c - own_p).max()) / scale <= 1e-4
    assert float(np.abs(flat_c - flat_p).max()) / scale <= 1e-4
    for k in ("selected_index", "selected_own", "acceptance_rate"):
        if k in st_p:
            assert st_c[k] == st_p[k], k
