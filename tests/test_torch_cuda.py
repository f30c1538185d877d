"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py pins JAX to the CPU.)
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
