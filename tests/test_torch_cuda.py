"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py pins JAX to the CPU.)
Tolerances are chip_smoke.py's: |d2 - plain| <= 1e-5 (|a_i|^2 + |b_j|^2)
for the pairwise kernel, whose Gram identity cancels in float32, and
|d2 - plain| <= 1e-5 max(1, |plain|) for the circulant kernel's direct sums.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.ops import agg_kernels as K

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
    "n,p,m", [(16, 100_003, 16), (5, 1, 5), (33, 4099, 20), (1, 300, 17), (16, 128, 16)]
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


def test_kernels_are_deterministic(dev):
    a, b = _rows(0, 16, 200_000, dev), _rows(1, 16, 200_000, dev)
    assert torch.equal(K.pairwise_sq_distances(a, b), K.pairwise_sq_distances(a, b))
    offs = [1, 2, 14, 15]
    assert torch.equal(K.circulant_sq_distances(a, b, offs), K.circulant_sq_distances(a, b, offs))


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
