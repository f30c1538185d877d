"""The port's compressed exchange against the JAX package's, on the CPU.

- ``quantize_int8`` is bit-equal to the JAX package's jitted codec (``q``,
  ``scale``, the float32 dequantization and the decoded tensor in the
  input's dtype) in float32 and bfloat16, with all-zero blocks and P not a
  multiple of the block;
- top-k is bit-equal: ``topk_mask`` picks exactly the coordinates of
  ``topk_encode``'s indices, and the masked delta equals ``topk_decode``,
  with ties planted at the k-th magnitude;
- ``compress_exchange`` over three chained rounds with error feedback:
  the decoded tensor, the residual and the top-k reference bit-equal to
  the JAX package's, the ``compress_*`` stats within rtol 1e-6 (float32
  sums in another order);
- each ``quantized_exchange`` rule under ppermute with int8: the port's
  rule on the receiver-side float32 dequantization against the JAX rule on
  the ``Int8Blocks`` payload: decisions equal, float32 outputs allclose at
  rtol/atol 1e-5 (the circulant tolerance of tests/test_torch_rules.py);
  bfloat16 outputs bit-equal, except the geometric median's, which lie
  within |port - jax| <= r 2^-7 m (m the largest |value| among the node's
  candidates at that coordinate, r = 18: two bfloat16 roundings in each of
  its 9 weighted means after float32 sums in another order; PERF.md
  section 2's bound); fedavg, BALANCE and the trimmed mean on the
  bfloat16 decoded tensor instead are not bit-equal, which is why those
  rules get the float32 operand;
- one faulted, int8-compressed round of the MLP with error feedback (8
  nodes, k-regular(4), Krum under ppermute) through both round programs:
  the fault stats equal, the parameters within a scaled delta of 1e-4 and
  the codec error within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.krum import make_krum as jax_make_krum
from murmura_tpu.config import Config as JaxConfig
from murmura_tpu.core.rounds import build_round_program as jax_build_round
from murmura_tpu.data.registry import build_federated_data as jax_data
from murmura_tpu.faults.schedule import FaultSpec as JaxSpec
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu.ops import compress as J
from murmura_tpu.topology.generators import create_topology as jax_topology
from murmura_tpu.utils import factories as jax_factories
from murmura_tpu_torch.aggregation import AGGREGATORS
from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.aggregation.krum import make_krum
from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.core.rounds import build_round_program
from murmura_tpu_torch.faults.schedule import FaultSpec
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops import compress as T
from murmura_tpu_torch.utils import factories

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a tensor of ``dtype``."""
    jx = jnp.asarray(x).astype(JDT[dtype])
    return jx, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(TDT[dtype])


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def _rows(seed, n, p):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) * rng.uniform(1e-3, 1e2, size=(n, 1))
    x[1, : p // 3] = 0.0  # all-zero blocks
    x[2] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,block", [(1000, 256), (1024, 256), (77, 256), (3001, 64)])
def test_quantize_int8_is_bit_equal(dtype, p, block):
    jx, tx = _pair(_rows(p, 6, p), dtype)
    ref = jax.jit(lambda x: J.quantize_int8(x, block))(jx)
    got = T.quantize_int8(tx, block)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert np.array_equal(got.q.numpy(), np.asarray(ref.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert np.array_equal(got.dequantize_f32().numpy(), np.asarray(jax.jit(
        lambda x: J.quantize_int8(x, block).dequantize_f32())(jx)))
    # The decoded tensor of compress_exchange: the float32 values cast to
    # the input's dtype, padding stripped.
    deq = got.dequantize_f32()[:, :p].to(tx.dtype)
    assert deq.shape == tx.shape
    assert np.array_equal(_np(deq), _jnp(jax.jit(
        lambda x: J.quantize_int8(x, block).dequantize())(jx)))
    assert not got.q[2].any() and not got.scale[2].any()


def _planted_ties(seed, n, p, k):
    """Rows whose k-th largest magnitude is shared by many entries on both
    sides of the cut (positive and negative), and one row of all ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    for i in range(n - 1):
        kth = np.sort(np.abs(x[i]))[::-1][k - 1]
        pos = rng.choice(p, size=3 * k // 2, replace=False)
        x[i, pos] = np.where(rng.random(len(pos)) < 0.5, kth, -kth).astype(np.float32)
    x[-1] = 0.25
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_is_bit_equal_with_ties(seed):
    p, k = 5003, 250
    x = _planted_ties(seed, 6, p, k)
    jv, ji = jax.jit(lambda d: J.topk_encode(d, k))(jnp.asarray(x))
    t = torch.from_numpy(x)
    mask = T.topk_mask(t.abs(), k)
    assert (mask.sum(dim=1) == k).all()
    want = torch.zeros_like(mask).scatter_(1, torch.from_numpy(np.asarray(ji)).long(), True)
    assert torch.equal(mask, want)
    dec = torch.where(mask, t, torch.zeros_like(t))
    assert np.array_equal(dec.numpy(), np.asarray(J.topk_decode(jv, ji, p)))


@pytest.mark.parametrize("algorithm", ["int8", "topk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_error_feedback_over_three_rounds_is_bit_equal(algorithm, dtype):
    n, p = 6, 3001
    kw = dict(algorithm=algorithm, block=256, topk_ratio=0.05, error_feedback=True)
    jspec, tspec = J.CompressionSpec(**kw), T.CompressionSpec(**kw)
    init = _rows(99, n, p)
    j_init, t_init = _pair(init, dtype)
    j_state = {k: jnp.asarray(v) for k, v in
               J.init_compress_state(jspec, np.asarray(j_init), j_init.dtype).items()}
    t_state = T.init_compress_state(tspec, t_init)
    assert set(j_state) == set(t_state) == set(tspec.state_keys())
    step = jax.jit(lambda b, s: J.compress_exchange(jspec, b, s, False))
    rng = np.random.default_rng(5)
    for r in range(3):
        x = init + (0.1 * (r + 1) * rng.normal(size=(n, p))).astype(np.float32)
        jb, tb = _pair(x, dtype)
        _, j_dec, j_up, j_stats = step(jb, j_state)
        t_ex, t_dec, t_up, t_stats = T.compress_exchange(tspec, tb, t_state, False)
        assert t_ex is t_dec and t_dec.dtype == tb.dtype
        assert np.array_equal(_np(t_dec), _jnp(j_dec)), r
        assert set(t_up) == set(j_up)
        for key in j_up:
            assert t_up[key].dtype == t_state[key].dtype
            assert np.array_equal(_np(t_up[key]), _jnp(j_up[key])), (r, key)
        assert set(t_stats) == set(j_stats) == {"compress_error", "compress_residual_norm"}
        for key in j_stats:
            np.testing.assert_allclose(t_stats[key].numpy(), np.asarray(j_stats[key]),
                                       rtol=1e-6, err_msg=key)
        j_state = {**j_state, **j_up}
        t_state = {**t_state, **t_up}


def test_spec_and_config_wiring_match_jax():
    for kw in (dict(algorithm="int8", block=256), dict(algorithm="topk", topk_ratio=0.05),
               dict(algorithm="int8", block=100, error_feedback=True)):
        j, t = J.CompressionSpec(**kw), T.CompressionSpec(**kw)
        for p in (1, 77, 676, 6_603_710):
            assert t.topk_k(p) == j.topk_k(p)
            assert t.payload_bytes(p, 4) == j.payload_bytes(p, 4)
        assert t.state_keys() == j.state_keys()
    with pytest.raises(ValueError):
        T.CompressionSpec("int4")
    raw = {"experiment": {"name": "c", "seed": 1, "rounds": 2},
           "topology": {"type": "ring", "num_nodes": 4},
           "aggregation": {"algorithm": "fedavg"},
           "training": {"local_epochs": 1, "batch_size": 16, "lr": 0.05},
           "model": {"factory": "mlp", "params": {}},
           "data": {"adapter": "synthetic", "params": {}},
           "compression": {"algorithm": "topk", "topk_ratio": 0.1, "error_feedback": True}}
    got = factories.build_compression_spec(Config.model_validate(raw))
    ref = jax_factories.build_compression_spec(JaxConfig.model_validate(raw))
    assert (got.algorithm, got.block, got.topk_ratio, got.error_feedback) == (
        ref.algorithm, ref.block, ref.topk_ratio, ref.error_feedback)
    raw["compression"] = {"algorithm": "none"}
    assert factories.build_compression_spec(Config.model_validate(raw)) is None


OFFSETS = [1, 2, 14, 15]
QUANTIZED_RULES = {
    # rule: (params, decisions, r of the bfloat16 bound; 0: bit-equal)
    "krum": ({"num_compromised": 1}, ("selected_index", "selected_own"), 0),
    "fedavg": ({}, ("num_neighbors",), 0),
    "balance": ({"gamma": 1.0}, ("acceptance_rate",), 0),
    "median": ({"max_candidates": 5}, ("num_candidates",), 0),
    "trimmed_mean": ({"max_candidates": 5, "trim_ratio": 0.2},
                     ("num_candidates", "trimmed_per_side"), 0),
    "geometric_median": ({"max_candidates": 5}, ("num_candidates",), 18),
}


def _spread_states(n, p, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, p))
    own = (base + 0.2 * (1.0 + np.arange(n)[:, None] / n) * rng.normal(size=(n, p)))
    bcast = own.copy()
    bcast[[3, 7, 12]] += 10.0 * rng.normal(size=(3, p))
    return own.astype(np.float32), bcast.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", sorted(QUANTIZED_RULES))
def test_quantized_rules_take_the_decoded_route(rule, dtype):
    params, decisions, r = QUANTIZED_RULES[rule]
    n, p = 16, 2003
    own_np, bcast_np = _spread_states(n, p, 11)
    j_own, t_own = _pair(own_np, dtype)
    j_b, t_b = _pair(bcast_np, dtype)
    adj = jax_topology("k-regular", n, k=4).mask()
    kw = dict(params, exchange_offsets=OFFSETS)
    jr, tr = JAX_AGGREGATORS[rule](**kw), AGGREGATORS[rule](**kw)
    assert jr.quantized_exchange and tr.quantized_exchange
    payload = jax.jit(lambda x: J.quantize_int8(x, 256))(j_b)
    spec = T.CompressionSpec("int8", block=256)
    exchanged, decoded, _, _ = T.compress_exchange(spec, t_b, {}, True)
    assert exchanged.dtype == torch.float32 and decoded.dtype == t_b.dtype
    j_new, _, j_stats = jr.aggregate(j_own, payload, jnp.asarray(adj),
                                     jnp.asarray(2.0, jnp.float32), {}, JaxCtx(total_rounds=10))
    t_new, _, t_stats = tr.aggregate(t_own, exchanged, torch.from_numpy(adj), 2.0, {},
                                     AggContext(total_rounds=10))
    assert t_new.dtype == t_own.dtype and t_new.shape == t_own.shape
    for k in decisions:
        assert np.array_equal(_np(t_stats[k]), _jnp(j_stats[k])), k
    got, ref = _np(t_new), _jnp(j_new)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    elif r == 0:
        assert np.array_equal(got, ref)
    else:
        cand = [np.abs(_np(t_own))] + [np.abs(np.roll(_np(t_b), -o, axis=0)) for o in OFFSETS]
        limit = r * 2.0 ** -7 * np.max(cand, axis=0)
        assert (np.abs(got - ref) <= limit).all()
    if dtype == "bfloat16" and rule in ("fedavg", "balance", "trimmed_mean"):
        other, _, _ = tr.aggregate(t_own, decoded, torch.from_numpy(adj), 2.0, {},
                                   AggContext(total_rounds=10))
        assert not np.array_equal(_np(other), ref)
    if rule == "krum":
        assert not bool(t_stats["selected_own"].all())  # Krum really selected


@pytest.fixture(scope="module")
def faulted_compressed_round():
    n, seed = 8, 3
    data = jax_data("synthetic", {"num_samples": 640, "input_dim": 16, "num_classes": 4},
                    num_nodes=n, seed=seed)
    hp = dict(local_epochs=1, batch_size=16, lr=0.05, seed=seed)
    offsets = [1, 2, 6, 7]
    spec = dict(nan_quarantine=True, nan_inject_nodes=(2,), nan_inject_from_round=0)
    ckw = dict(algorithm="int8", block=64, error_feedback=True)
    jprog = jax_build_round(
        jax_mlp(16, [32], 4), jax_make_krum(num_compromised=1, exchange_offsets=offsets), data,
        faults=JaxSpec(**spec), compression=J.CompressionSpec(**ckw), **hp)
    rng = np.random.default_rng(seed)
    scale = 0.05 * (1.0 + np.arange(n) / n)
    init = jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[:1] + scale.reshape((n,) + (1,) * (np.ndim(a) - 1))
                   * rng.normal(size=np.shape(a))).astype(np.float32),
        jprog.init_params)
    adj = jax_topology("k-regular", n, k=4).mask()
    alive = np.ones(n, np.float32)
    alive[5] = 0.0
    comp = np.zeros(n, np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    init_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(init))
    residual = (0.01 * rng.normal(size=init_flat.shape)).astype(np.float32)
    j_state = {**jprog.init_agg_state, "compress_residual": residual}
    j_params, j_state, j_metrics = jax.jit(jprog.train_step)(
        jax.tree_util.tree_map(jnp.asarray, init), j_state, key,
        jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(alive),
        jnp.asarray(0.0, jnp.float32),
        {k: jnp.asarray(v) for k, v in jprog.data_arrays.items()},
    )
    j_flat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(j_params))
    train_key, _ = jax.random.split(key)
    perm_key, _ = jax.random.split(jax.random.split(train_key, 1)[0])
    u = np.array(jax.random.uniform(perm_key, data.mask.shape))
    prog = build_round_program(
        make_mlp(16, [32], 4), make_krum(num_compromised=1, exchange_offsets=offsets), data,
        faults=FaultSpec(**spec), compression=T.CompressionSpec(**ckw), init_params=init,
        device="cpu", **hp)
    assert set(prog.init_agg_state) == {"compress_residual"}
    assert not prog.init_agg_state["compress_residual"].any()
    flat, t_state, metrics = prog.train_step(
        prog.init_flat, {"compress_residual": torch.from_numpy(residual)},
        torch.from_numpy(adj), torch.from_numpy(comp), 0.0,
        draws={"u": [u]}, alive=torch.from_numpy(alive))
    return j_flat, j_state, j_metrics, flat, t_state, metrics


def test_faulted_compressed_round_matches_jax(faulted_compressed_round):
    j_flat, j_state, j_metrics, flat, t_state, metrics = faulted_compressed_round
    assert set(metrics) == {k for k in j_metrics}
    for k in ("agg_quarantined", "agg_alive"):
        assert float(metrics[k]) == float(j_metrics[k]), k
    assert float(metrics["agg_quarantined"]) == 1.0
    assert np.array_equal(metrics["agg_selected_index"].numpy(),
                          np.asarray(j_metrics["agg_selected_index"]))
    for k in ("agg_compress_error", "agg_compress_residual_norm"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(j_metrics[k]), rtol=1e-5,
                                   err_msg=k)
    delta = np.max(np.abs(flat.numpy() - j_flat)) / max(1.0, np.max(np.abs(j_flat)))
    assert delta <= 1e-4
    np.testing.assert_allclose(t_state["compress_residual"].numpy(),
                               np.asarray(j_state["compress_residual"]), rtol=1e-4, atol=1e-6)
