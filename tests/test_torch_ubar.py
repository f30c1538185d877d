"""UBAR and its loss probe in the PyTorch port against the JAX package, on
the same own/bcast/adj and the same probe batches.

- ``rank_mask`` equal to JAX's, with ties and +inf entries;
- ``pairwise_probe_eval`` ([N, N]) and ``circulant_probe_eval`` ([k, N])
  with the cross-entropy metric within rtol 1e-5 (float32 forwards of the
  same weights; the two frameworks' matmuls sum in other orders), and the
  accuracy metric equal;
- the rule itself against ``make_ubar`` in both exchanges: stage-1 and
  stage-2 acceptance equal, ``own_loss`` within rtol 1e-5 and the output
  within rtol/atol 1e-5.

The models are the plain MLP with JAX-initialised weights carried over.
Nodes sit around node 0's initial weights with distinct spreads, so the
honest neighbours' probe losses differ from a node's own loss by far more
than float32 rounding and ``losses <= own_loss`` decides the same way in
both packages.  ``rho`` 0.8 shortlists 3 of 4 neighbours, so stage 2 really
filters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from murmura_tpu.aggregation import AGGREGATORS as JAX_AGGREGATORS
from murmura_tpu.aggregation.base import AggContext as JaxCtx
from murmura_tpu.aggregation.base import rank_mask as jax_rank_mask
from murmura_tpu.aggregation.probe import accuracy_vacuity_metric as jax_acc_metric
from murmura_tpu.aggregation.probe import ce_loss_metric as jax_ce_metric
from murmura_tpu.aggregation.probe import circulant_probe_eval as jax_circulant_probe
from murmura_tpu.aggregation.probe import pairwise_probe_eval as jax_pairwise_probe
from murmura_tpu.aggregation.ubar import make_ubar as jax_make_ubar
from murmura_tpu.models.mlp import make_mlp as jax_mlp
from murmura_tpu_torch.aggregation import AGGREGATORS, build_aggregator
from murmura_tpu_torch.aggregation.base import AggContext, rank_mask
from murmura_tpu_torch.aggregation.probe import (
    accuracy_vacuity_metric,
    ce_loss_metric,
    circulant_probe_eval,
    pairwise_probe_eval,
)
from murmura_tpu_torch.aggregation.ubar import make_ubar
from murmura_tpu_torch.models.mlp import make_mlp
from murmura_tpu_torch.ops.flatten import make_flatteners, tree_to_torch

N = 12
B = 10
IN_DIM, HIDDEN, K = 20, (32, 16), 5
OFFSETS = [1, 2, 10, 11]  # k-regular(4) on 12 nodes
POISONED = [2, 7]


def _circulant_adj(n, offsets):
    adj = np.zeros((n, n), np.float32)
    for o in offsets:
        adj[np.arange(n), (np.arange(n) + o) % n] = 1.0
    return adj


def _irregular_adj(n, seed):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < 0.5, 1)
    return (upper | upper.T).astype(np.float32)


def _setup(seed):
    """(jax ctx, port ctx, own, bcast): spread MLP states, two of them
    broadcasting noise of std 10, and per-node probe batches with a few
    padded slots."""
    jmodel = jax_mlp(IN_DIM, HIDDEN, K)
    template = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    flat0, j_unravel = ravel_pytree(template)
    rng = np.random.default_rng(seed)
    spread = 0.05 * (1.0 + np.arange(N) / N)
    own = (np.asarray(flat0)[None] + spread[:, None] * rng.normal(size=(N, flat0.size)))
    own = own.astype(np.float32)
    bcast = own.copy()
    bcast[POISONED] += (10.0 * rng.normal(size=(len(POISONED), flat0.size))).astype(np.float32)
    px = rng.normal(size=(N, B, IN_DIM)).astype(np.float32)
    py = rng.integers(0, K, size=(N, B)).astype(np.int32)
    pm = (rng.random((N, B)) < 0.9).astype(np.float32)
    jctx = JaxCtx(apply_fn=jmodel.apply, unravel=j_unravel, probe_x=jnp.asarray(px),
                  probe_y=jnp.asarray(py), probe_mask=jnp.asarray(pm), num_classes=K)
    _, t_unravel, _ = make_flatteners(tree_to_torch(template))
    tctx = AggContext(apply_fn=make_mlp(IN_DIM, HIDDEN, K).apply, unravel=t_unravel,
                      probe_x=torch.from_numpy(px), probe_y=torch.from_numpy(py).long(),
                      probe_mask=torch.from_numpy(pm), num_classes=K)
    return jctx, tctx, own, bcast


def test_rank_mask_matches_jax_with_ties_and_inf():
    rng = np.random.default_rng(0)
    values = rng.integers(0, 4, size=(9, 11)).astype(np.float32)  # many ties
    values[rng.random(values.shape) < 0.2] = np.inf
    values[3] = 1.0  # a whole row tied (colluding senders)
    valid = rng.random(values.shape) < 0.7
    valid[5] = False  # a node with no candidate
    k = rng.integers(0, 6, size=9).astype(np.int32)
    ref = np.asarray(jax_rank_mask(jnp.asarray(values), jnp.asarray(valid), jnp.asarray(k)))
    got = rank_mask(torch.from_numpy(values), torch.from_numpy(valid),
                    torch.from_numpy(k).long())
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_probe_matches_jax(seed):
    jctx, tctx, _, bcast = _setup(seed)
    ref = jax_pairwise_probe(jnp.asarray(bcast), jctx, jax_ce_metric)["loss"]
    got = pairwise_probe_eval(torch.from_numpy(bcast), tctx, ce_loss_metric)["loss"]
    assert got.shape == (N, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    ref_acc = jax_pairwise_probe(jnp.asarray(bcast), jctx, jax_acc_metric)
    got_acc = pairwise_probe_eval(torch.from_numpy(bcast), tctx, accuracy_vacuity_metric)
    assert np.array_equal(got_acc["accuracy"].numpy(), np.asarray(ref_acc["accuracy"]))
    assert np.array_equal(got_acc["vacuity"].numpy(), np.asarray(ref_acc["vacuity"]))


@pytest.mark.parametrize("offsets", [OFFSETS, [1], [3, 5, 6]])
def test_circulant_probe_matches_jax(offsets):
    jctx, tctx, _, bcast = _setup(2)
    ref = jax_circulant_probe(jnp.asarray(bcast), offsets, jctx, jax_ce_metric)["loss"]
    got = circulant_probe_eval(torch.from_numpy(bcast), offsets, tctx, ce_loss_metric)["loss"]
    assert got.shape == (len(offsets), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    # Entry [o, i] is the model of node (i + o) % N on node i's batch: the
    # same number as the dense cross-evaluation's [i, (i + o) % N].
    dense = pairwise_probe_eval(torch.from_numpy(bcast), tctx, ce_loss_metric)["loss"]
    ar = torch.arange(N)
    for row, o in enumerate(offsets):
        np.testing.assert_allclose(got[row].numpy(), dense[ar, (ar + o) % N].numpy(), rtol=1e-6)


def _run_both(kw, adj, seed):
    jctx, tctx, own, bcast = _setup(seed)
    j_new, _, j_stats = jax_make_ubar(**kw).aggregate(
        jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
        jnp.asarray(0.0, jnp.float32), {}, jctx)
    t_new, _, t_stats = make_ubar(**kw).aggregate(
        torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj), 0.0, {}, tctx)
    return np.asarray(j_new), j_stats, t_new.numpy(), t_stats


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("graph", ["dense", "circulant", "irregular"])
def test_ubar_rule_matches_jax(graph, seed):
    kw = {"rho": 0.8, "alpha": 0.5}
    if graph == "circulant":
        kw["exchange_offsets"] = OFFSETS
    adj = _irregular_adj(N, seed) if graph == "irregular" else _circulant_adj(N, OFFSETS)
    j_new, j_stats, t_new, t_stats = _run_both(kw, adj, seed)
    assert set(t_stats) == set(j_stats) == {
        "stage1_acceptance_rate", "stage2_acceptance_rate", "own_loss"}
    for k in ("stage1_acceptance_rate", "stage2_acceptance_rate"):
        assert np.array_equal(t_stats[k].numpy(), np.asarray(j_stats[k])), k
    np.testing.assert_allclose(t_stats["own_loss"].numpy(), np.asarray(j_stats["own_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(t_new, j_new, rtol=1e-5, atol=1e-5)
    # Stage 2 filtered: somewhere fewer than all shortlisted neighbours passed.
    assert float(t_stats["stage2_acceptance_rate"].min()) < 1.0


def test_ubar_fallback_to_best_loss_matches_jax():
    # Every shortlisted neighbour's loss above the node's own (the own
    # states are the honest models, the broadcast rows all shifted far off):
    # each node falls back to its shortlisted neighbour of least loss.
    jctx, tctx, own, _ = _setup(4)
    bcast = (own + 3.0).astype(np.float32)
    adj = _circulant_adj(N, OFFSETS)
    for kw in ({"rho": 0.8}, {"rho": 0.8, "exchange_offsets": OFFSETS}):
        j_new, _, j_stats = jax_make_ubar(**kw).aggregate(
            jnp.asarray(own), jnp.asarray(bcast), jnp.asarray(adj),
            jnp.asarray(0.0, jnp.float32), {}, jctx)
        t_new, _, t_stats = make_ubar(**kw).aggregate(
            torch.from_numpy(own), torch.from_numpy(bcast), torch.from_numpy(adj), 0.0, {}, tctx)
        rate = t_stats["stage2_acceptance_rate"].numpy()
        assert np.array_equal(rate, np.asarray(j_stats["stage2_acceptance_rate"]))
        np.testing.assert_allclose(rate, np.full(N, 1.0 / 3.0, np.float32))
        np.testing.assert_allclose(t_new.numpy(), np.asarray(j_new), rtol=1e-5, atol=1e-5)


def test_ubar_is_registered():
    # Every rule of the JAX package is ported: UBAR and evidential trust
    # build by name, and an unknown name is refused.
    assert set(AGGREGATORS) == set(JAX_AGGREGATORS)
    assert build_aggregator("ubar", {"rho": 0.8}).name == "ubar"
    assert build_aggregator("evidential_trust", {}).name == "evidential_trust"
    with pytest.raises(ValueError, match="Unknown aggregation algorithm"):
        build_aggregator("no_such_rule", {})
