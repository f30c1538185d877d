"""Cross-evaluation of the nodes' models on the nodes' probe batches (the
PyTorch counterpart of murmura_tpu/aggregation/probe.py).

"Evaluate model j on node i's data" is a batched forward: one model at a
time over every node's probe batch at once ([N*B] samples), so memory
stays at O(N * B * K) a step and no [N, N*B, ...] activation exists.
``combined_probe_metric`` emits every probe consumer's metrics from one
cross-evaluation, which a DMTT round computes once and hands to the probe
rules (``AggContext.probe_cross``).
"""

from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch.func import vmap

from murmura_tpu_torch.aggregation.base import AggContext
from murmura_tpu_torch.ops.losses import uncertainty_metrics

MetricFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]


@torch.no_grad()
def pairwise_probe_eval(
    flat: torch.Tensor, ctx: AggContext, metric_fn: MetricFn
) -> Dict[str, torch.Tensor]:
    """[N, N] metrics: entry [i, j] is model j (row j of ``flat`` [N, P]) on
    node i's probe batch.  The models run one after another.

    ``probe_x`` may carry a leading dim of 1: a single evaluator whose
    metric row is broadcast to every row.  The ZMQ backend's LocalNode
    (distributed/local.py) uses it: its mini network consumes row 0 only,
    so one probe batch a model (O(M) forwards) replaces the M x M
    cross-evaluation and gives the same rows."""
    n = flat.shape[0]
    n_eval, b = ctx.probe_x.shape[:2]
    xs = ctx.probe_x.reshape((n_eval * b,) + tuple(ctx.probe_x.shape[2:]))
    per_j = []
    for j in range(n):
        outputs = ctx.apply_fn(ctx.unravel(flat[j]), xs).reshape(n_eval, b, -1)
        per_j.append(vmap(metric_fn)(outputs, ctx.probe_y, ctx.probe_mask))
    out = {k: torch.stack([m[k] for m in per_j], dim=1) for k in per_j[0]}
    return {k: v.expand(n, n) for k, v in out.items()} if n_eval == 1 else out


@torch.no_grad()
def circulant_probe_eval(
    bcast: torch.Tensor, offsets: Sequence[int], ctx: AggContext, metric_fn: MetricFn
) -> Dict[str, torch.Tensor]:
    """[k, N] metrics: entry [o, i] is the model of node (i + offsets[o]) % N
    on node i's probe batch (k x N forwards instead of N x N).  The offsets
    run one after another, each on one rolled [N, P] copy of ``bcast``,
    which is freed before the next is made."""
    if not offsets:
        raise ValueError(
            "circulant_probe_eval needs at least one offset: an empty "
            "offset list means a circulant graph with no neighbors"
        )
    n = bcast.shape[0]

    def one(params_i, x_i, y_i, m_i):
        return metric_fn(ctx.apply_fn(params_i, x_i), y_i, m_i)

    per_offset = []
    for o in offsets:
        idx = torch.from_numpy(np.roll(np.arange(n), -int(o))).to(bcast.device)
        rolled = bcast.index_select(0, idx)
        per_offset.append(
            vmap(one)(ctx.unravel(rolled), ctx.probe_x, ctx.probe_y, ctx.probe_mask)
        )
        del rolled
    return {k: torch.stack([m[k] for m in per_offset]) for k in per_offset[0]}


def ce_loss_metric(outputs, y, mask) -> Dict[str, torch.Tensor]:
    """Masked mean cross-entropy (UBAR's stage-2 probe), log-softmax in
    float32."""
    logp = torch.log_softmax(outputs.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, y[:, None])[:, 0]
    return {"loss": (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)}


def accuracy_vacuity_metric(outputs, y, mask) -> Dict[str, torch.Tensor]:
    """Masked accuracy and zero vacuity (a softmax model's DMTT score)."""
    denom = torch.clamp(mask.sum(), min=1.0)
    acc = ((torch.argmax(outputs, -1) == y).to(torch.float32) * mask).sum() / denom
    return {"accuracy": acc, "vacuity": torch.zeros_like(acc)}


def evidential_trust_metric(outputs, y, mask) -> Dict[str, torch.Tensor]:
    """Masked means over a probe batch of Dirichlet alphas [B, K], in
    float32: accuracy and the uncertainty metrics (vacuity K / S, entropy
    of the normalised alphas, strength S)."""
    alpha = outputs.to(torch.float32)
    unc = uncertainty_metrics(alpha)
    denom = torch.clamp(mask.sum(), min=1.0)

    def mean(values):
        return (values * mask).sum() / denom

    return {
        "accuracy": mean((torch.argmax(alpha, -1) == y).to(torch.float32)),
        "vacuity": mean(unc["vacuity"]),
        "entropy": mean(unc["entropy"]),
        "strength": mean(unc["strength"]),
    }


def combined_probe_metric(evidential: bool) -> MetricFn:
    """One metric for every probe consumer of a round, so that the [N, N]
    cross-evaluation runs once: DMTT's model score reads accuracy and
    vacuity, UBAR's stage 2 the loss, evidential trust vacuity, entropy and
    strength.  The forwards dominate; the extra reductions cost little."""
    base = evidential_trust_metric if evidential else accuracy_vacuity_metric

    def metric(outputs, y, mask):
        return {**base(outputs, y, mask), **ce_loss_metric(outputs, y, mask)}

    return metric
