"""Losses and evidential uncertainty (the PyTorch counterpart of
murmura_tpu/ops/losses.py).

- masked cross-entropy;
- the evidential loss: Sensoy et al.'s MSE plus the annealed
  KL(Dir(alpha~) || Dir(1));
- the Dirichlet uncertainty metrics (vacuity, entropy, strength) of the
  evidential evaluation.

Padded batch slots carry mask 0 and contribute nothing to the means.
"""

from typing import Dict, Tuple

import torch


def _safe_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE loss and accuracy over valid samples.

    Args:
        logits: [B, K] unnormalized scores.
        labels: [B] int64 class ids.
        mask: [B] validity (0/1).
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
    loss = _safe_mean(nll, mask)
    acc = _safe_mean((torch.argmax(logits, -1) == labels).to(logits.dtype), mask)
    return loss, acc


def uncertainty_metrics(alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Dirichlet uncertainty of [..., K] alphas: per-sample ``probs``
    [..., K], ``vacuity`` K / S, ``entropy`` of the expected probabilities
    and ``strength`` S = sum(alpha)."""
    s = alpha.sum(-1, keepdim=True)
    k = alpha.shape[-1]
    probs = alpha / s
    return {
        "probs": probs,
        "vacuity": k / s[..., 0],
        "entropy": -(probs * torch.log(probs + 1e-10)).sum(-1),
        "strength": s[..., 0],
    }


def evidential_loss(
    alpha: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    num_classes: int,
    lambda_t: float,
) -> torch.Tensor:
    """mean_b[sum_k (y - p)^2] + lambda_t * mean_b[KL(Dir(alpha~) || Dir(1))],
    where alpha~ removes the evidence of the true class and ``lambda_t`` is
    the annealing coefficient already scaled by its weight."""
    # one_hot's range check reads the labels, which vmap does not allow.
    classes = torch.arange(num_classes, device=labels.device)
    y = (labels[..., None] == classes).to(alpha.dtype)
    p = alpha / alpha.sum(-1, keepdim=True)
    mse = ((y - p) ** 2).sum(-1)
    kl = _kl_dirichlet_to_uniform(y + (1.0 - y) * alpha)
    return _safe_mean(mse, mask) + lambda_t * _safe_mean(kl, mask)


def _kl_dirichlet_to_uniform(alpha: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(Dir(alpha) || Dir(1))."""
    k = alpha.shape[-1]
    sum_alpha = alpha.sum(-1)
    return (
        torch.lgamma(sum_alpha)
        - torch.lgamma(torch.tensor(float(k), dtype=alpha.dtype, device=alpha.device))
        - torch.lgamma(alpha).sum(-1)
        + ((alpha - 1.0) * (torch.digamma(alpha) - torch.digamma(sum_alpha)[..., None])).sum(-1)
    )
