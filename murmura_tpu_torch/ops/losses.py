"""Masked cross-entropy (the PyTorch counterpart of murmura_tpu/ops/losses.py).

Padded batch slots carry mask 0 and contribute nothing to the means.
"""

from typing import Tuple

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
