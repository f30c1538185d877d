"""Gaussian noise attack (the PyTorch counterpart of
murmura_tpu/attacks/gaussian.py): compromised nodes broadcast
state + N(0, noise_std^2) noise.

Noise is drawn for the C compromised rows only, from a ``torch.Generator``
on the tensor's device.  ``noise`` injects a [C, P] standard-normal draw
instead (the RNG seam the tests use to feed the JAX package's draw).
"""

from typing import Optional

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import Attack, check_rows, select_compromised
from murmura_tpu_torch.ops.agg_kernels import _offsets_on


def make_gaussian_attack(
    num_nodes: int,
    attack_percentage: float,
    noise_std: float = 10.0,
    seed: int = 42,
) -> Attack:
    compromised = select_compromised(num_nodes, attack_percentage, seed)
    comp_idx = np.flatnonzero(compromised)

    def apply(
        flat: torch.Tensor,
        compromised_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        check_rows("gaussian", flat, num_nodes)
        if not len(comp_idx):
            return flat
        # A device copy made once, so that a round makes no host sync.
        idx = _offsets_on(tuple(comp_idx.tolist()), flat.device)
        shape = (len(comp_idx),) + tuple(flat.shape[1:])
        if noise is None:
            noise = torch.randn(
                shape, generator=generator, device=flat.device, dtype=torch.float32
            )
        noise = noise.to(torch.float32) * noise_std * compromised_mask[idx, None]
        out = flat.clone()
        out[idx] = (flat[idx].to(torch.float32) + noise).to(flat.dtype)
        return out

    return Attack(name="gaussian", compromised=compromised, apply=apply)
