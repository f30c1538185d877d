"""Gaussian noise attack (the PyTorch counterpart of
murmura_tpu/attacks/gaussian.py): compromised nodes broadcast
state + N(0, noise_std^2) noise.

Noise is drawn for the C compromised rows only, from a ``torch.Generator``
on the tensor's device.  ``noise`` injects a [C, P] standard-normal draw
instead (the RNG seam the tests use to feed the JAX package's draw).  One
node's [1, P] view (the ZMQ backend's node process) takes a [1, P] draw
and is perturbed where its mask is set.
Under a param group the draw (or the injected noise) is the whole width's,
cut to the rank's column block, so that it keeps the unsharded run's bits;
under a node scope (parallel/mesh.py) the [C, P] draw is taken whole too,
and only the rows of the rank's compromised nodes are added to its block.
"""

from typing import Optional

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import Attack, check_rows, select_compromised
from murmura_tpu_torch.ops.agg_kernels import _offsets_on
from murmura_tpu_torch.parallel.mesh import active_node_group, full_width, local_columns


def make_gaussian_attack(
    num_nodes: int,
    attack_percentage: float,
    noise_std: float = 10.0,
    seed: int = 42,
) -> Attack:
    compromised = select_compromised(num_nodes, attack_percentage, seed)
    comp_idx = np.flatnonzero(compromised)

    def apply(  # murmura: traced
        flat: torch.Tensor,
        compromised_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if check_rows("gaussian", flat, num_nodes):  # murmura: ignore[MUR001] check_rows reads flat.shape only
            if noise is None:
                noise = torch.randn(flat.shape, generator=generator, device=flat.device,
                                    dtype=torch.float32)
            noise = torch.as_tensor(noise).to(flat.device, torch.float32) * noise_std
            return torch.where(compromised_mask[:, None] > 0,
                               (flat.to(torch.float32) + noise).to(flat.dtype), flat)
        if not len(comp_idx):
            return flat
        # A device copy made once, so that a round makes no host sync.
        idx = _offsets_on(tuple(comp_idx.tolist()), flat.device)
        shape = (len(comp_idx), full_width(flat.shape[1]))
        if noise is None:
            noise = torch.randn(
                shape, generator=generator, device=flat.device, dtype=torch.float32
            )
        noise = local_columns(noise).to(torch.float32) * noise_std * compromised_mask[idx, None]
        group = active_node_group()
        if group is not None:
            # The block's compromised rows and their rows of the whole draw.
            lo, hi = group.rows
            mine = [c for c, i in enumerate(comp_idx) if lo <= i < hi]
            if not mine:
                return flat
            noise = noise[_offsets_on(tuple(mine), flat.device)]
            idx = _offsets_on(tuple(int(comp_idx[c]) - lo for c in mine), flat.device)
        out = flat.clone()
        out[idx] = (flat[idx].to(torch.float32) + noise).to(flat.dtype)
        return out

    return Attack(name="gaussian", compromised=compromised, apply=apply)
