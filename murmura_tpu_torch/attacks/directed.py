"""Directed deviation attack (the PyTorch counterpart of
murmura_tpu/attacks/directed.py): compromised nodes broadcast
lambda * state (default lambda = -5.0: the opposite direction, amplified).

lambda is taken in the parameter dtype before the product, as ``jnp`` takes
a Python float, so a bfloat16 row is the same bits in both packages.
"""

import torch

from murmura_tpu_torch.attacks.base import Attack, check_rows, select_compromised


def make_directed_deviation_attack(
    num_nodes: int,
    attack_percentage: float,
    lambda_param: float = -5.0,
    seed: int = 42,
) -> Attack:
    compromised = select_compromised(num_nodes, attack_percentage, seed)

    def apply(flat, compromised_mask, generator=None, noise=None):
        check_rows("directed_deviation", flat, num_nodes)
        lam = torch.tensor(lambda_param, dtype=flat.dtype, device=flat.device)
        return torch.where(compromised_mask[:, None] > 0, lam * flat, flat)

    return Attack(name="directed_deviation", compromised=compromised, apply=apply)
