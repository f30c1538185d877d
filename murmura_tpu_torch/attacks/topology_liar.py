"""Topology liar attack for DMTT (the PyTorch counterpart of
murmura_tpu/attacks/topology_liar.py).

Liars may poison their broadcast through a wrapped inner attack and
falsify their TOPO_CLAIM: the claimed neighbour set is the true G^t
neighbours united with every other compromised node, which inflates the
apparent connectivity of the Byzantine coalition.
"""

from typing import Optional

import numpy as np
import torch

from murmura_tpu_torch.attacks.base import Attack, select_compromised


def false_claims(true_adj: torch.Tensor, compromised_mask: torch.Tensor) -> torch.Tensor:
    """Claimed adjacency [N, N], row i node i's TOPO_CLAIM: honest rows
    equal the true adjacency, liar rows add every other compromised node."""
    comp = compromised_mask > 0
    eye = torch.eye(true_adj.shape[0], dtype=torch.bool, device=true_adj.device)
    coalition = comp[None, :] & comp[:, None] & ~eye
    liar_rows = (true_adj > 0) | coalition
    return torch.where(comp[:, None], liar_rows, true_adj > 0).to(true_adj.dtype)


def make_topology_liar_attack(
    num_nodes: int,
    attack_percentage: float,
    seed: int = 42,
    model_attack: Optional[Attack] = None,
) -> Attack:
    compromised = select_compromised(num_nodes, attack_percentage, seed)
    if model_attack is not None and not np.array_equal(model_attack.compromised, compromised):
        # The inner attack poisons the rows of ITS compromised set; another
        # selection would leave some liars unpoisoned.
        raise ValueError(
            "topology_liar's wrapped model_attack selected a different "
            "compromised set; build the inner attack with the same "
            "num_nodes/attack_percentage/seed"
        )

    def apply(flat, compromised_mask, generator=None, noise=None):  # murmura: traced
        """The wrapped inner attack's broadcast; pure liars broadcast their
        honest states."""
        if model_attack is None:
            return flat
        return model_attack.apply(flat, compromised_mask, generator, noise=noise)

    return Attack(name="topology_liar", compromised=compromised, apply=apply,
                  claims_fn=false_claims)
