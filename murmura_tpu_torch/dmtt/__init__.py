"""DMTT, the dynamic-mobility topology trust protocol, as [N, N] tensor
transforms carried through the round (dmtt/protocol.py).  The ZMQ node
process of the JAX package's distributed backend is not ported."""

from murmura_tpu_torch.dmtt.protocol import (
    DMTTParams,
    collab_score,
    dmtt_round_update,
    init_dmtt_state,
    model_score,
    topo_trust,
)

__all__ = [
    "DMTTParams",
    "collab_score",
    "dmtt_round_update",
    "init_dmtt_state",
    "model_score",
    "topo_trust",
]
