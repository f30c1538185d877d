"""DMTT, the dynamic-mobility topology trust protocol, as [N, N] tensor
transforms carried through the round (dmtt/protocol.py), and the ZMQ
backend's DMTT node process (dmtt/node_process.py, imported where it is
run)."""

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
