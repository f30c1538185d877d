"""Graph topologies: the dense families and the sparse offset-list ones."""

from murmura_tpu_torch.topology.base import Topology
from murmura_tpu_torch.topology.generators import TOPOLOGY_TYPES, create_topology
from murmura_tpu_torch.topology.sparse import SparseTopology

__all__ = ["Topology", "SparseTopology", "create_topology", "TOPOLOGY_TYPES"]
