"""Graph topologies: the dense families of the JAX package."""

from murmura_tpu_torch.topology.base import Topology
from murmura_tpu_torch.topology.generators import TOPOLOGY_TYPES, create_topology

__all__ = ["Topology", "create_topology", "TOPOLOGY_TYPES"]
