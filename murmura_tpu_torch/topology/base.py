# Copy of murmura_tpu/topology/base.py: the port imports nothing from the JAX package.
"""Topology type (reference: murmura/topology/base.py:7-60).

TPU-first design note: the primary representation here is the dense boolean
adjacency matrix ``adjacency[N, N]`` — that is the object the jitted round
step consumes directly as the neighbor mask of the all-gathered state tensor.
The reference's adjacency-list / edge-list views (base.py:17-19) are derived
properties kept for API parity.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Topology:
    """Undirected communication graph over ``num_nodes`` FL peers.

    Attributes:
        num_nodes: Number of nodes.
        adjacency: Dense boolean [N, N] matrix; ``adjacency[i, j]`` is True iff
            i and j exchange models. Symmetric with a False diagonal.
    """

    num_nodes: int
    adjacency: np.ndarray = field(repr=False)

    def __post_init__(self) -> None:
        adj = np.asarray(self.adjacency, dtype=bool)
        if adj.shape != (self.num_nodes, self.num_nodes):
            raise ValueError(
                f"adjacency shape {adj.shape} != ({self.num_nodes}, {self.num_nodes})"
            )
        if not np.array_equal(adj, adj.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        np.fill_diagonal(adj, False)
        self.adjacency = adj

    # -- reference-parity views (murmura/topology/base.py:17-19) ------------

    @property
    def neighbors(self) -> List[List[int]]:
        """Adjacency list: neighbors[i] = sorted list of i's neighbor ids."""
        return [list(np.flatnonzero(row)) for row in self.adjacency]

    @property
    def edges(self) -> List[Tuple[int, int]]:
        """Sorted undirected edge list as (lo, hi) pairs."""
        ii, jj = np.nonzero(np.triu(self.adjacency, k=1))
        return sorted(zip(ii.tolist(), jj.tolist()))

    def degree(self, node_id: int) -> int:
        """Degree of one node (reference: base.py:26-35)."""
        return int(self.adjacency[node_id].sum())

    def avg_degree(self) -> float:
        """Average degree (reference: base.py:37-39)."""
        return float(self.adjacency.sum()) / max(1, self.num_nodes)

    def is_connected(self) -> bool:
        """Connectivity via boolean matrix-power reachability (reference: base.py:41-60)."""
        if self.num_nodes == 0:
            return True
        reach = np.zeros(self.num_nodes, dtype=bool)
        reach[0] = True
        for _ in range(self.num_nodes):
            new = reach | (self.adjacency @ reach)
            if np.array_equal(new, reach):
                break
            reach = new
        return bool(reach.all())

    def mask(self, dtype=np.float32) -> np.ndarray:
        """Adjacency as a numeric mask for the jitted aggregation step."""
        return self.adjacency.astype(dtype)

    def circulant_offsets(self) -> "List[int] | None":
        """Non-zero offsets o with adjacency[i, (i+o) % N] True for all i,
        or None if the graph is not circulant.

        Ring and k-regular graphs are generated as circulants; on such
        graphs the neighbor exchange can be a sum of fixed circular shifts
        (tpu.exchange: ppermute) instead of an adjacency matmul.
        """
        n = self.num_nodes
        if n == 0:
            return []
        offsets = [int(o) for o in np.flatnonzero(self.adjacency[0])]
        expected = np.zeros_like(self.adjacency)
        cols = (np.arange(n)[:, None] + np.array(offsets, dtype=int)[None, :]) % n
        expected[np.arange(n)[:, None], cols] = True
        if np.array_equal(expected, self.adjacency):
            return offsets
        return None

    @classmethod
    def from_neighbors(cls, num_nodes: int, neighbors: List[List[int]]) -> "Topology":
        """Build from an adjacency list (reference-style constructor)."""
        adj = np.zeros((num_nodes, num_nodes), dtype=bool)
        for i, ns in enumerate(neighbors):
            for j in ns:
                adj[i, j] = True
                adj[j, i] = True
        return cls(num_nodes=num_nodes, adjacency=adj)
