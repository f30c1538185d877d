# Copy of murmura_tpu/topology/dynamic.py without its LEVER_MANIFEST block.
"""Deterministic random-walk mobility model for time-varying G^t
(reference: murmura/topology/dynamic.py:16-105).

Positions evolve by a bounded random step on a 2-D torus, lazily generated
from one seeded generator so every process — or every host feeding masks to
the jitted TPU round loop — reconstructs the identical G^t with zero
communication (reference: dynamic.py:1-8). Distance computation is
vectorized: one [N, N] torus-distance matrix per round instead of the
reference's per-pair Python loop (dynamic.py:68-72).
"""

from typing import Dict, List

import numpy as np


class MobilityModel:
    """Bounded random-walk mobility on a 2-D torus.

    Args:
        num_nodes: Number of mobile nodes.
        area_size: Side length of the square arena.
        comm_range: Edge (i,j) in G^t iff torus-dist(r_i, r_j) < comm_range.
        max_speed: Max displacement magnitude per round.
        seed: RNG seed for initial positions and movement.
        ensure_connected: Attach isolated nodes to their nearest peer.
    """

    def __init__(
        self,
        num_nodes: int,
        area_size: float = 100.0,
        comm_range: float = 30.0,
        max_speed: float = 5.0,
        seed: int = 42,
        ensure_connected: bool = True,
    ):
        self.num_nodes = num_nodes
        self.area_size = area_size
        self.comm_range = comm_range
        self.max_speed = max_speed
        self.ensure_connected = ensure_connected

        self._rng = np.random.default_rng(seed)
        pos0 = self._rng.uniform(0.0, area_size, size=(num_nodes, 2))
        self._positions: Dict[int, np.ndarray] = {0: pos0}

    def positions_at(self, round_idx: int) -> np.ndarray:
        """(N, 2) positions at round_idx (reference: dynamic.py:53-61)."""
        last = max(self._positions)
        for r in range(last, round_idx):
            delta = self._rng.uniform(
                -self.max_speed, self.max_speed, size=(self.num_nodes, 2)
            )
            self._positions[r + 1] = (self._positions[r] + delta) % self.area_size
        return self._positions[round_idx]

    def _torus_dist_matrix(self, pos: np.ndarray) -> np.ndarray:
        """Pairwise torus distances as one [N, N] array."""
        diff = np.abs(pos[:, None, :] - pos[None, :, :])  # [N, N, 2]
        diff = np.minimum(diff, self.area_size - diff)
        return np.sqrt((diff**2).sum(-1))

    def adjacency_at(self, round_idx: int) -> np.ndarray:
        """Dense boolean adjacency [N, N] of G^t — the round-step mask."""
        pos = self.positions_at(round_idx)
        dist = self._torus_dist_matrix(pos)
        adj = dist < self.comm_range
        np.fill_diagonal(adj, False)
        if self.ensure_connected:
            self._connect_isolated(adj, dist)
        return adj

    def neighbors_at(self, round_idx: int) -> Dict[int, List[int]]:
        """Adjacency-list view (reference: dynamic.py:63-77)."""
        adj = self.adjacency_at(round_idx)
        return {i: list(np.flatnonzero(adj[i])) for i in range(self.num_nodes)}

    def torus_dist(self, i: int, j: int, round_idx: int) -> float:
        """Torus distance between nodes i and j (reference: dynamic.py:79-82)."""
        pos = self.positions_at(round_idx)
        return float(self._torus_dist_matrix(pos)[i, j])

    def _connect_isolated(self, adj: np.ndarray, dist: np.ndarray) -> None:
        """Attach each isolated node to its nearest peer (reference: dynamic.py:95-105)."""
        n = self.num_nodes
        if n < 2:
            return
        d = dist + np.where(np.eye(n, dtype=bool), np.inf, 0.0)
        for i in range(n):
            if not adj[i].any():
                nearest = int(np.argmin(d[i]))
                adj[i, nearest] = adj[nearest, i] = True
