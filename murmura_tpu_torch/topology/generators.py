# Copy of murmura_tpu/topology/generators.py.
"""Topology generators: ring, fully connected, seeded Erdős–Rényi with
isolated-node fixup, circulant k-regular (odd k bumped to k+1; k >= n
degenerates to fully connected), as dense adjacency matrices; and the
sparse offset-list families ``exponential`` and ``one_peer``, as
:class:`~murmura_tpu_torch.topology.sparse.SparseTopology` (the round
program then takes a [k, N] edge mask instead of the [N, N] adjacency).
"""

from typing import Optional

import numpy as np

from murmura_tpu_torch.topology.base import Topology
from murmura_tpu_torch.topology.sparse import SparseTopology, exponential_offsets

SPARSE_TOPOLOGY_TYPES = ("exponential", "one_peer")
TOPOLOGY_TYPES = ("ring", "fully", "erdos", "k-regular") + SPARSE_TOPOLOGY_TYPES


def create_topology(
    topology_type: str,
    num_nodes: int,
    p: Optional[float] = None,
    k: Optional[int] = None,
    seed: int = 12345,
    **_ignored,
) -> "Topology | SparseTopology":
    """Create a topology by name."""
    t = topology_type.lower()
    if t == "ring":
        return ring(num_nodes)
    if t in ("fully", "full"):
        return fully_connected(num_nodes)
    if t in ("erdos", "er", "erdos-renyi"):
        return erdos_renyi(num_nodes, 0.3 if p is None else p, seed)
    if t in ("k-regular", "kregular"):
        return k_regular(num_nodes, 4 if k is None else k)
    if t == "exponential":
        return exponential(num_nodes)
    if t in ("one_peer", "one-peer"):
        return one_peer(num_nodes)
    raise ValueError(f"Unknown topology type: {topology_type}")


def _circulant(n: int, offsets) -> np.ndarray:
    """Adjacency of a circulant graph: i ~ (i + o) mod n for each offset o."""
    idx = np.arange(n)
    adj = np.zeros((n, n), dtype=bool)
    for o in offsets:
        adj[idx, (idx + o) % n] = True
        adj[(idx + o) % n, idx] = True
    np.fill_diagonal(adj, False)
    return adj


def ring(n: int) -> Topology:
    """Ring: each node linked to its two cyclic neighbors."""
    return Topology(num_nodes=n, adjacency=_circulant(n, [1]))


def fully_connected(n: int) -> Topology:
    """Complete graph."""
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return Topology(num_nodes=n, adjacency=adj)


def erdos_renyi(n: int, p: float, seed: int = 12345) -> Topology:
    """Seeded ER graph; isolated node i is attached to (i+1) mod n."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"Edge probability p must be in [0, 1], got {p}")
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1)
    adj = adj | adj.T
    for i in range(n):
        if not adj[i].any():
            j = (i + 1) % n
            if i != j:
                adj[i, j] = adj[j, i] = True
    return Topology(num_nodes=n, adjacency=adj)


def exponential(n: int) -> SparseTopology:
    """Static exponential graph (arXiv:2110.13363): directed circulant with
    offsets ``2^i mod n``, degree O(log n), never ``[N, N]``."""
    return SparseTopology(num_nodes=n, offsets=exponential_offsets(n))


def one_peer(n: int) -> SparseTopology:
    """One-peer exponential graph: the offsets of :func:`exponential`, only
    offset ``t mod k`` active in round ``t`` (per-round degree 1), the
    activation carried by the edge mask's values."""
    return SparseTopology(num_nodes=n, offsets=exponential_offsets(n), schedule="one_peer")


def k_regular(n: int, k: int) -> Topology:
    """Circulant k-regular lattice: k/2 successors + k/2 predecessors."""
    if k % 2 != 0:
        k = k + 1
    if k >= n:
        return fully_connected(n)
    return Topology(num_nodes=n, adjacency=_circulant(n, range(1, k // 2 + 1)))
