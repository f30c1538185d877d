# Copy of murmura_tpu/topology/sparse.py without its LEVER_MANIFEST block.
"""Sparse circulant topologies: the degree-O(log N) exchange engine.

Every aggregation path in the repo historically consumed a dense boolean
``[N, N]`` adjacency (topology/base.py) — either directly (the gathered
dense rules) or as an ignored companion of a static circulant offset list
(``tpu.exchange: ppermute``).  :class:`SparseTopology` replaces the dense
object for large-N graphs: a directed circulant graph represented purely by
its **offset list** — node ``i`` receives from ``(i + o) % N`` for each
offset ``o`` — plus a per-round ``[k, N]`` *edge mask* saying which of
those edges are active this round.  Nothing O(N²) is ever materialized on
the sparse path: the round program takes the ``[k, N]`` mask where the
dense path takes the ``[N, N]`` adjacency.

Two generator families ride on it (topology/generators.py):

- ``exponential`` (arXiv:2110.13363): static offsets ``2^i mod N`` for
  ``i in [0, ceil(log2 N))`` — degree O(log N), diameter O(log N), and the
  spectral gap that makes decentralized SGD converge at near-dense rates.
- ``one_peer``: the same offset set but only ONE offset active per round
  (``offsets[t mod k]``) — degree 1 per round, cycling through the
  exponential offsets.  The program carries all k offsets; the per-round
  activation arrives as edge-mask **values**, so the round program is the
  same every round.

The edge mask composes multiplicatively with the fault model exactly like
the dense adjacency does (``FaultSchedule.masked_edge_mask``): masks may
only remove edges, never add them.
"""

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


def exponential_offsets(n: int, horizon: "int | None" = None) -> Tuple[int, ...]:
    """Exponential-graph offsets ``2^i mod n`` for ``i in [0, horizon)``.

    ``horizon`` defaults to ``ceil(log2 n)`` — the arXiv:2110.13363
    construction.  At non-power-of-two ``n`` the raw sequence can collide
    (``2^i ≡ 2^j mod n``) once the horizon exceeds the default, and at
    power-of-two ``n`` an over-long horizon degenerates to offset 0
    (``2^i ≡ 0 mod n`` — a self-loop, which every aggregation neighbor
    mask in the repo assumes away).  Collisions are deduped; offset 0 is
    rejected loudly instead of silently emitting a self-loop graph.
    """
    if n < 2:
        raise ValueError(
            f"exponential offsets need num_nodes >= 2, got {n} (a "
            "1-node graph has no nonzero circulant offset)"
        )
    if horizon is None:
        horizon = max(1, math.ceil(math.log2(n)))
    raw = [pow(2, i, n) for i in range(horizon)]
    if 0 in raw:
        i = raw.index(0)
        raise ValueError(
            f"exponential offset 2^{i} mod {n} == 0 — a degenerate "
            "self-loop offset (horizon exceeds log2(n) at a power-of-two "
            "n); shrink the horizon"
        )
    # Dedupe, ascending: at non-power-of-two n an over-long horizon makes
    # 2^i mod n revisit earlier offsets; a duplicated offset would
    # double-count that neighbor in every weighted circulant kernel.
    return tuple(sorted(set(raw)))


@dataclass
class SparseTopology:
    """Directed circulant graph held as an offset list (never ``[N, N]``).

    Attributes:
        num_nodes: N.
        offsets: nonzero circulant offsets, deduped ascending; node ``i``
            receives from ``(i + o) % N`` for each offset ``o``.
        schedule: ``"static"`` (all offsets active every round) or
            ``"one_peer"`` (offset ``t mod k`` active in round ``t``).
    """

    num_nodes: int
    offsets: Tuple[int, ...]
    schedule: str = "static"

    def __post_init__(self) -> None:
        n = self.num_nodes
        if n < 2:
            raise ValueError(f"SparseTopology needs num_nodes >= 2, got {n}")
        offs = [int(o) % n for o in self.offsets]
        if any(o == 0 for o in offs):
            raise ValueError(
                f"SparseTopology offsets {tuple(self.offsets)} contain a "
                f"zero (mod {n}) offset — a self-loop every aggregation "
                "neighbor mask assumes away; drop it"
            )
        deduped = tuple(sorted(set(offs)))
        if len(deduped) != len(offs):
            raise ValueError(
                f"SparseTopology offsets {tuple(self.offsets)} collide mod "
                f"{n} (deduped: {deduped}) — a duplicated offset double-"
                "counts that neighbor in every weighted circulant kernel; "
                "pass the deduped list"
            )
        if not deduped:
            raise ValueError("SparseTopology needs at least one offset")
        if self.schedule not in ("static", "one_peer"):
            raise ValueError(
                f"unknown SparseTopology schedule {self.schedule!r} "
                "(expected 'static' or 'one_peer')"
            )
        self.offsets = deduped

    # -- sparse-native views ------------------------------------------------

    @property
    def degree(self) -> int:
        """Static in-degree k (per-round degree is 1 under one_peer)."""
        return len(self.offsets)

    def edge_mask(self, round_idx: int = 0) -> np.ndarray:
        """[k, N] float32 active-edge mask for one round.

        ``mask[j, i] == 1`` iff edge ``i <- (i + offsets[j]) % N`` is
        active.  Static schedules are all-ones; ``one_peer`` activates the
        single row ``round_idx % k``.  This is the sparse twin of
        ``Topology.mask()`` — the object the compiled round program takes
        as its adjacency input.
        """
        k = len(self.offsets)
        if self.schedule == "one_peer":
            mask = np.zeros((k, self.num_nodes), dtype=np.float32)
            mask[round_idx % k] = 1.0
            return mask
        return np.ones((k, self.num_nodes), dtype=np.float32)

    def in_degree_from_edge_mask(self, edge_mask: np.ndarray) -> np.ndarray:
        """[N] host-side sender in-degree under an edge mask: how many
        receivers will read node s's broadcast this round (the telemetry
        round-event signal the dense path gets from ``adj.sum(axis=0)``)."""
        deg = np.zeros(self.num_nodes, dtype=np.float32)
        for j, o in enumerate(self.offsets):
            # receiver i reads sender (i + o) % N => sender s is read by
            # receiver (s - o) % N.
            deg += np.roll(np.asarray(edge_mask[j], np.float32), o)
        return deg

    # -- dense-compat views (parity tests, contracts, small N only) ---------

    @property
    def adjacency(self) -> np.ndarray:
        """Dense directed bool view (receiver rows) — for small-N parity
        tests, never the round path."""
        n = self.num_nodes
        adj = np.zeros((n, n), dtype=bool)
        idx = np.arange(n)
        for o in self.offsets:
            adj[idx, (idx + o) % n] = True
        return adj

    def mask(self, dtype=np.float32) -> np.ndarray:
        """Dense directed numeric mask (see :attr:`adjacency`)."""
        return self.adjacency.astype(dtype)

    def circulant_offsets(self) -> List[int]:
        """Interface parity with :meth:`Topology.circulant_offsets`."""
        return list(self.offsets)

    @property
    def neighbors(self) -> List[List[int]]:
        """Receiver-side adjacency list (API parity with Topology)."""
        n = self.num_nodes
        return [sorted((i + o) % n for o in self.offsets) for i in range(n)]

    def is_connected(self) -> bool:
        """Strong connectivity of a directed circulant:
        gcd(n, offsets...) == 1."""
        g = self.num_nodes
        for o in self.offsets:
            g = math.gcd(g, o)
        return g == 1
