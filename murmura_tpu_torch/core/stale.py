# Copy of murmura_tpu/core/stale.py without its LEVER_MANIFEST block.
"""Bounded-staleness gossip: the stale-tolerant exchange layer.

Without it a neighbour whose payload misses the round (a straggler, a
crashed node, a dropped link) is masked out of the adjacency.  With it a
receiver may aggregate that neighbour's round-``(r - a)`` payload for small
``a`` instead of dropping the edge.

The payload cache rides the round program's carried state under the
reserved :data:`STALE_STATE_KEYS` (the ``COMPRESS_STATE_KEYS`` pattern), so
fused chunks carry it with no special case:

- ``stale_cache`` [N, P] holds each sender's last broadcast that was
  **delivered** (it cleared the NaN/attack sentinels and reached at least
  one live receiver); ``stale_age`` [N] counts the rounds since.
- A sender whose round-``r`` payload is not delivered has its base-graph
  in-edges re-added with weight ``discount ** age`` for every eligible
  receiver, provided the cached payload is no older than ``max_staleness``
  and the sender was not scrubbed or quarantined this round (a caught row
  must not survive through its cached copy).
- Ages past ``max_staleness`` degrade to dropping the edge.

The cache is sender-granular: delivery is inferred from the folded
adjacency (a sender with no live out-edge did not deliver), so a
link-dropped edge of a sender that still reached someone stays dropped.

Mean-family rules (fedavg, the BALANCE/UBAR blends, evidential trust) use
the fractional re-added weight; selection rules (Krum, median, trimmed
mean) treat any positive weight as a full candidate.  The weights reach
the rule unchanged, never binarised.

In sparse mode (a sparse topology, topology/sparse.py) the adjacency is
the [k, N] edge mask and the base graph the all-active [k, N] mask of the
static exponential family; every step runs on [N] node flags rolled onto
the offsets, never on an [N, N] matrix.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Reserved round-program-level agg_state keys: carried by the round step
# but never handed to the aggregation rule's state dict.
CACHE_KEY = "stale_cache"
AGE_KEY = "stale_age"
STALE_STATE_KEYS = (AGE_KEY, CACHE_KEY)


@dataclass(frozen=True)
class StalenessSpec:
    """Bounded-staleness spec (config: ``exchange:``).

    ``base_mask`` is the unfaulted exchange graph the re-added edges are
    drawn from: the static [N, N] topology mask, zero diagonal, or the
    all-active [k, N] edge mask of a sparse topology.
    """

    max_staleness: int
    discount: float = 1.0
    base_mask: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        if self.max_staleness < 1:
            raise ValueError(
                f"max_staleness must be >= 1 to arm the stale exchange "
                f"(0 disables it at the config layer), got "
                f"{self.max_staleness}"
            )
        if not 0.0 < self.discount <= 1.0:
            raise ValueError(
                f"staleness_discount must be in (0, 1], got {self.discount}"
            )

    @property
    def age_cap(self) -> float:
        """Saturation value of the age counter: one past the bound is
        already expired, so ages stay small exact integers in float32."""
        return float(self.max_staleness + 1)


def init_stale_state(
    spec: StalenessSpec, num_nodes: int, model_dim: int, dtype, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Initial ``agg_state`` entries of a stale-enabled program: an empty
    (zero) cache with every age at the expired sentinel ``max_staleness +
    1``, so an edge disrupted before its sender ever delivered is dropped
    (round 0 has no payload to replay)."""
    return {
        CACHE_KEY: torch.zeros((num_nodes, model_dim), dtype=dtype, device=device),
        AGE_KEY: torch.full((num_nodes,), spec.age_cap, dtype=torch.float32, device=device),
    }


def make_stale_fold(spec: StalenessSpec, sparse_offsets: Tuple[int, ...] = (),
                    audit: bool = False, device="cpu"):
    """The staleness fold of one round program on ``device``; with
    ``sparse_offsets``, of a sparse program (the [k, N] edge mask).

    ``audit`` (telemetry.audit_taps) also emits the per-node
    ``tap_stale_used`` / ``tap_stale_age`` stats.

    Returns ``fold(bcast, adj, state, recv_ok, scrub_ok) -> (bcast_eff,
    adj_eff, state_updates, stats)`` where ``bcast`` is the round's
    exchanged [N, P] tensor (post-attack, post-sentinel, post-codec: finite);
    ``adj`` the fully folded [N, N] adjacency ([k, N] edge mask in sparse
    mode); ``state`` the
    :data:`STALE_STATE_KEYS` entries; ``recv_ok`` the [N] receiver
    eligibility (alive and not quarantined: re-added edges mirror the fresh
    folds' receiver side); ``scrub_ok`` the [N] product of this round's
    sender sentinel verdicts (0 = quarantined or attack-scrubbed), the gate
    that withholds a caught row's cached copy.

    Every step is elementwise over [N] / [N, N] tensors plus one column sum
    (dense), or rolls of [N] rows onto the offsets (sparse): nothing
    synchronises with the host.
    """
    sparse_offsets = tuple(int(o) for o in sparse_offsets)
    sparse = bool(sparse_offsets)
    base = np.asarray(spec.base_mask, dtype=np.float32)
    if sparse:
        if base.ndim != 2 or base.shape[0] != len(sparse_offsets):
            raise ValueError(
                f"sparse staleness base mask must be [k, N] with k = "
                f"{len(sparse_offsets)} offsets, got {base.shape}"
            )
    else:
        if base.ndim != 2 or base.shape[0] != base.shape[1]:
            raise ValueError(
                f"dense staleness base mask must be square [N, N], got {base.shape}")
        if np.diagonal(base).any():
            raise ValueError(
                "dense staleness base mask must have a zero diagonal "
                "(re-added edges must never include self-loops)"
            )
    # On the device once: a copy a round would synchronise a fused chunk.
    base_c = torch.from_numpy(base).to(device)
    max_staleness = float(spec.max_staleness)
    age_cap = spec.age_cap
    discount = float(spec.discount)
    # log(discount) from the host in float64, rounded to float32 once: age
    # (a small integer) times it is then one float32 rounding on every
    # device and in either package.
    log_discount = float(np.float32(np.log(discount))) if discount < 1.0 else 0.0

    def sender_view(vec):
        """[k, N]: row j holds vec[(i + offsets[j]) % N] at column i."""
        return torch.stack([torch.roll(vec, -o) for o in sparse_offsets])

    def sender_out_degree(adj):
        """[N] live out-edges of each sender: column sums, or the [k, N]
        rows rolled back onto the sender index."""
        if sparse:
            return sum(torch.roll(adj[j].to(torch.float32), o)
                       for j, o in enumerate(sparse_offsets))
        return adj.sum(dim=0)

    def fold(bcast, adj, state, recv_ok, scrub_ok):
        n = recv_ok.shape[0]
        if base_c.shape[-1] != n:
            raise ValueError(
                f"staleness base mask covers {base_c.shape[-1]} nodes "
                f"but this program's node axis is {n}"
            )
        cache = state[CACHE_KEY]
        age = state[AGE_KEY].to(torch.float32)

        # Delivery: a sender with at least one live out-edge put its payload
        # in the network this round; a zeroed column means straggle, death,
        # quarantine, scrub or total link isolation.
        deliver = (sender_out_degree(adj) > 0).to(torch.float32)
        age_new = torch.where(
            deliver > 0, torch.zeros_like(age), torch.clamp(age + 1.0, max=age_cap)
        )
        # Usable = stale AND within the bound AND not caught this round.
        usable = (1.0 - deliver) * scrub_ok * (age_new <= max_staleness).to(torch.float32)
        if discount < 1.0:
            w_sender = usable * torch.exp(age_new * log_discount)
        else:
            w_sender = usable

        # Re-added edges: base-graph in-edges of stale senders, gated by the
        # receiver.  A delivering sender's column carries w_sender = 0, so
        # no live edge is counted twice.
        if sparse:
            readd = base_c * recv_ok[None, :] * sender_view(w_sender)
        else:
            readd = base_c * recv_ok[:, None] * w_sender[None, :]
        adj_eff = adj + readd

        # One payload version a sender: fresh rows pass, stale rows take the
        # cached copy; the cache then holds exactly what receivers could
        # aggregate this round.
        fresh = deliver[:, None] > 0
        bcast_eff = torch.where(fresh, bcast, cache.to(bcast.dtype))
        updates = {CACHE_KEY: bcast_eff.to(cache.dtype), AGE_KEY: age_new}

        used = (readd > 0).to(torch.float32)
        # "Expired" counts age expiry only (a round-0 cold cache reads as
        # infinitely old); a scrub-withheld sender is not expired.
        expired = (1.0 - deliver) * scrub_ok * (age_new > max_staleness).to(torch.float32)
        if sparse:
            used_in = used.sum(dim=0)  # stale in-edges of each receiver
            expired_edges = base_c * recv_ok[None, :] * sender_view(expired)
        else:
            used_in = used.sum(dim=1)
            expired_edges = base_c * recv_ok[:, None] * expired[None, :]
        stats = {
            "stale_used": used.sum(),
            "stale_expired": (expired_edges > 0).to(torch.float32).sum(),
        }
        if audit:
            # Which receivers aggregated stale rows, and how old each served
            # sender's payload was (0 = fresh or not served: a usable cache
            # that no eligible receiver took was not served).
            served = (sender_out_degree(used) > 0).to(torch.float32)
            stats["tap_stale_used"] = used_in
            stats["tap_stale_age"] = age_new * usable * served
        return bcast_eff, adj_eff, updates, stats

    return fold
