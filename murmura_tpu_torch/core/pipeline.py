# Copy of PIPELINE_STATE_KEYS, pipeline_state_keys, init_pipeline_state and
# run_delayed_reference from murmura_tpu/core/pipeline.py.
"""Pipelined rounds: one-round-delayed aggregation riding the carried state.

Let ``Q_r`` be round r's locally trained (post-scrub) flat parameters and
``(B_r, A_r)`` the broadcast and adjacency round r *produces* (post-attack,
post-sentinel, post-codec, post-stale-fold: what the serialized round's
aggregation would consume).  Then

- serialized:  ``P_{r+1} = Agg(Q_r, B_r, A_r)`` (guards folded);
- pipelined:   ``P_{r+1} = Q_r + valid * (Agg(Q_{r-1}, B_{r-1}, A_{r-1})
  - Q_{r-1})``: round r trains while round r-1's buffered exchange is
  aggregated, and the displacement lands after training.

The double buffer rides ``agg_state`` under :data:`PIPELINE_STATE_KEYS`, so
fused dispatch and the run snapshot (durability/snapshot.py) carry it with
no special case: a resumed run aggregates the buffer it was stopped with.
Round 0 is the warm-up: the buffer starts invalid (``pipe_valid`` 0), its
placeholder aggregation runs (an all-ones off-diagonal graph over zeros,
finite for every rule) and its displacement and rule-state update are
discarded with ``torch.where``, never multiplied (0 * NaN = NaN).  There is
no drain round: the last round's exchange stays in the buffer.

The sentinels run at production time, before the buffer write, so a
quarantined or scrubbed row never enters the buffer.  With bounded
staleness armed the stale fold's payload cache already holds the post-fold
broadcast the buffer needs, so ``pipe_bcast`` is dropped and the round
reads ``stale_cache`` instead (:func:`pipeline_state_keys`).

In the port the round is eager PyTorch on one stream: the delayed
aggregation is issued before training in program order, but nothing
overlaps yet.
"""

from typing import Dict, Tuple

import numpy as np
import torch

ADJ_KEY = "pipe_adj"
BCAST_KEY = "pipe_bcast"
OWN_KEY = "pipe_own"
VALID_KEY = "pipe_valid"
# Reserved agg_state keys: carried by the round, never handed to the rule,
# registered in durability/snapshot.py's RESERVED_AGG_STATE_KEY_GROUPS.
PIPELINE_STATE_KEYS = (ADJ_KEY, BCAST_KEY, OWN_KEY, VALID_KEY)


def pipeline_state_keys(stale: bool) -> Tuple[str, ...]:
    """The PIPELINE_STATE_KEYS a build carries: without ``pipe_bcast``
    under bounded staleness, whose cache is the broadcast buffer."""
    if stale:
        return tuple(k for k in PIPELINE_STATE_KEYS if k != BCAST_KEY)
    return PIPELINE_STATE_KEYS


def init_pipeline_state(
    num_nodes: int, model_dim: int, dtype: torch.dtype, *, stale: bool = False,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """The invalid initial buffer: zero ``[N, P]`` rows in the parameter
    dtype, the dense all-ones off-diagonal ``[N, N]`` float32 adjacency and
    ``pipe_valid`` 0.  (The sparse ``[N, k]`` edge-mask form comes with the
    sparse topologies.)"""
    zeros = torch.zeros((num_nodes, model_dim), dtype=dtype, device=device)
    adj0 = (np.ones((num_nodes, num_nodes), np.float32)
            - np.eye(num_nodes, dtype=np.float32))
    state = {
        ADJ_KEY: torch.from_numpy(adj0).to(device),
        OWN_KEY: zeros,
        VALID_KEY: torch.zeros((), dtype=torch.float32, device=device),
    }
    if not stale:
        state[BCAST_KEY] = zeros.clone()
    return state


def run_delayed_reference(net, rounds: int, eval_every: int = 1):
    """Drive a SERIALIZED network's round program through the explicit
    one-round-delayed recursion and return ``(flat, history)``: the
    independent implementation the pipelined program must match bit for
    bit on the CPU.

    ``net`` is a :class:`~murmura_tpu_torch.core.network.Network` built
    without ``exchange.pipeline``.  Per round r:

    1. ``own_r = train_flat(P_r, ...)``: the trained post-scrub rows (a
       pure sub-computation of the serialized round);
    2. ``S_r, state' = train_step(P_r, state, ...)``: the whole serialized
       round, whose output is the guarded aggregation of round r's exchange
       and whose state update is the production sequence (codec residual,
       stale cache, rule state);
    3. ``P_{r+1} = own_r + disp``, the faulted builds' keep-mask applied as
       the pipelined combine applies it; ``disp`` then becomes
       ``S_r - own_r`` (zero before round 1).

    Each call draws from fresh generators of (seed, round), so the two
    calls see the same shuffle and noise.
    """
    from murmura_tpu_torch.core.network import (
        effective_adjacency,
        effective_alive,
        empty_history,
        record_round_metrics,
    )
    from murmura_tpu_torch.core.rounds import round_generators

    prog = net.program
    if prog.pipelined:
        raise ValueError(
            "run_delayed_reference drives the SERIALIZED round program through "
            "the delayed recursion; build the reference network without "
            "exchange.pipeline"
        )
    dev = prog.device
    flat = prog.init_flat
    agg_state = dict(prog.init_agg_state)
    comp = torch.as_tensor(net.compromised).to(dev)
    history = empty_history()
    disp = torch.zeros_like(flat)
    for r in range(rounds):
        adj = torch.as_tensor(effective_adjacency(net.topology, net.fault_schedule, r)).to(dev)
        alive = None
        if prog.faulted:
            alive = torch.as_tensor(effective_alive(net.fault_schedule, prog.num_nodes, r)).to(dev)
        own, train_ok = prog.train_flat(flat, agg_state, adj, comp, float(r),
                                        generators=round_generators(net.seed, r, dev),
                                        alive=alive)
        s_flat, agg_state, _ = prog.train_step(flat, agg_state, adj, comp, float(r),
                                               generators=round_generators(net.seed, r, dev),
                                               alive=alive)
        new_flat = own + disp
        if alive is not None:
            # Quarantine scrubbed own back to the pre-round rows and the
            # serialized keep-guard froze them; own equals the pre-round
            # value there, so the keep-mask discards the displacement.
            keep = (alive > 0) & (train_ok > 0)
            new_flat = torch.where(keep[:, None], new_flat, own)
        disp = s_flat - own
        flat = new_flat
        if (r + 1) % eval_every == 0:
            metrics = {k: v.cpu().numpy() for k, v in prog.eval_step(flat).items()}
            record_round_metrics(history, r + 1, metrics, net.compromised,
                                 prog.evidential, net.attack is not None)
    return flat, history
