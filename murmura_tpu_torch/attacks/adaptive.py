"""Closed-loop (adaptive) attacks: the PyTorch counterpart of
murmura_tpu/attacks/adaptive.py.

A static attack closes over one strength for the whole run.  An adaptive
attack carries per-node state in ``agg_state`` under the reserved
:data:`ATTACK_STATE_KEYS` (registered in durability/snapshot.py, so a
resumed run restores the attacker mid-bisection) and, each round, reads
the acceptance signal the rule itself emitted for its compromised rows
(the audit taps ``tap_selected_by`` / ``tap_considered_by``, which the
round turns on for an adaptive attack) to set the next round's strength.

- **adaptive ALIE** (:func:`make_adaptive_alie_attack`): the deviation
  factor ``z`` walks multiplicatively, up by ``1 + eta`` on an accepted
  round, down by ``1 - eta`` on a rejected one, clamped to
  ``[z_min, z_cap]``.
- **adaptive IPM** (:func:`make_adaptive_ipm_attack`): the negation factor
  ``epsilon`` takes the same walk.
- **scale bisection** (:func:`make_bisection_attack`): wraps any static
  broadcast attack; the broadcast becomes ``own + scale * (attacked -
  own)``, and ``scale`` grows geometrically until a rejection pins the
  bracket ``[atk_lo, atk_hi]``, then bisects it.

Rules without selection taps (fedavg, the median, the trimmed mean, the
geometric median, Sketchguard) give the attacker only the fault sentinel's
scrub and quarantine flags, else a constant "accepted".  A scrubbed or
quarantined compromised row counts as rejected; a dead row (``alive`` 0)
is not an observation and its state stays frozen.  Every update is
elementwise over the [N] node rows.  Over a node group the state stays the
whole [N] on every rank (its inputs, the sender-side taps and the fault
flags, are whole there), so a rank's snapshot is one process's; a rank
applies its block's rows of it.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from murmura_tpu_torch.attacks.alie import make_alie_attack, resolve_alie_z
from murmura_tpu_torch.attacks.base import Attack, check_rows, coalition_stats, honest_mean
from murmura_tpu_torch.attacks.ipm import make_ipm_attack, resolve_ipm_epsilon
from murmura_tpu_torch.parallel.mesh import node_rows

# The per-node [N] float32 rows an adaptive attack carries in agg_state.
# Every adaptive attack's state keys are drawn from this tuple, and together
# they cover it.
ATTACK_STATE_KEYS = (
    "atk_accept_ema",  # EMA of the row's acceptance fraction
    "atk_eps",         # adaptive IPM: the current negation factor epsilon
    "atk_hi",          # bisection: the smallest strength observed rejected
    "atk_lo",          # bisection: the largest strength observed accepted
    "atk_scale",       # bisection: the strength probed next round
    "atk_z",           # adaptive ALIE: the current deviation factor z
)


@dataclass(frozen=True)
class AdaptiveAttack(Attack):
    """A closed-loop attack: the static :class:`Attack` plus its state.
    ``apply`` stays the initial-strength static transform; the round calls
    ``apply_adaptive`` instead.

    ``init_attack_state(n) -> {key: [n] float32}``;
    ``apply_adaptive(flat, compromised, generator, state, noise=None) ->
    bcast``; ``update_attack_state(state, accept, observed, compromised)
    -> state'``; ``strength_stats(state, compromised) -> {stat: [N]}``,
    the rows masked to the compromised set."""

    state_keys: Tuple[str, ...] = ()
    init_attack_state: Optional[Callable[[int], Dict[str, np.ndarray]]] = field(default=None)
    apply_adaptive: Optional[Callable] = field(default=None)
    update_attack_state: Optional[Callable] = field(default=None)
    strength_stats: Optional[Callable] = field(default=None)


def acceptance_feedback(
    agg_stats: Dict[str, torch.Tensor],
    fault_stats: Dict[str, torch.Tensor],
    in_degree: torch.Tensor,
    alive: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(accept[N] in [0, 1], observed[N] in {0, 1})``: the fraction of
    peers that selected each node's broadcast (``tap_selected_by /
    tap_considered_by``; 1 for a rule without taps), forced to 0 where the
    sentinel scrubbed or quarantined the row (an observation: rejected),
    and the mask of rows whose state may move (a dead row is none)."""
    sel = agg_stats.get("tap_selected_by")
    if sel is not None:
        cons = agg_stats.get("tap_considered_by")
        denom = cons if cons is not None else in_degree
        denom = torch.clamp(denom.to(torch.float32), min=1.0)
        accept = torch.clamp(sel.to(torch.float32) / denom, 0.0, 1.0)
        observed = ((cons if cons is not None else in_degree) > 0).to(torch.float32)
    else:
        accept = torch.ones_like(in_degree, dtype=torch.float32)
        observed = torch.ones_like(in_degree, dtype=torch.float32)
    for key in ("tap_attack_scrubbed", "tap_quarantined"):
        flag = fault_stats.get(key)
        if flag is not None:
            accept = accept * (1.0 - flag)
            observed = torch.maximum(observed, flag)
    if alive is not None:
        observed = observed * alive
    return accept, observed


def _gated(update_mask, new, old):
    """The state update where the row was observed, else the old state."""
    return torch.where(update_mask > 0, new, old)


def _walk(state, key, accept, observed, compromised_mask, eta, accept_target, ema_beta,
          lo, cap):
    """The multiplicative acceptance walk of adaptive ALIE and IPM on
    ``state[key]``, with the acceptance EMA.  The step reads the round's
    acceptance, not the EMA: an EMA above 0 never returns to 0 after a run
    of rejections, which would make the walk escalate monotonically."""
    upd = compromised_mask * observed
    ema = _gated(
        upd,
        (1.0 - ema_beta) * state["atk_accept_ema"] + ema_beta * accept,
        state["atk_accept_ema"],
    )
    accepted = (accept > accept_target).to(torch.float32)
    new = state[key] * torch.where(accepted > 0, 1.0 + eta, 1.0 - eta)
    new = torch.clamp(new, lo, cap)
    return {"atk_accept_ema": ema, key: _gated(upd, new, state[key])}


def _masked(state, compromised_mask):
    return {k: v * compromised_mask for k, v in state.items()}


def make_adaptive_alie_attack(
    num_nodes: int,
    attack_percentage: float,
    z: Optional[float] = None,
    seed: int = 42,
    estimator: str = "omniscient",
    eta: float = 0.25,
    accept_target: float = 0.0,
    ema_beta: float = 0.5,
    z_min: float = 0.05,
    z_cap: Optional[float] = None,
) -> AdaptiveAttack:
    """ALIE whose z starts at the static attack's (the paper's z_max, or
    the explicit z) and walks against the acceptance: a round is accepted
    when its acceptance fraction is strictly above ``accept_target`` (by
    default: some peer still took the row)."""
    static = make_alie_attack(num_nodes, attack_percentage, z=z, seed=seed,
                              estimator=estimator)
    comp_count = int(static.compromised.sum())
    z0 = resolve_alie_z(num_nodes, comp_count, z)
    cap = float(z_cap) if z_cap is not None else max(4.0 * abs(z0), 4.0)

    def init_attack_state(n: int) -> Dict[str, np.ndarray]:
        return {"atk_z": np.full(n, z0, np.float32), "atk_accept_ema": np.ones(n, np.float32)}

    def apply_adaptive(flat, compromised_mask, generator, state, noise=None):  # murmura: traced
        if check_rows("adaptive_alie", flat, num_nodes):  # murmura: ignore[MUR001] check_rows reads flat.shape only
            raise ValueError("adaptive_alie takes the whole network's broadcast, not one node's row")
        if not comp_count:
            return flat
        mu, var = coalition_stats(flat, compromised_mask, estimator)
        z_rows = node_rows(state["atk_z"]).to(torch.float32)[:, None]  # [N, 1]
        malicious = (mu - z_rows * torch.sqrt(var)).to(flat.dtype)
        return torch.where(node_rows(compromised_mask)[:, None] > 0, malicious, flat)

    def update_attack_state(state, accept, observed, compromised_mask):  # murmura: traced
        return _walk(state, "atk_z", accept, observed, compromised_mask, eta, accept_target,
                     ema_beta, z_min, cap)

    def strength_stats(state, compromised_mask):
        return _masked({"atk_z": state["atk_z"], "atk_accept_ema": state["atk_accept_ema"]},
                       compromised_mask)

    return AdaptiveAttack(
        name="adaptive_alie",
        compromised=static.compromised,
        apply=static.apply,
        trains_locally=static.trains_locally,
        state_keys=("atk_accept_ema", "atk_z"),
        init_attack_state=init_attack_state,
        apply_adaptive=apply_adaptive,
        update_attack_state=update_attack_state,
        strength_stats=strength_stats,
    )


def make_adaptive_ipm_attack(
    num_nodes: int,
    attack_percentage: float,
    epsilon: Optional[float] = None,
    seed: int = 42,
    eta: float = 0.25,
    accept_target: float = 0.0,
    ema_beta: float = 0.5,
    eps_min: float = 0.05,
    eps_cap: Optional[float] = None,
) -> AdaptiveAttack:
    """IPM (``-epsilon * the honest mean``) whose epsilon walks as adaptive
    ALIE's z does, from the static attack's.  The coalition trains, so the
    honest mean it negates tracks real gradients."""
    static = make_ipm_attack(num_nodes, attack_percentage, epsilon=epsilon, seed=seed)
    comp_count = int(static.compromised.sum())
    eps0 = resolve_ipm_epsilon(epsilon)
    cap = float(eps_cap) if eps_cap is not None else max(4.0 * abs(eps0), 4.0)

    def init_attack_state(n: int) -> Dict[str, np.ndarray]:
        return {"atk_eps": np.full(n, eps0, np.float32), "atk_accept_ema": np.ones(n, np.float32)}

    def apply_adaptive(flat, compromised_mask, generator, state, noise=None):  # murmura: traced
        if check_rows("adaptive_ipm", flat, num_nodes):  # murmura: ignore[MUR001] check_rows reads flat.shape only
            raise ValueError("adaptive_ipm takes the whole network's broadcast, not one node's row")
        if not comp_count:
            return flat
        mu = honest_mean(flat, compromised_mask)  # [1, P] float32
        eps_rows = node_rows(state["atk_eps"]).to(torch.float32)[:, None]  # [N, 1]
        malicious = (-eps_rows * mu).to(flat.dtype)
        return torch.where(node_rows(compromised_mask)[:, None] > 0, malicious, flat)

    def update_attack_state(state, accept, observed, compromised_mask):  # murmura: traced
        return _walk(state, "atk_eps", accept, observed, compromised_mask, eta, accept_target,
                     ema_beta, eps_min, cap)

    def strength_stats(state, compromised_mask):
        return _masked({"atk_eps": state["atk_eps"], "atk_accept_ema": state["atk_accept_ema"]},
                       compromised_mask)

    return AdaptiveAttack(
        name="adaptive_ipm",
        compromised=static.compromised,
        apply=static.apply,
        trains_locally=True,
        state_keys=("atk_accept_ema", "atk_eps"),
        init_attack_state=init_attack_state,
        apply_adaptive=apply_adaptive,
        update_attack_state=update_attack_state,
        strength_stats=strength_stats,
    )


def make_bisection_attack(
    inner: Attack,
    scale_init: float = 1.0,
    scale_max: float = 8.0,
    growth: float = 2.0,
    accept_target: float = 0.0,
    ema_beta: float = 0.5,
) -> AdaptiveAttack:
    """Wrap a static broadcast attack into "the largest strength still
    accepted".  While no rejection has been seen (``atk_hi`` still at its
    sentinel above the cap) an accepted round multiplies the probe by
    ``growth`` (up to ``scale_max``); once a rejection pins the bracket, the
    probe bisects ``[atk_lo, atk_hi]``.  The wrapped attacker trains
    locally, so that scale 0 is honest behaviour.  A data-poisoning attack
    has no broadcast perturbation to scale and is refused."""
    if inner.data_poison_fn is not None:
        raise ValueError(
            f"attack '{inner.name}' poisons data, not broadcasts — there is no "
            "broadcast perturbation for the bisection wrapper to scale"
        )
    if not scale_max > 0:
        raise ValueError(f"scale_max must be > 0, got {scale_max}")
    scale_init = float(min(scale_init, scale_max))
    # Strictly above the cap: a real rejection at exactly scale_max must pin
    # the bracket, which an init of scale_max could not tell apart.
    hi_init = float(scale_max) * float(growth)

    def init_attack_state(n: int) -> Dict[str, np.ndarray]:
        return {
            "atk_scale": np.full(n, scale_init, np.float32),
            "atk_lo": np.zeros(n, np.float32),
            "atk_hi": np.full(n, hi_init, np.float32),
            "atk_accept_ema": np.ones(n, np.float32),
        }

    def apply_adaptive(flat, compromised_mask, generator, state, noise=None):  # murmura: traced
        base = inner.apply(flat, compromised_mask, generator, noise=noise)
        scale = node_rows(state["atk_scale"]).to(torch.float32)[:, None]
        f32 = flat.to(torch.float32)
        return (f32 + scale * (base.to(torch.float32) - f32)).to(flat.dtype)

    def update_attack_state(state, accept, observed, compromised_mask):  # murmura: traced
        upd = compromised_mask * observed
        scale, lo, hi = state["atk_scale"], state["atk_lo"], state["atk_hi"]
        ema = _gated(
            upd,
            (1.0 - ema_beta) * state["atk_accept_ema"] + ema_beta * accept,
            state["atk_accept_ema"],
        )
        accepted = (accept > accept_target).to(torch.float32)
        lo_new = torch.where(accepted > 0, torch.maximum(lo, scale), lo)
        hi_new = torch.where(accepted > 0, hi, torch.minimum(hi, scale))
        # Above the cap <=> still the sentinel <=> no rejection seen yet.
        growing = (hi_new > scale_max).to(torch.float32)
        probe = torch.where(
            growing > 0,
            torch.clamp(scale * growth, max=scale_max),
            0.5 * (lo_new + hi_new),
        )
        return {
            "atk_accept_ema": ema,
            "atk_scale": _gated(upd, probe, scale),
            "atk_lo": _gated(upd, lo_new, lo),
            "atk_hi": _gated(upd, hi_new, hi),
        }

    def strength_stats(state, compromised_mask):
        return _masked({k: state[k] for k in ("atk_scale", "atk_lo", "atk_hi",
                                              "atk_accept_ema")}, compromised_mask)

    return AdaptiveAttack(
        name=f"bisection_{inner.name}",
        compromised=inner.compromised,
        apply=inner.apply,
        trains_locally=True,
        state_keys=("atk_accept_ema", "atk_hi", "atk_lo", "atk_scale"),
        init_attack_state=init_attack_state,
        apply_adaptive=apply_adaptive,
        update_attack_state=update_attack_state,
        strength_stats=strength_stats,
    )


def _probe_bisection() -> AdaptiveAttack:
    from murmura_tpu_torch.attacks.gaussian import make_gaussian_attack

    return make_bisection_attack(make_gaussian_attack(4, attack_percentage=0.25, noise_std=1.0))


# Every adaptive attack, each built at a probe size: their state keys are
# drawn from ATTACK_STATE_KEYS and together cover it.
ADAPTIVE_ATTACKS: Dict[str, Callable[[], AdaptiveAttack]] = {
    "adaptive_alie": lambda: make_adaptive_alie_attack(4, attack_percentage=0.25),
    "adaptive_ipm": lambda: make_adaptive_ipm_attack(4, attack_percentage=0.25),
    "bisection": _probe_bisection,
}
