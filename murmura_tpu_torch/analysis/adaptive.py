# Counterpart of murmura_tpu/analysis/adaptive.py (MUR1000, MUR1001).
"""Adaptive-adversary contracts (``check --adaptive``).

- **MUR1000 — attack-state registry bijection.**  Every adaptive attack's
  carried state keys are drawn from — and jointly cover —
  ``attacks.adaptive.ATTACK_STATE_KEYS``; every factory populates the whole
  adaptation interface with ``[N] float32`` rows; and the tuple is
  registered in the MUR900 snapshot registry, so a resumed attacker is the
  one that was stopped.
- **MUR1001 — build-free adaptation.**  Strength is carried state and the
  round index an input, so an adaptive round program is built once and
  every strength or round variation is value-only
  (:class:`~murmura_tpu_torch.analysis.sanitizers.CompileTracker`); the
  gang's ``reset_run`` re-aim between frontier stages must be equally free.

The collective-inventory parity (MUR1002) runs over a param group in
analysis/sharded.py; the jaxpr taint half (MUR1003) has no torch
counterpart.
"""

from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from murmura_tpu_torch.analysis.cells import (
    base_raw,
    build_gang,
    build_network,
    family_registry,
    rule_anchor,
    run_families,
)
from murmura_tpu_torch.analysis.lint import Finding

# The adaptive kinds the grid sweeps: adaptive ALIE, the scale bisection
# around the gaussian attack, adaptive IPM.
ADAPTIVE_ATTACK_KINDS: Tuple[str, ...] = ("alie", "gaussian", "ipm")

ADAPTIVE_CHECK_FAMILIES, _family = family_registry()

_PKG = Path(__file__).resolve().parent.parent
_ATK_PATH = str(_PKG / "attacks" / "adaptive.py")
_GANG_PATH = str(_PKG / "core" / "gang.py")


@_family
def check_attack_state_registry(device=None) -> List[Finding]:
    """MUR1000: ATTACK_STATE_KEYS <-> adaptive-attack factories <-> MUR900
    snapshot registry, all bijective and shape-sound."""
    try:
        from murmura_tpu_torch.attacks.adaptive import (
            ADAPTIVE_ATTACKS,
            ATTACK_STATE_KEYS,
            AdaptiveAttack,
        )
        from murmura_tpu_torch.durability.snapshot import RESERVED_AGG_STATE_KEY_GROUPS
    except Exception as e:  # noqa: BLE001 — the import failure IS the finding
        return [Finding(
            "MUR1000", _ATK_PATH, 1,
            f"the adaptive-attack registries failed to import "
            f"({type(e).__name__}: {e}) — the MUR1000 bijection cannot be checked",
        )]
    return attack_state_findings(ADAPTIVE_ATTACKS, tuple(ATTACK_STATE_KEYS), AdaptiveAttack,
                                 RESERVED_AGG_STATE_KEY_GROUPS)


def attack_state_findings(attacks, keys, attack_cls, registry) -> List[Finding]:
    """MUR1000 over a registry of adaptive-attack factories (the tests plant
    a factory whose state escapes the reservation)."""
    findings: List[Finding] = []
    if len(set(keys)) != len(keys) or any(not k.startswith("atk_") for k in keys):
        findings.append(Finding(
            "MUR1000", _ATK_PATH, 1,
            f"ATTACK_STATE_KEYS must be distinct 'atk_'-prefixed agg_state "
            f"keys, got {keys} — the prefix is how telemetry/frontier "
            "consumers recognize adaptation state",
        ))
    reg = registry.get("ATTACK_STATE_KEYS")
    if reg != "murmura_tpu_torch.attacks.adaptive":
        findings.append(Finding(
            "MUR1000", _ATK_PATH, 1,
            "ATTACK_STATE_KEYS is not registered in durability.snapshot."
            f"RESERVED_AGG_STATE_KEY_GROUPS under its defining module (got "
            f"{reg!r}) — a resumed attacker would silently restart cold",
        ))
    covered: set = set()
    for name, factory in sorted(attacks.items()):
        try:
            atk = factory()
        except Exception as e:  # noqa: BLE001 — a crash IS the finding
            findings.append(Finding(
                "MUR1000", _ATK_PATH, 1,
                f"adaptive attack factory '{name}' crashed: {type(e).__name__}: {e}",
            ))
            continue
        if not isinstance(atk, attack_cls):
            findings.append(Finding(
                "MUR1000", _ATK_PATH, 1,
                f"ADAPTIVE_ATTACKS['{name}'] built a {type(atk).__name__}, "
                "not an AdaptiveAttack",
            ))
            continue
        for hook in ("init_attack_state", "apply_adaptive", "update_attack_state",
                     "strength_stats"):
            if getattr(atk, hook) is None:
                findings.append(Finding(
                    "MUR1000", _ATK_PATH, 1,
                    f"adaptive attack '{name}' does not populate '{hook}' — "
                    "the round program (core/rounds.py) calls every "
                    "adaptation hook unconditionally",
                ))
        stray = set(atk.state_keys) - set(keys)
        if stray:
            findings.append(Finding(
                "MUR1000", _ATK_PATH, 1,
                f"adaptive attack '{name}' carries state keys {sorted(stray)} "
                "not reserved in ATTACK_STATE_KEYS — unreserved carried state "
                "collides with rule state and escapes the MUR900 snapshot "
                "bijection",
            ))
        covered |= set(atk.state_keys)
        if atk.init_attack_state is None:
            continue
        for n in (4, 9):
            try:
                init = atk.init_attack_state(n)
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                findings.append(Finding(
                    "MUR1000", _ATK_PATH, 1,
                    f"adaptive attack '{name}' init_attack_state({n}) crashed: "
                    f"{type(e).__name__}: {e}",
                ))
                continue
            if set(init) != set(atk.state_keys):
                findings.append(Finding(
                    "MUR1000", _ATK_PATH, 1,
                    f"adaptive attack '{name}' init_attack_state keys "
                    f"{sorted(init)} != declared state_keys "
                    f"{sorted(atk.state_keys)} — the round program seeds "
                    "agg_state from the declaration",
                ))
                continue
            for k, v in init.items():
                arr = np.asarray(v)
                if arr.shape != (n,) or arr.dtype != np.float32:
                    findings.append(Finding(
                        "MUR1000", _ATK_PATH, 1,
                        f"adaptive attack '{name}' state key '{k}' is "
                        f"{arr.dtype}{arr.shape}, not float32 ({n},) — "
                        "adaptation state must be per-node [N] float32 rows",
                    ))
    orphans = set(keys) - covered
    if orphans:
        findings.append(Finding(
            "MUR1000", _ATK_PATH, 1,
            f"ATTACK_STATE_KEYS entries {sorted(orphans)} are carried by no "
            "registered adaptive attack — remove the stale reservation or "
            "register the attack in ADAPTIVE_ATTACKS",
        ))
    return findings


def cell_raw(rule: str, kind: str) -> Dict[str, Any]:
    """One (rule, adaptive attack) cell: the tiny cell under a closed-loop
    attack on 30% of the nodes."""
    raw = base_raw(f"adaptive-{rule}-{kind}", rule)
    raw["attack"] = {"enabled": True, "type": kind, "percentage": 0.3,
                     "params": {"noise_std": 5.0} if kind == "gaussian" else {},
                     "adaptive": {"enabled": True}}
    return raw


def recompile_cell_findings(rule: str, kind: str, device="cuda") -> List[Finding]:
    """ONE MUR1001 cell: 2 warmup rounds, then 2 more under CompileTracker
    while the adaptation state moves; none of it may build, and the state
    must move (else the check is vacuous)."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles

    path, line = rule_anchor(rule)
    net = build_network(cell_raw(rule, kind), device)
    net.train(rounds=2)
    before = {k: v.detach().cpu().numpy().copy() for k, v in net.agg_state.items()
              if k.startswith("atk_")}
    with track_compiles() as tracker:
        net.train(rounds=2)
    findings: List[Finding] = []
    if tracker.total:
        findings.append(Finding(
            "MUR1001", path, line,
            f"[{rule}/{kind}] 2 adaptive rounds after warmup built "
            f"{tracker.total} program(s) or kernel(s) — adaptation must be "
            "value-only over one round program",
        ))
    comp = np.asarray(net.compromised) > 0
    moved = any(
        not np.array_equal(before[k][comp], net.agg_state[k].detach().cpu().numpy()[comp])
        for k in before
    )
    if before and comp.any() and not moved:
        findings.append(Finding(
            "MUR1001", path, line,
            f"[{rule}/{kind}] the adaptation state did not move across 2 "
            "rounds — the build check is vacuous (the feedback loop is not "
            "running; check the acceptance wiring in core/rounds.py)",
        ))
    return findings


def gang_reset_findings(device="cuda") -> List[Finding]:
    """The frontier stage loop's contract: a strength re-aim through
    ``GangNetwork.reset_run`` over the warm gang builds nothing."""
    from murmura_tpu_torch.analysis.sanitizers import track_compiles
    from murmura_tpu_torch.core.gang import GangMember

    raw = cell_raw("krum", "gaussian")
    raw["sweep"] = {"members": [{"seed": 7, "attack_scale": 0.0},
                                {"seed": 7, "attack_scale": 1.0}]}
    gang = build_gang(raw, device, retain_init=True)
    gang.train(rounds=2, eval_every=2)
    with track_compiles() as tracker:
        gang.reset_run([GangMember(seed=7, attack_scale=0.0),
                        GangMember(seed=7, attack_scale=2.5)])
        gang.train(rounds=2, eval_every=2)
    if tracker.total:
        return [Finding(
            "MUR1001", _GANG_PATH, 1,
            f"reset_run + retrain over the warm gang built {tracker.total} "
            "program(s) or kernel(s) — the frontier's stages must be "
            "value-only resets",
        )]
    return []


@_family
def check_adaptive_recompile(device) -> List[Finding]:
    """MUR1001 over ``AGGREGATORS x ADAPTIVE_ATTACK_KINDS`` plus the gang
    re-aim."""
    from murmura_tpu_torch.aggregation import AGGREGATORS

    findings: List[Finding] = []
    for rule in sorted(AGGREGATORS):
        for kind in ADAPTIVE_ATTACK_KINDS:
            try:
                findings.extend(recompile_cell_findings(rule, kind, device))
            except Exception as e:  # noqa: BLE001 — a crash IS the finding
                path, line = rule_anchor(rule)
                findings.append(Finding(
                    "MUR1001", path, line,
                    f"[{rule}/{kind}] adaptive build probe crashed: "
                    f"{type(e).__name__}: {e}",
                ))
    try:
        findings.extend(gang_reset_findings(device))
    except Exception as e:  # noqa: BLE001 — a crash IS the finding
        findings.append(Finding(
            "MUR1001", _GANG_PATH, 1,
            f"the gang reset_run build probe crashed: {type(e).__name__}: {e}",
        ))
    return findings


def check_adaptive(device="cuda") -> List[Finding]:
    """MUR1000/1001."""
    return run_families(ADAPTIVE_CHECK_FAMILIES, "MUR1000", __file__, device)
