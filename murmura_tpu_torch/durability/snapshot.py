# Copy of SNAPSHOT_BASE_SECTIONS, RESERVED_AGG_STATE_KEY_GROUPS,
# discover_state_key_groups, save_run_snapshot, restore_run_snapshot and
# snapshot_roundtrip_missing_sections from murmura_tpu/durability/snapshot.py.
"""The run-state snapshot of the port's Network.

A snapshot carries the **base sections** (:data:`SNAPSHOT_BASE_SECTIONS`):
the node-stacked flat ``[N, P]`` parameters, the WHOLE ``agg_state`` (where
every reserved carried-state key group lives: the codec's residual and
reference, the stale cache and ages, the pipeline buffer), the run's seed,
the round counter, the history and the round times; plus the
orchestrator's **extra sections** through the ``_durability_*`` hooks of
:class:`~murmura_tpu_torch.core.network.Network` (the telemetry run id).

Resuming is exact because every random stream of the port is a pure
function of (seed, round): the round generators (core/rounds.py), the
fault schedule (regenerated from its own seed) and the attack's selection.
So the snapshot needs only the carried state, and the ``rng`` section is
the seed: a restore into a run with another seed is refused, since its
resumed stream would silently differ.

Storage rides :mod:`murmura_tpu_torch.utils.checkpoint` (fsync'd, with
``meta.json`` as the commit point).  A restore validates everything
(the flat shape and dtype, the ``agg_state`` keys, shapes and dtypes, the
seed, foreign extra sections) before it assigns anything.

The reserved carried-state key registry
---------------------------------------

Every module-level ``*_STATE_KEYS`` tuple of the port must be listed in
:data:`RESERVED_AGG_STATE_KEY_GROUPS` (:func:`discover_state_key_groups`
finds them by an AST scan; tests/test_torch_durability.py holds the two in
bijection), and a payload with every reserved key must survive the
save/restore roundtrip bit for bit (:func:`snapshot_roundtrip_missing_sections`).
``ATTACK_STATE_KEYS`` and ``DMTT_STATE_KEYS`` join when adaptive attacks
and DMTT are ported.
"""

import ast
import importlib
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from murmura_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

SNAPSHOT_BASE_SECTIONS: Tuple[str, ...] = (
    "params",       # the node-stacked flat [N, P] parameters
    "agg_state",    # the whole carried state, reserved keys included
    "rng",          # the run's seed (round generators are (seed, round))
    "round",        # the round counter
    "history",      # the recorded metrics
    "round_times",  # the per-round wall times
)

RESERVED_AGG_STATE_KEY_GROUPS: Dict[str, str] = {
    "COMPRESS_STATE_KEYS": "murmura_tpu_torch.ops.compress",
    "PIPELINE_STATE_KEYS": "murmura_tpu_torch.core.pipeline",
    "STALE_STATE_KEYS": "murmura_tpu_torch.core.stale",
}


def resolve_reserved_agg_state_keys() -> Dict[str, Tuple[str, ...]]:
    """Import every registered group; raises if an entry is stale."""
    out: Dict[str, Tuple[str, ...]] = {}
    for group, module in RESERVED_AGG_STATE_KEY_GROUPS.items():
        keys = getattr(importlib.import_module(module), group)
        if not (isinstance(keys, tuple) and keys and all(isinstance(k, str) for k in keys)):
            raise TypeError(
                f"{module}.{group} must be a non-empty tuple of str agg_state keys, "
                f"got {keys!r}"
            )
        out[group] = keys
    return out


def discover_state_key_groups(pkg_root) -> Dict[str, str]:
    """AST-scan the package for module-level ``*_STATE_KEYS`` assignments:
    ``{group_name: module_dotted_path}``."""
    pkg_root = Path(pkg_root)
    found: Dict[str, str] = {}
    for py in sorted(pkg_root.rglob("*.py")):
        try:
            tree = ast.parse(py.read_text())
        except (OSError, SyntaxError):
            continue
        module = ".".join(py.relative_to(pkg_root.parent).with_suffix("").parts)
        for node in tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                targets = [node.target.id]
            found.update({name: module for name in targets if name.endswith("_STATE_KEYS")})
    return found


def save_run_snapshot(directory, network) -> int:
    """Write ``network``'s complete run state to ``directory``; returns the
    bytes written.  A crash at any point leaves the previous complete
    snapshot or the new one."""
    extra_arrays, extra_meta = network._durability_extra_state()
    return save_checkpoint(
        directory,
        params=network.flat,
        agg_state=network.agg_state,
        rng=network.seed,
        round_num=network.current_round,
        history=network._durability_history(),
        round_times=network.round_times,
        extra_arrays=extra_arrays,
        extra_meta=extra_meta,
    )


def _describe(t: torch.Tensor):
    return tuple(t.shape), t.dtype


def restore_run_snapshot(directory, network) -> int:
    """Restore ``network`` from ``directory``; returns the round to continue
    from.  Refuses, before it assigns anything, a snapshot whose seed,
    flat shape or dtype, or ``agg_state`` keys, shapes or dtypes differ
    from the live run's, or that carries extra sections this orchestrator
    does not understand."""
    (flat, agg_state, seed, round_num, history, times,
     extra_arrays, extra_meta) = restore_checkpoint(directory, device=network.device)
    network._durability_validate_extra(extra_arrays, extra_meta)
    if seed != network.seed:
        raise ValueError(
            f"snapshot was written by a run with seed {seed} but this run has seed "
            f"{network.seed}: the resumed rounds would draw another stream; rebuild "
            "with the matching experiment.seed"
        )
    if _describe(flat) != _describe(network.flat):
        raise ValueError(
            f"snapshot params {_describe(flat)} do not match this run's "
            f"{_describe(network.flat)}: it was written by a different config; "
            "rebuild with the matching config"
        )
    if set(agg_state) != set(network.agg_state):
        raise ValueError(
            f"snapshot agg_state keys {sorted(agg_state)} differ from this run's "
            f"{sorted(network.agg_state)}: it was written by a different config "
            "(rule, compression, staleness or pipeline); rebuild with the matching config"
        )
    for k, v in agg_state.items():
        if _describe(v) != _describe(network.agg_state[k]):
            raise ValueError(
                f"snapshot agg_state[{k!r}] {_describe(v)} does not match this run's "
                f"{_describe(network.agg_state[k])}; rebuild with the matching config"
            )
    network.flat = flat
    network.agg_state = agg_state
    network.current_round = round_num
    network._durability_set_history(history)
    network.round_times = times
    network._durability_restore_extra(extra_arrays, extra_meta)
    return round_num


def snapshot_roundtrip_missing_sections(directory, payload_sections: Dict[str, Any]):
    """Write a synthetic snapshot from ``payload_sections`` (the base
    section names) into ``directory``, read it back, and return
    ``(missing_sections, corrupted_agg_keys)``: a key that does not come
    back bit for bit (same dtype, same bytes, NaN included) is corrupted."""
    missing = [s for s in SNAPSHOT_BASE_SECTIONS if s not in payload_sections]
    if missing:
        return missing, []
    save_checkpoint(
        directory,
        params=payload_sections["params"],
        agg_state=payload_sections["agg_state"],
        rng=payload_sections["rng"],
        round_num=payload_sections["round"],
        history=payload_sections["history"],
        round_times=payload_sections["round_times"],
    )
    params, agg_state, rng, round_num, history, times, _, _ = restore_checkpoint(directory)
    restored = {"params": params, "agg_state": agg_state, "rng": rng, "round": round_num,
                "history": history, "round_times": times}
    missing = [s for s in SNAPSHOT_BASE_SECTIONS
               if restored.get(s) is None and payload_sections[s] is not None]

    def same(a, b):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                                b.contiguous().reshape(-1).view(torch.uint8)))

    corrupted = [k for k, v in payload_sections["agg_state"].items()
                 if k not in agg_state or not same(agg_state[k], v)]
    return missing, corrupted
