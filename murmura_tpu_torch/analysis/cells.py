"""The executable families' shared pieces: the tiny cell every family
builds (the JAX package's durability cell: synthetic data, the 6-8-3 MLP,
5 nodes on a ring, 8 on the exponential graph), the anchors findings point
at (where ``# murmura: ignore[...]`` applies), and the family runner that
turns a crashed family into a finding.
"""

import copy
import inspect
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

from murmura_tpu_torch.analysis.lint import Finding, apply_suppressions

_PKG = Path(__file__).resolve().parent.parent

# The exchange formulations a rule's math takes: the dense [N, N]
# adjacency, the circulant offsets (tpu.exchange: ppermute) and the sparse
# [k, N] edge masks of the exponential graph.
EXCHANGE_MODES: Tuple[str, ...] = ("dense", "circulant", "sparse")


def base_raw(name: str, rule: str = "fedavg", rounds: int = 4, seed: int = 7) -> Dict[str, Any]:
    """The tiny cell's raw config: 5 nodes on a ring, the MLP 6-8-3 on 40
    synthetic samples, the rule's canonical parameters (frontier.AGG_CASES,
    the JAX package's analysis/ir.py table)."""
    from murmura_tpu_torch.frontier import AGG_CASES

    return {
        "experiment": {"name": name, "seed": seed, "rounds": rounds},
        "topology": {"type": "ring", "num_nodes": 5},
        "aggregation": {"algorithm": rule, "params": dict(AGG_CASES.get(rule, {}))},
        "training": {"local_epochs": 1, "batch_size": 8, "lr": 0.05},
        "data": {"adapter": "synthetic",
                 "params": {"num_samples": 40, "input_shape": [6], "num_classes": 3}},
        "model": {"factory": "mlp",
                  "params": {"input_dim": 6, "hidden_dims": [8], "num_classes": 3}},
        "backend": "simulation",
    }


def with_exchange(raw: Dict[str, Any], mode: str) -> Dict[str, Any]:
    """``raw`` under one of :data:`EXCHANGE_MODES`."""
    raw = copy.deepcopy(raw)
    if mode == "circulant":
        raw["backend"] = "tpu"
        raw["tpu"] = {**raw.get("tpu", {}), "exchange": "ppermute", "num_devices": 1,
                      "compute_dtype": "float32"}
    elif mode == "sparse":
        raw["topology"] = {"type": "exponential", "num_nodes": 8}
    elif mode != "dense":
        raise ValueError(f"unknown exchange mode {mode!r}")
    return raw


def build_network(raw: Dict[str, Any], device):
    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.utils.factories import build_network_from_config

    return build_network_from_config(Config.model_validate(raw), device=device)


def build_gang(raw: Dict[str, Any], device, **kw):
    from murmura_tpu_torch.config.schema import Config
    from murmura_tpu_torch.utils.factories import build_gang_from_config

    return build_gang_from_config(Config.model_validate(raw), device=device, **kw)


def rule_anchor(name: str) -> Tuple[str, int]:
    """(path, line) of the rule's factory ``def``."""
    from murmura_tpu_torch.aggregation import AGGREGATORS

    fn = AGGREGATORS.get(name)
    try:
        return str(inspect.getsourcefile(fn)), int(inspect.getsourcelines(fn)[1])
    except (OSError, TypeError):
        return str(_PKG / "aggregation" / "__init__.py"), 1


def anchor(rel_path: str, needle: str) -> Tuple[str, int]:
    """(path, line) of the first line of ``rel_path`` holding ``needle``."""
    path = _PKG / rel_path
    try:
        for i, line in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
            if needle in line:
                return str(path), i
    except OSError:
        pass
    return str(path), 1


def run_families(families: Dict[str, Callable], rule: str, module_file: str,
                 device) -> List[Finding]:
    """Every family of a module on ``device``; a family that raises is a
    ``rule`` finding at the module.  Suppressions apply at the anchors."""
    findings: List[Finding] = []
    for fam_name, fam in families.items():
        try:
            findings.extend(fam(device))
        except Exception as e:  # noqa: BLE001 — a crash IS the finding
            findings.append(Finding(
                rule, str(Path(module_file).resolve()), 1,
                f"check family '{fam_name}' crashed: {type(e).__name__}: {e}",
            ))
    findings = apply_suppressions(list(dict.fromkeys(findings)))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def family_registry():
    """A (registry, decorator) pair: the decorator adds a family by name."""
    registry: Dict[str, Callable] = {}

    def family(fn):
        registry[fn.__name__] = fn
        return fn

    return registry, family
