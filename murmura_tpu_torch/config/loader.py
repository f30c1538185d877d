# Copy of murmura_tpu/config/loader.py: the port imports nothing from the JAX package.
"""Config load/save with suffix dispatch (reference: murmura/config/loader.py:11-67)."""

import json
from pathlib import Path
from typing import Union

import yaml

from murmura_tpu_torch.config.schema import Config


def load_config(path: Union[str, Path]) -> Config:
    """Load and validate a Config from a .yaml/.yml/.json file."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")

    suffix = path.suffix.lower()
    with open(path, "r") as f:
        if suffix in (".yaml", ".yml"):
            raw = yaml.safe_load(f)
        elif suffix == ".json":
            raw = json.load(f)
        else:
            raise ValueError(
                f"Unsupported config format '{suffix}' (expected .yaml/.yml/.json)"
            )
    return Config.model_validate(raw)


def save_config(config: Config, path: Union[str, Path]) -> None:
    """Serialize a Config to .yaml/.yml/.json, chosen by suffix."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = config.model_dump(mode="json", exclude_none=True)

    suffix = path.suffix.lower()
    with open(path, "w") as f:
        if suffix in (".yaml", ".yml"):
            yaml.safe_dump(data, f, sort_keys=False)
        elif suffix == ".json":
            json.dump(data, f, indent=2)
        else:
            raise ValueError(
                f"Unsupported config format '{suffix}' (expected .yaml/.yml/.json)"
            )
