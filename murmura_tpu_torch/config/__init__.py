"""Configuration layer: the JAX package's schema and loader, copied."""

from murmura_tpu_torch.config.loader import load_config, save_config
from murmura_tpu_torch.config.schema import Config

__all__ = ["Config", "load_config", "save_config"]
