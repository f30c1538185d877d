"""Models: the FEMNIST CNN family as functional (init, apply) pairs."""

from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.models.registry import build_model

__all__ = ["Model", "build_model"]
