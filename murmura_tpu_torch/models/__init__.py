"""Models as functional (init, apply) pairs: the FEMNIST CNN family, the MLP
and the evidential wearable MLPs."""

from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.models.registry import build_model

__all__ = ["Model", "build_model"]
