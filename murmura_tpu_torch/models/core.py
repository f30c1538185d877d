"""Functional model abstraction and layer primitives (the PyTorch
counterpart of murmura_tpu/models/core.py).

Models are (init, apply) pairs over plain dict/list pytrees of tensors, so
the node axis can be stacked in front of every leaf and ``torch.func.vmap``
can map ``apply`` over it.  Parameters keep the JAX package's layout —
HWIO conv kernels, [in, out] dense weights — so the flat [P] vector matches
the JAX package's element for element and weights carry over unchanged.
Images arrive NHWC as in the JAX package; ``conv2d`` works on NCHW
activations and takes the HWIO kernel as it is stored.

Mixed precision (``compute_dtype`` bfloat16) follows the JAX package's two
rules, written out as explicit casts rather than autocast:

- a conv runs uniformly in bf16 (inputs, kernel and output) and its result
  is cast to float32;
- a dense layer takes bf16-rounded inputs and accumulates in float32.  The
  product of two bf16 values is exact in float32, so rounding both operands
  to bf16 and multiplying in float32 is that rule exactly.
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Any


@dataclass(frozen=True)
class Model:
    """A functional model: pure init/apply plus metadata.

    Attributes:
        name: registry id.
        init: (generator, device) -> params pytree of float32 tensors.
        apply: (params, x[B, H, W, C]) -> [B, K] logits.
        input_shape: per-sample input shape (no batch dim), NHWC.
        num_classes: output arity.
    """

    name: str
    init: Callable[[torch.Generator, torch.device], Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    evidential: bool = False
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 0


def _uniform(shape, bound: float, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def dense_init(generator, device, in_dim: int, out_dim: int) -> Params:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weight and bias."""
    bound = 1.0 / in_dim ** 0.5
    return {
        "w": _uniform((in_dim, out_dim), bound, generator, device),
        "b": _uniform((out_dim,), bound, generator, device),
    }


def conv_init(generator, device, kh: int, kw: int, c_in: int, c_out: int) -> Params:
    """HWIO conv kernel, uniform over the fan_in bound."""
    bound = 1.0 / (kh * kw * c_in) ** 0.5
    return {
        "w": _uniform((kh, kw, c_in, c_out), bound, generator, device),
        "b": _uniform((c_out,), bound, generator, device),
    }


def resolve_dtype(compute_dtype) -> Optional[torch.dtype]:
    """Config string -> compute dtype (None = full float32)."""
    if compute_dtype in (None, "float32", torch.float32):
        return None
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"Unknown compute_dtype: {compute_dtype!r}")


def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    if dtype is None:
        return x @ p["w"] + p["b"]
    y = x.to(dtype).to(torch.float32) @ p["w"].to(dtype).to(torch.float32)
    return y + p["b"]


def conv2d(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """SAME-padded stride-1 conv of NCHW activations with an HWIO kernel."""
    w = p["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    y = F.conv2d(x, w, padding=w.shape[-1] // 2)
    if dtype is not None:
        y = y.to(torch.float32)
    return y + p["b"][:, None, None]


def max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=2)
