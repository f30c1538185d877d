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

Without a compute dtype, a dense layer and ``layernorm`` promote mixed
operands the way ``jnp`` does (float32 activations times bfloat16
parameters run in float32), which is how the MLP runs with bfloat16
parameters; torch's matmul would refuse the mixed pair.

Dropout takes its masks from the caller (``apply(params, x, masks)``, one
boolean [B, width] mask per layer ``Model.dropout_widths`` names), so the
round can draw them from its generator or take injected ones; without
masks a model runs in eval mode.
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
        apply: (params, x[B, ...], masks=None) -> [B, K] logits, or
            Dirichlet alphas when ``evidential``; ``masks`` are the dropout
            masks of a training step (None: eval mode).
        evidential: whether outputs are Dirichlet concentration parameters.
        input_shape: per-sample input shape (no batch dim), NHWC for images.
        num_classes: output arity.
        dropout: the dropout rate of the layers in ``dropout_widths``.
        dropout_widths: the width of each layer that takes a dropout mask in
            training, in order (empty: the model has no dropout).
    """

    name: str
    init: Callable[[torch.Generator, torch.device], Params]
    apply: Callable[..., torch.Tensor]
    evidential: bool = False
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 0
    dropout: float = 0.0
    dropout_widths: Tuple[int, ...] = ()


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


def matmul(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w`` under the dense rule: with a compute dtype, operands rounded
    to it and a float32 product; without, mixed operands promoted."""
    if dtype is None:
        if w.dtype != x.dtype:
            common = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(common), w.to(common)
        return x @ w
    return x.to(dtype).to(torch.float32) @ w.to(dtype).to(torch.float32)


def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    return matmul(x, p["w"], dtype) + p["b"]


def conv2d(p: Params, x: torch.Tensor, dtype=None, impl: str = "direct") -> torch.Tensor:
    """SAME-padded stride-1 conv of NCHW activations with an HWIO kernel.

    ``impl="im2col"`` (``tpu.conv_impl``) writes the conv as patch
    extraction and one product, ``[B, H*W, cin*kh*kw] @ [cin*kh*kw,
    cout]``, as the JAX package's ``conv2d`` does: ``F.unfold`` orders a
    patch's features input-channel-major (cin, kh, kw), the order of
    ``conv_general_dilated_patches``, so the HWIO kernel is transposed to
    (cin, kh, kw, cout) before the reshape.  Same parameters, same bf16
    rule (patches, kernel and product in bf16, the result cast to
    float32)."""
    if impl == "im2col":
        kh, kw, cin, cout = p["w"].shape
        b, _, h, w_ = x.shape
        if dtype is not None:
            x = x.to(dtype)
        pat = F.unfold(x, (kh, kw), padding=(kh // 2, kw // 2))  # [B, cin*kh*kw, H*W]
        wm = p["w"].permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
        if dtype is not None:
            wm = wm.to(dtype)
        y = (pat.transpose(1, 2) @ wm).transpose(1, 2).reshape(b, cout, h, w_)
        if dtype is not None:
            y = y.to(torch.float32)
        return y + p["b"][:, None, None]
    if impl != "direct":
        raise ValueError(f"Unknown conv_impl: {impl!r} (direct or im2col)")
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


def layernorm_init(generator, device, dim: int) -> Params:
    """Unit scale, zero bias (draws nothing from ``generator``)."""
    return {
        "scale": torch.ones((dim,), device=device),
        "bias": torch.zeros((dim,), device=device),
    }


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the population variance (ddof 0),
    ``eps`` inside the square root, as ``jnp.var`` gives it."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Inverted dropout with a given keep ``mask`` (None: eval, identity),
    written as the JAX package writes it so that an injected mask gives the
    same values."""
    if mask is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def evidential_head(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Dense -> softplus evidence -> alpha = evidence + 1."""
    return F.softplus(dense(p, x, dtype)) + 1.0
