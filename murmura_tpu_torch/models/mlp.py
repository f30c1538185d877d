"""MLP classifiers, softmax and evidential (the PyTorch counterpart of
murmura_tpu/models/mlp.py).

Each hidden block is Linear -> LayerNorm -> ReLU -> Dropout; the evidential
variant ends in a softplus head that outputs Dirichlet alphas.  The wearable
MLP is the evidential variant with the wearables family's widths.  The
parameter layout is the JAX package's ({"head", "layers": [{"fc", "ln"}]}),
so the flat vector matches element for element.
"""

from typing import Sequence, Tuple

import torch

from murmura_tpu_torch.models.core import (
    Model,
    dense,
    dense_init,
    dropout,
    evidential_head,
    layernorm,
    layernorm_init,
    resolve_dtype,
)


def make_mlp(
    input_dim: int,
    hidden_dims: Sequence[int] = (64, 32),
    num_classes: int = 10,
    dropout_rate: float = 0.0,
    evidential: bool = False,
    name: str = "mlp",
    compute_dtype=None,
) -> Model:
    """Build an MLP ``Model``: ``hidden_dims`` blocks, each followed by
    dropout at ``dropout_rate`` in training, then a dense head (logits) or
    an evidential head (alphas)."""
    dims = [int(input_dim)] + [int(h) for h in hidden_dims]
    cd = resolve_dtype(compute_dtype)

    def init(generator: torch.Generator, device):
        layers = [
            {"fc": dense_init(generator, device, d_in, d_out),
             "ln": layernorm_init(generator, device, d_out)}
            for d_in, d_out in zip(dims[:-1], dims[1:])
        ]
        return {"layers": layers, "head": dense_init(generator, device, dims[-1], num_classes)}

    def apply(params, x, masks=None):
        x = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(params["layers"]):
            x = torch.relu(layernorm(layer["ln"], dense(layer["fc"], x, cd)))
            x = dropout(x, masks[i] if masks else None, dropout_rate)
        if evidential:
            return evidential_head(params["head"], x, cd)
        return dense(params["head"], x, cd)

    return Model(
        name=name,
        init=init,
        apply=apply,
        evidential=evidential,
        input_shape=(int(input_dim),),
        num_classes=num_classes,
        dropout=float(dropout_rate),
        dropout_widths=tuple(dims[1:]) if dropout_rate > 0.0 else (),
    )


def make_wearable_mlp(
    input_dim: int = 561,
    hidden_dims: Tuple[int, ...] = (256, 128),
    num_classes: int = 6,
    dropout: float = 0.3,
    name: str = "wearables.mlp",
    compute_dtype=None,
) -> Model:
    """The evidential wearable classifier (UCI HAR by default:
    561 -> 256 -> 128 -> Evidential(6))."""
    return make_mlp(
        input_dim=input_dim,
        hidden_dims=hidden_dims,
        num_classes=num_classes,
        dropout_rate=dropout,
        evidential=True,
        name=name,
        compute_dtype=compute_dtype,
    )
