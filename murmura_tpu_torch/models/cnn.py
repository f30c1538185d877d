"""FEMNIST CNN family (the PyTorch counterpart of murmura_tpu/models/cnn.py).

- baseline: conv5x5x32 -> pool -> conv5x5x64 -> pool -> fc2048 -> fc62;
- tiny (8/16/fc256), small (16/32/fc512), large (64/128/fc4096),
  xlarge (3x3 convs 64/128/256, pool after the 2nd and 3rd, fc4096 + fc2048).

Inputs are NHWC 28x28x1 as in the JAX package.  The flatten before the
first dense layer happens in NHWC order, as the JAX package's does, so the
NCHW activations are permuted back before the reshape.
"""

import torch

from murmura_tpu_torch.models.core import (
    Model,
    conv2d,
    conv_init,
    dense,
    dense_init,
    max_pool,
    resolve_dtype,
)

FEMNIST_VARIANTS = {
    # variant: (conv_channels, kernel, fc_dims)
    "tiny": ((8, 16), 5, (256,)),
    "small": ((16, 32), 5, (512,)),
    "baseline": ((32, 64), 5, (2048,)),
    "large": ((64, 128), 5, (4096,)),
    "xlarge": ((64, 128, 256), 3, (4096, 2048)),
}


def make_femnist_cnn(
    num_classes: int = 62,
    variant: str = "baseline",
    image_size: int = 28,
    channels_in: int = 1,
    name: str = None,
    compute_dtype=None,
) -> Model:
    """Build a FEMNIST CNN ``Model`` for 28x28x1 inputs."""
    if variant not in FEMNIST_VARIANTS:
        raise ValueError(
            f"Unknown FEMNIST variant '{variant}' (choose from {list(FEMNIST_VARIANTS)})"
        )
    conv_channels, kernel, fc_dims = FEMNIST_VARIANTS[variant]
    cd = resolve_dtype(compute_dtype)
    final_hw = image_size // 4
    flat_dim = final_hw * final_hw * conv_channels[-1]
    dense_dims = [flat_dim] + list(fc_dims) + [num_classes]

    def init(generator: torch.Generator, device):
        params = {"convs": [], "fcs": []}
        c_prev = channels_in
        for c in conv_channels:
            params["convs"].append(
                conv_init(generator, device, kernel, kernel, c_prev, c)
            )
            c_prev = c
        for j in range(len(dense_dims) - 1):
            params["fcs"].append(
                dense_init(generator, device, dense_dims[j], dense_dims[j + 1])
            )
        return params

    def apply(params, x):
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        convs = params["convs"]
        if len(convs) == 2:
            for conv_p in convs:
                x = max_pool(torch.relu(conv2d(conv_p, x, cd)))
        else:
            x = torch.relu(conv2d(convs[0], x, cd))
            x = max_pool(torch.relu(conv2d(convs[1], x, cd)))
            x = max_pool(torch.relu(conv2d(convs[2], x, cd)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
        for fc in params["fcs"][:-1]:
            x = torch.relu(dense(fc, x, cd))
        return dense(params["fcs"][-1], x, cd)

    return Model(
        name=name or f"leaf.femnist.{variant}",
        init=init,
        apply=apply,
        evidential=False,
        input_shape=(image_size, image_size, channels_in),
        num_classes=num_classes,
    )
