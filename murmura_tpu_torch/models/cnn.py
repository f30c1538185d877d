"""The FEMNIST CNN family and the CelebA CNN (the PyTorch counterpart of
murmura_tpu/models/cnn.py).

- baseline: conv5x5x32 -> pool -> conv5x5x64 -> pool -> fc2048 -> fc62;
- tiny (8/16/fc256), small (16/32/fc512), large (64/128/fc4096),
  xlarge (3x3 convs 64/128/256, pool after the 2nd and 3rd, fc4096 + fc2048);
- CelebA: three 3x3 convs (32, 64, 128), each followed by a pool, on 84x84
  RGB, then fc256 -> fc2.

Inputs are NHWC as in the JAX package.  The flatten before the first dense
layer happens in NHWC order, as the JAX package's does, so the NCHW
activations are permuted back before the reshape.  ``conv_impl`` is
``tpu.conv_impl``: ``direct`` or ``im2col`` (models/core.py ``conv2d``).
"""

from typing import Sequence

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
    conv_impl: str = "direct",
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

    def apply(params, x, masks=None):  # no dropout: masks are not read
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        convs = params["convs"]
        if len(convs) == 2:
            for conv_p in convs:
                x = max_pool(torch.relu(conv2d(conv_p, x, cd, conv_impl)))
        else:
            x = torch.relu(conv2d(convs[0], x, cd, conv_impl))
            x = max_pool(torch.relu(conv2d(convs[1], x, cd, conv_impl)))
            x = max_pool(torch.relu(conv2d(convs[2], x, cd, conv_impl)))
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


def make_celeba_cnn(
    num_classes: int = 2,
    image_size: int = 84,
    channels: Sequence[int] = (32, 64, 128),
    fc_dim: int = 256,
    name: str = "leaf.celeba",
    compute_dtype=None,
    conv_impl: str = "direct",
) -> Model:
    """The LeNet-style CelebA CNN for 84x84 RGB: each 3x3 conv followed by
    ReLU and a 2x2 pool, then fc ``fc_dim`` and the class layer."""
    cd = resolve_dtype(compute_dtype)
    n_conv = len(channels)
    final_hw = image_size // (2 ** n_conv)
    flat_dim = final_hw * final_hw * channels[-1]

    def init(generator: torch.Generator, device):
        params = {"convs": [], "fcs": []}
        c_prev = 3
        for c in channels:
            params["convs"].append(conv_init(generator, device, 3, 3, c_prev, c))
            c_prev = c
        params["fcs"].append(dense_init(generator, device, flat_dim, fc_dim))
        params["fcs"].append(dense_init(generator, device, fc_dim, num_classes))
        return params

    def apply(params, x, masks=None):  # no dropout: masks are not read
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv_p in params["convs"]:
            x = max_pool(torch.relu(conv2d(conv_p, x, cd, conv_impl)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
        x = torch.relu(dense(params["fcs"][0], x, cd))
        return dense(params["fcs"][1], x, cd)

    return Model(
        name=name,
        init=init,
        apply=apply,
        evidential=False,
        input_shape=(image_size, image_size, 3),
        num_classes=num_classes,
    )
