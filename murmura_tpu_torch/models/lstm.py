"""The Shakespeare character LSTM (the PyTorch counterpart of
murmura_tpu/models/lstm.py): embedding(8) -> 2-layer LSTM(256) ->
dense(vocab) over the last hidden state, seq_len 80.

The parameters keep the JAX package's layout and flat order (``cells``,
``embed``, ``out``; each cell's ``b``, ``wh``, ``wi``), so weights carry
over leaf for leaf.  Each cell packs its gates ``[i, f, g, o]`` in one
product per input, adds 1.0 to the forget gate's pre-activation, and
starts from zero ``h`` and ``c``.  Under ``compute_dtype`` bfloat16 both
products take bf16-rounded operands and accumulate in float32, the rule of
``dense``.

It is not ``nn.LSTM``: cuDNN's cell has no forget bias of 1.0, packs its
gates in another order and cannot run under ``torch.func.vmap`` over the
node axis.  The recurrence is a Python loop of plain tensor ops, which
``vmap(grad(...))`` maps as it is.  It runs layer by layer: a layer's
input product over every step is one product before its loop (the JAX
package computes the same sums step by step), and only the ``h @ wh``
product stays inside the loop.
"""

import torch
import torch.nn.functional as F

from murmura_tpu_torch.models.core import (
    Model,
    _uniform,
    dense,
    dense_init,
    matmul,
    resolve_dtype,
)


def _lstm_cell_init(generator, device, in_dim: int, hidden: int):
    bound = 1.0 / hidden ** 0.5
    return {
        "wi": _uniform((in_dim, 4 * hidden), bound, generator, device),
        "wh": _uniform((hidden, 4 * hidden), bound, generator, device),
        "b": torch.zeros((4 * hidden,), device=device),
    }


def _lstm_layer(p, xw: torch.Tensor, dtype) -> torch.Tensor:
    """One layer over the sequence: ``xw`` [B, T, 4H] is its input product;
    returns the hidden states [B, T, H]."""
    batch, steps = xw.shape[0], xw.shape[1]
    hidden = p["wh"].shape[0]
    h = torch.zeros((batch, hidden), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    hs = []
    # The kernel's rounding is the same every step: done once.
    wh = p["wh"] if dtype is None else p["wh"].to(dtype).to(torch.float32)
    for t in range(steps):
        hh = matmul(h, wh) if dtype is None else h.to(dtype).to(torch.float32) @ wh
        z = xw[:, t] + hh + p["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def make_char_lstm(
    vocab_size: int = 81,
    embed_dim: int = 8,
    hidden: int = 256,
    num_layers: int = 2,
    seq_len: int = 80,
    name: str = "leaf.shakespeare",
    compute_dtype=None,
) -> Model:
    """Stacked char-LSTM predicting the next character from ``seq_len``
    tokens."""
    cd = resolve_dtype(compute_dtype)

    def init(generator: torch.Generator, device):
        embed = torch.randn((vocab_size, embed_dim), generator=generator, device=device) * 0.1
        cells = []
        in_dim = embed_dim
        for _ in range(num_layers):
            cells.append(_lstm_cell_init(generator, device, in_dim, hidden))
            in_dim = hidden
        return {"embed": embed, "cells": cells,
                "out": dense_init(generator, device, hidden, vocab_size)}

    def apply(params, x, masks=None):  # no dropout: masks are not read
        seq = F.embedding(x, params["embed"])  # [B, T, E]
        for cell in params["cells"]:
            seq = _lstm_layer(cell, matmul(seq, cell["wi"], cd), cd)
        return dense(params["out"], seq[:, -1], cd)

    return Model(
        name=name,
        init=init,
        apply=apply,
        evidential=False,
        input_shape=(seq_len,),
        num_classes=vocab_size,
    )
