"""Compressed neighbour exchange: int8 block quantization and top-k
sparsification with error feedback (the PyTorch counterpart of
murmura_tpu/ops/compress.py, without its lever manifest).

``int8`` — per-block symmetric scale: the [P] row is split into
``block``-wide chunks, each quantized as ``q = round(x / scale)`` with
``scale = max|x| / 127``; exact zeros (the padding up to whole blocks
included) stay exact zeros.  The payload is ``(q int8 [N, C*B], scale f32
[N, C])``.

``topk`` — a sparse delta against a carried reference estimate ``x̂``
[N, P] (initialised from the initial broadcast, advanced to exactly what
receivers reconstruct): the k largest-magnitude coordinates of ``x - x̂``
cross the edge as (f32 value, int32 index) pairs.

Both reproduce the JAX package's jitted codec bit for bit on the same
inputs (tests/test_torch_compress.py):

- under ``jit`` XLA computes ``amax / 127.0`` as ``amax * float32(1/127)``,
  which can sit one ulp from the true quotient and then flips codes at the
  half-way points, so :func:`quantize_int8` multiplies too;
- ``jax.lax.top_k`` takes the lower index first among equal magnitudes,
  where ``torch.topk`` promises no order, so :func:`topk_mask` takes every
  entry above the k-th magnitude and then the lowest-index entries equal to
  it.

On one card there is no sharded node axis to move int8 over, so every rule
receives the receiver-side dequantized tensor (:func:`compress_exchange`).
The rules whose JAX twins read the int8 payload (``quantized_exchange``)
get it in float32, as those twins compute (``dequantize_f32``); the others
get it in the parameter dtype.  The two are the same tensor for float32
parameters.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Round-program-level agg_state keys: carried by the round step, never
# handed to the aggregation rule's state.
RESIDUAL_KEY = "compress_residual"
REF_KEY = "compress_ref"
COMPRESS_STATE_KEYS = (RESIDUAL_KEY, REF_KEY)

# float32(1 / 127), the factor XLA multiplies by where the JAX codec divides.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """The compressed-exchange spec (config: ``compression:``)."""

    algorithm: str  # "int8" | "topk"
    block: int = 256
    topk_ratio: float = 0.05
    error_feedback: bool = False

    def __post_init__(self):
        if self.algorithm not in ("int8", "topk"):
            raise ValueError(
                f"compression algorithm must be 'int8' or 'topk', got "
                f"{self.algorithm!r}"
            )
        if self.block < 1:
            raise ValueError(f"compression block must be >= 1, got {self.block}")
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(
                f"topk_ratio must be in (0, 1], got {self.topk_ratio}"
            )

    def topk_k(self, p: int) -> int:
        """Number of transmitted coordinates for a [P] row."""
        return max(1, min(p, int(round(self.topk_ratio * p))))

    def state_keys(self) -> Tuple[str, ...]:
        """agg_state keys this spec carries across rounds."""
        keys = []
        if self.error_feedback:
            keys.append(RESIDUAL_KEY)
        if self.algorithm == "topk":
            keys.append(REF_KEY)
        return tuple(keys)

    def payload_bytes(self, p: int, uncompressed_itemsize: int) -> int:
        """Bytes of one node's exchanged representation of a [P] row."""
        if self.algorithm == "int8":
            nblocks = -(-p // self.block)
            return p * 1 + nblocks * 4  # int8 payload + f32 scale per block
        k = self.topk_k(p)
        return k * (4 + 4)  # f32 value + int32 index per coordinate


@dataclasses.dataclass(frozen=True)
class Int8Blocks:
    """The int8 payload: ``q`` int8 [N, C*B] (P zero-padded to whole
    blocks), ``scale`` float32 [N, C] and the true length ``p``."""

    q: torch.Tensor
    scale: torch.Tensor
    block: int
    p: int

    def dequantize_f32(self) -> torch.Tensor:
        """[N, C*B] float32 values, padding included."""
        n, nblocks = self.scale.shape
        qf = self.q.to(torch.float32).reshape(n, nblocks, self.block)
        return (qf * self.scale[:, :, None]).reshape(n, nblocks * self.block)


def quantize_int8(x: torch.Tensor, block: int) -> Int8Blocks:
    """Per-block symmetric int8 quantization of a [N, P] tensor: ``scale =
    max|x| * float32(1/127)`` per block, ``q = round(x * (1 / scale))``
    (half to even) clipped to [-127, 127]; an all-zero block has zero codes
    and zero scale."""
    n, p = x.shape
    pad = (-p) % block
    xf = x.to(torch.float32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    nblocks = xf.shape[1] // block
    xb = xf.reshape(n, nblocks, block)
    amax = torch.amax(torch.abs(xb), dim=-1)  # [N, C]
    scale = amax * INV_127  # a float32 product: INV_127 is a float32 value
    inv = torch.where(scale > 0.0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xb * inv[:, :, None]), -127.0, 127.0).to(torch.int8)
    return Int8Blocks(q.reshape(n, nblocks * block), scale, block, p)


def topk_mask(mag: torch.Tensor, k: int) -> torch.Tensor:
    """[N, P] bool: the ``k`` largest entries of each row of ``mag``, the
    lower index first among equal values (``jax.lax.top_k``'s choice)."""
    kth = torch.topk(mag, k, dim=1, sorted=False).values.amin(dim=1, keepdim=True)
    above = mag > kth
    tie = mag == kth
    room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    return above | (tie & (torch.cumsum(tie, dim=1, dtype=torch.int32) <= room))


def compress_exchange(
    spec: CompressionSpec,
    bcast: torch.Tensor,
    agg_state: Dict[str, torch.Tensor],
    quantized_exchange: bool,
):
    """The codec on the round's broadcast.

    Returns ``(exchanged, decoded, state_updates, stats)``: ``decoded`` is
    the receiver-side [N, P] tensor in the parameter dtype; ``exchanged``
    what the rule receives (for a ``quantized_exchange`` rule under int8 the
    float32 dequantization the JAX twins compute from, else ``decoded``);
    ``state_updates`` the error-feedback residual and/or the top-k
    reference for the next round; ``stats`` the per-node ``compress_*``
    metrics.  Error feedback transmits ``Q(bcast + e)`` and carries ``e' =
    (bcast + e) - Q(bcast + e)``.  The top-k delta is applied as a masked
    add, the same values as the JAX package's scatter of its (value,
    index) pairs, so that the selection needs no host synchronisation.
    """
    state_updates = {}
    p = bcast.shape[1]
    outgoing = bcast.to(torch.float32)
    if spec.error_feedback:
        outgoing = outgoing + agg_state[RESIDUAL_KEY].to(torch.float32)

    if spec.algorithm == "int8":
        qb = quantize_int8(outgoing, spec.block)
        deq32 = qb.dequantize_f32()[:, :p]
        decoded = deq32.to(bcast.dtype).contiguous()
        exchanged = deq32.contiguous() if quantized_exchange else decoded
        if decoded.dtype == torch.float32:
            # XLA fuses the dequantizing product into the error's
            # subtraction (a fused multiply-add: x - q*scale, rounded
            # once).  q*scale is exact in float64 and so is the difference,
            # so rounding it to float32 gives that one rounding.
            n, nblocks = qb.scale.shape
            q64 = qb.q.to(torch.float64).reshape(n, nblocks, spec.block)
            deq64 = (q64 * qb.scale.to(torch.float64)[:, :, None]).reshape(n, -1)[:, :p]
            err = (outgoing.to(torch.float64) - deq64).to(torch.float32)
            del q64, deq64
    else:
        ref = agg_state[REF_KEY].to(torch.float32)
        delta = outgoing - ref
        picked = topk_mask(torch.abs(delta), spec.topk_k(p))
        decoded = (ref + torch.where(picked, delta, torch.zeros_like(delta))).to(bcast.dtype)
        # The reference advances to exactly what receivers reconstructed.
        state_updates[REF_KEY] = decoded
        exchanged = decoded

    if spec.algorithm != "int8" or decoded.dtype != torch.float32:
        err = outgoing - decoded.to(torch.float32)
    if spec.error_feedback:
        state_updates[RESIDUAL_KEY] = err.to(agg_state[RESIDUAL_KEY].dtype)
    stats = {"compress_error": torch.sqrt(torch.sum(err * err, dim=1))}
    if spec.error_feedback:
        res = state_updates[RESIDUAL_KEY].to(torch.float32)
        stats["compress_residual_norm"] = torch.sqrt(torch.sum(res * res, dim=1))
    return exchanged, decoded, state_updates, stats


def init_compress_state(
    spec: Optional[CompressionSpec], init_flat: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Initial agg_state entries: a zero residual and, for top-k, the
    reference estimate at the initial broadcast, in ``init_flat``'s dtype."""
    if spec is None:
        return {}
    out = {}
    if spec.error_feedback:
        out[RESIDUAL_KEY] = torch.zeros_like(init_flat)
    if spec.algorithm == "topk":
        out[REF_KEY] = init_flat.clone()
    return out
