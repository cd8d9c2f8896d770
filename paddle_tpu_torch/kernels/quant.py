"""Block-scaled gradient quantization (``paddle_tpu/kernels/quant.py``
analog): the wire format of the compressed gradient reduction.

Values are quantized per contiguous block of ``block_size`` elements along
the last dimension to int8 with one fp32 scale per block (``amax/127``),
so the wire carries ``1 + 4/block_size`` bytes per fp32 value (~3.9x at
block 128). The bf16 mode is a plain downcast, 2x, with no scales.

These are plain PyTorch ops, as the JAX package's are plain jnp (it has
no ``pallas_call`` here): the cost of the compressed reduction is its
collectives.

Non-finite values survive the round trip: the scale is
``maximum(amax, 1e-30) / 127`` with no finite clamping, so a NaN or Inf
anywhere in a block poisons the block's dequantized values and the loss
scaler's overflow check still trips. ``torch.round`` rounds half to even,
as ``jnp.round`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["quantize_block_scaled", "dequantize_block_scaled",
           "fit_block_size"]

_TINY = 1e-30
_INV127 = 1.0 / 127.0


def fit_block_size(C: int, block_size: int = 128) -> int:
    """The largest block that divides both ``C`` and ``block_size`` (their
    gcd): a dimension smaller than the default block still quantizes, at
    a higher scale overhead."""
    return math.gcd(int(C), int(block_size))


def quantize_block_scaled(v: torch.Tensor, block_size: int = 128,
                          dtype: str = "int8"
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``v [..., C]`` -> ``(payload, scales)``: int8 ``[..., C]`` and fp32
    ``[..., C // block_size]`` (``C`` a multiple of ``block_size``), or
    bf16 ``[..., C]`` and None."""
    if dtype in ("bf16", "bfloat16"):
        return v.to(torch.bfloat16), None
    if dtype != "int8":
        raise ValueError(f"quantize dtype must be int8/bf16, got {dtype!r}")
    C = v.shape[-1]
    if C % block_size:
        raise ValueError(f"last dim {C} not a multiple of block {block_size}")
    v = v.float()
    b = v.reshape(v.shape[:-1] + (C // block_size, block_size))
    amax = b.abs().amax(dim=-1)
    # maximum, not a mask: a non-finite amax reaches the scale; the floor
    # only keeps an all-zero block from 0/0
    scale = torch.clamp_min(amax, _TINY) * _INV127
    q = torch.round(b / scale[..., None])
    q = q.clamp(-127.0, 127.0).to(torch.int8)
    return q.reshape(v.shape), scale


def dequantize_block_scaled(q: torch.Tensor, scales: Optional[torch.Tensor],
                            block_size: int = 128) -> torch.Tensor:
    """The inverse of ``quantize_block_scaled``; always fp32."""
    if scales is None:
        return q.float()
    C = q.shape[-1]
    b = q.float().reshape(q.shape[:-1] + (C // block_size, block_size))
    return (b * scales[..., None].float()).reshape(q.shape)
