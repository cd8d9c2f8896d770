"""Normalization functionals (``paddle_tpu/nn/functional/norm.py`` analog).

A single trailing axis with affine goes through the fused LayerNorm kernel,
and an RMSNorm with a weight through the fused RMSNorm kernel (on the CPU
their wrappers run the plain versions); any other shape runs the plain
lowering here, as the JAX package routes them.
"""

from __future__ import annotations

import torch

from ...kernels.norms import fused_layer_norm, fused_rms_norm


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    nshape = ((normalized_shape,) if isinstance(normalized_shape, int)
              else tuple(normalized_shape))
    if len(nshape) == 1 and weight is not None and bias is not None:
        return fused_layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - len(nshape), x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``x * rsqrt(mean(x^2, -1) + epsilon) * weight`` in fp32, cast to x's
    dtype."""
    if weight is not None:
        return fused_rms_norm(x, weight, epsilon)
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
