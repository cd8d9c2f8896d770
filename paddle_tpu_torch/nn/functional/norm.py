"""Normalization functionals (``paddle_tpu/nn/functional/norm.py`` analog).

A single trailing axis with affine goes through the fused LayerNorm kernel
(on the CPU its wrapper runs the plain version); any other shape runs the
plain lowering here.
"""

from __future__ import annotations

import torch

from ...kernels.norms import fused_layer_norm


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
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
