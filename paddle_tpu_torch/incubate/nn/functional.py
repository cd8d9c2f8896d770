"""Incubating fused functionals (``paddle_tpu/incubate/nn/functional.py``
analog). Only ``fused_rms_norm`` is ported; the rest of the module waits
for the long tail of the API surface (ROADMAP queue A item 8)."""

from __future__ import annotations

import torch

from ...nn.functional import rms_norm


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, name=None):
    """RMSNorm over ALL trailing axes from ``begin_norm_axis`` (the
    LayerNorm-style contract). Over the last axis alone it is
    ``nn.functional.rms_norm`` (the fused kernel); over more axes the fp32
    arithmetic runs here with ``norm_weight`` shaped as those axes.
    ``norm_bias`` is added to the result."""
    nd = x.dim()
    axis = begin_norm_axis % nd
    if axis == nd - 1:
        out = rms_norm(x, weight=norm_weight, epsilon=epsilon)
    else:
        x32 = x.float()
        ms = x32.square().mean(dim=tuple(range(axis, nd)), keepdim=True)
        w = norm_weight.reshape(x.shape[axis:]).float()
        out = (x32 * torch.rsqrt(ms + epsilon) * w).to(x.dtype)
    if norm_bias is not None:
        out = out + norm_bias
    return out
