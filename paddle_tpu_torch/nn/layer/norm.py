"""Normalization layers (``paddle_tpu/nn/layer/norm.py`` analog).

paddle's parameters come first; ``weight_attr=False`` / ``bias_attr=False``
build no weight / no bias (LayerNorm), as in paddle. ``device`` and
``dtype`` are keyword-only after them.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import check_attr


class LayerNorm(nn.Module):
    """LayerNorm with paddle's ``epsilon`` and parameter names
    (``weight`` ones, ``bias`` zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        check_attr(weight_attr, "weight_attr", allow_false=True)
        check_attr(bias_attr, "bias_attr", allow_false=True)
        self.normalized_shape = ((normalized_shape,)
                                 if isinstance(normalized_shape, int)
                                 else tuple(normalized_shape))
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, device=device, dtype=dtype)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, device=device, dtype=dtype)))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return (f"normalized_shape={list(self.normalized_shape)}, "
                f"epsilon={self.epsilon}")


class RMSNorm(nn.Module):
    """RMS normalization over the last axis with a ``weight`` of ones,
    through the fused RMSNorm kernel."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        check_attr(weight_attr, "weight_attr")
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape))
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(shape, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"{list(self.weight.shape)}, epsilon={self.epsilon}"
