"""Common layers (``paddle_tpu/nn/layer/common.py`` analog).

The constructors take paddle's parameters first, in paddle's order; the
port's own (``device``, ``dtype``) are keyword-only after them. A
``weight_attr`` other than None/True (a ``ParamAttr`` or an initializer)
waits for the port's ``nn.initializer`` (ROADMAP queue A item A8) and
raises.
"""

from __future__ import annotations

import torch
from torch import nn


def check_attr(attr, what: str, allow_false: bool = False):
    """None/True: the default parameter. False (where paddle allows it): no
    parameter. Anything else raises, naming A8."""
    if attr is None or attr is True or (allow_false and attr is False):
        return
    raise NotImplementedError(
        f"{what}={attr!r}: ParamAttr and initializers are not ported yet "
        "(ROADMAP queue A item A8, the rest of nn)")


class Embedding(nn.Module):
    """Lookup table ``weight [num_embeddings, embedding_dim]``, initialised
    from N(0, 1) like paddle's default. With ``padding_idx`` (negative
    counts from the end) that row is zeroed at construction and every
    lookup of it returns zeros, so it gets no gradient either, as in the
    JAX package. ``sparse=True`` (sparse gradients) raises, naming A8."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        check_attr(weight_attr, "weight_attr")
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True): sparse gradients are not ported yet "
                "(ROADMAP queue A item A8)")
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = (padding_idx if padding_idx is None
                            or padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.sparse = sparse
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        nn.init.normal_(self.weight)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx].zero_()

    def forward(self, x):
        out = torch.nn.functional.embedding(x, self.weight)
        if self.padding_idx is None:
            return out
        return torch.where((x == self.padding_idx)[..., None],
                           torch.zeros((), dtype=out.dtype, device=out.device),
                           out)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """paddle's ``Dropout(p, axis, mode)``. In training each element (or,
    with ``axis``, each slice along those axes: the mask is drawn over
    them and broadcast over the rest) is kept with probability ``1 - p``;
    ``mode="upscale_in_train"`` scales the kept values by ``1 / (1 - p)``,
    ``"downscale_in_infer"`` keeps them as they are and scales by
    ``1 - p`` in evaluation instead. Without ``axis``, upscaling is
    ``F.dropout`` (one fused draw-and-scale); otherwise a bool mask is
    drawn in one pass at the mask's shape and applied in one multiply
    (and one scale). Draws come from the device's default generator
    (``torch.manual_seed``; the train step keys it on its
    ``(seed, step)``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        if mode not in ("upscale_in_train", "downscale_in_infer"):
            raise ValueError(f"Dropout mode {mode!r}; want 'upscale_in_train'"
                             " or 'downscale_in_infer'")
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        p = float(self.p)
        if not self.training or p == 0.0:
            if self.mode == "downscale_in_infer" and not self.training:
                return x * (1.0 - p)
            return x
        upscale = self.mode == "upscale_in_train"
        if self.axis is None and upscale:
            return torch.nn.functional.dropout(x, p, training=True)
        shape = list(x.shape)
        if self.axis is not None:
            axes = self.axis if isinstance(self.axis, (list, tuple)) \
                else [self.axis]
            axes = {a % x.dim() for a in axes}
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = torch.empty(shape, dtype=torch.bool,
                           device=x.device).bernoulli_(1.0 - p)
        return x * keep * (1.0 / (1.0 - p)) if upscale else x * keep

    def extra_repr(self):
        return f"p={self.p}"
