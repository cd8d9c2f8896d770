"""Common layers (``paddle_tpu/nn/layer/common.py`` analog)."""

from __future__ import annotations

import torch
from torch import nn


class Embedding(nn.Module):
    """Lookup table ``weight [num_embeddings, embedding_dim]``, initialised
    from N(0, 1) like paddle's default."""

    def __init__(self, num_embeddings, embedding_dim, device=None, dtype=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        nn.init.normal_(self.weight)

    def forward(self, x):
        return torch.nn.functional.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


#: paddle's ``Dropout(p)`` has torch's semantics (upscale in training,
#: identity in eval)
Dropout = nn.Dropout
