"""Tensor-parallel layers as plain single-GPU layers
(``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py`` analog).

The names and the weight layout are paddle's: linear weights are
``[in_features, out_features]`` and ``y = x @ W + b``, so converted
``paddle_tpu`` parameters load name for name with no transposes. Sharding
over an ``mp`` group arrives with the distributed slice of the port; on one
device these layers compute exactly what their JAX counterparts compute
with no mesh.
"""

from __future__ import annotations

import torch
from torch import nn

from ....nn.layer.common import Embedding


class _Linear(nn.Module):
    def __init__(self, in_features, out_features, has_bias=True, device=None,
                 dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))
        nn.init.xavier_normal_(self.weight)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        return out if self.bias is None else out + self.bias

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class ColumnParallelLinear(_Linear):
    """``y = x W + b`` with ``W [in, out]`` (out sharded over mp in the
    JAX package). ``gather_output`` is kept for signature parity."""

    def __init__(self, in_features, out_features, has_bias=True,
                 gather_output=True, device=None, dtype=None):
        super().__init__(in_features, out_features, has_bias, device, dtype)
        self.gather_output = gather_output


class RowParallelLinear(_Linear):
    """``y = x W + b`` with ``W [in, out]`` (in sharded over mp in the JAX
    package). ``input_is_parallel`` is kept for signature parity."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, device=None, dtype=None):
        super().__init__(in_features, out_features, has_bias, device, dtype)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """Embedding table ``weight [num_embeddings, embedding_dim]`` (vocab
    sharded over mp in the JAX package)."""
