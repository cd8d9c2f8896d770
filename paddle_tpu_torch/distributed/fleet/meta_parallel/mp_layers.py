"""Tensor-parallel layers as plain single-GPU layers
(``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py`` analog).

The names and the weight layout are paddle's: linear weights are
``[in_features, out_features]`` and ``y = x @ W + b``, so converted
``paddle_tpu`` parameters load name for name with no transposes. Sharding
over an ``mp`` group is ROADMAP queue A item A5.3; on one device these
layers compute exactly what their JAX counterparts compute
with no mesh.
"""

from __future__ import annotations

import torch
from torch import nn

from ....nn.layer.common import Embedding, check_attr


def _check_group(mp_group):
    if mp_group is not None:
        raise NotImplementedError(
            "mp_group: tensor-parallel groups are not ported yet (ROADMAP "
            "queue A item A5.3, tensor parallelism)")


class _Linear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr, has_bias,
                 fuse_matmul_bias, mp_group, device, dtype):
        super().__init__()
        check_attr(weight_attr, "weight_attr")
        _check_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.fuse_matmul_bias = bool(fuse_matmul_bias)
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))
        nn.init.xavier_normal_(self.weight)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        if self.bias is None:
            return torch.matmul(x, self.weight)
        return torch.matmul(x, self.weight) + self.bias

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class ColumnParallelLinear(_Linear):
    """``y = x W + b`` with ``W [in, out]`` (out sharded over mp in the JAX
    package). On one device the mp degree is 1, so ``gather_output`` has
    nothing to gather, as in the JAX package without a mesh.
    ``fuse_matmul_bias`` is stored and changes no value: the JAX package
    accepts it and ignores it too."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         fuse_matmul_bias, mp_group, device, dtype)
        self.gather_output = gather_output


class RowParallelLinear(_Linear):
    """``y = x W + b`` with ``W [in, out]`` (in sharded over mp in the JAX
    package). On one device the mp degree is 1, so ``input_is_parallel``
    changes nothing, as in the JAX package without a mesh.
    ``fuse_matmul_bias`` is stored and changes no value, as in the JAX
    package."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         fuse_matmul_bias, mp_group, device, dtype)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """Embedding table ``weight [num_embeddings, embedding_dim]`` (vocab
    sharded over mp in the JAX package)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None):
        _check_group(mp_group)
        super().__init__(num_embeddings, embedding_dim,
                         weight_attr=weight_attr, device=device, dtype=dtype)
