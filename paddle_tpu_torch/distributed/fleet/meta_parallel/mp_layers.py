"""Tensor-parallel layers over an mp group
(``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py`` analog).

The names and the weight layout are paddle's: linear weights are
``[in_features, out_features]`` and ``y = x @ W + b``, so converted
``paddle_tpu`` parameters load name for name with no transposes. The JAX
package annotates whole weights and GSPMD partitions them; here each rank
holds its block and the layers call ``mp_ops``' collectives explicitly,
over ``mp_group`` (by default the ``fleet.init`` topology's mp group; a
rank alone without one):

- ``ColumnParallelLinear``: ``W [in, out/mp]``, bias ``[out/mp]``; the
  input enters through ``c_identity``, and ``gather_output`` joins the
  ranks' columns;
- ``RowParallelLinear``: ``W [in/mp, out]``; an input that is not
  ``input_is_parallel`` is split first; the partial products are summed
  over the group and the bias ``[out]`` is added once, after the sum;
- ``VocabParallelEmbedding``: ``W [V/mp, d]``, ids outside this rank's
  rows give zeros before the sum;
- ``ParallelCrossEntropy``: the vocabulary-parallel softmax cross
  entropy.

Each weight carries its placement (``dist_spec``, as
``sharding_utils.annotate_parameter`` records it), and ``mp_dim`` and
``mp_segments`` say which dimension is split and what it is made of (a
column layer's output may be several segments, each split on its own:
the fused qkv projection's q | k | v). Sizes that do not divide raise
``ValueError``. With one rank in the group the layers compute exactly
what they compute without one.

``ColumnParallelLinear.replicate_weight()`` and
``RowParallelLinear.replicate_weight()`` hold the whole weight on every
rank instead (the train step's ``param_specs`` entry ``PartitionSpec()``):
a column layer then computes every column and keeps its own, a row layer
gathers its input first.
"""

from __future__ import annotations

import torch
from torch import nn

from ....nn.layer.common import Embedding, check_attr
from ...collective import Group, axis_group
from ...communication import gather_blocks
from ...mesh import PartitionSpec
from ...sharding_utils import annotate_parameter, assemble
from . import mp_ops

MP_AXIS = "mp"


def mp_group_of(mp_group) -> Group:
    """The layer's group: ``mp_group``, else the hybrid topology's mp group
    (a rank alone without one)."""
    if mp_group is None:
        return axis_group(MP_AXIS)
    if not isinstance(mp_group, Group):
        raise TypeError(f"mp_group must be a Group (a fleet topology's "
                        f"get_model_parallel_group()), got "
                        f"{type(mp_group).__name__}")
    return mp_group


def _divides(size, n, what):
    if size % n:
        raise ValueError(f"{what} {size} not divisible by mp degree {n}")
    return size // n


def mark_mp(param, spec, dim, segments=None):
    """Annotate ``param`` as split along ``dim`` over the mp axis."""
    annotate_parameter(param, spec)
    param.mp_dim = dim
    param.mp_segments = tuple(segments) if segments else None
    return param


class _Linear(nn.Module):
    """``y = x @ W + b`` with ``W [local_in, local_out]`` (by default the
    whole ``[in_features, out_features]``) and a bias of ``local_out``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, fuse_matmul_bias=False, mp_group=None,
                 device=None, dtype=None, *, local_in=None, local_out=None):
        super().__init__()
        self.mp_group = mp_group
        check_attr(weight_attr, "weight_attr")
        self.in_features, self.out_features = in_features, out_features
        self.fuse_matmul_bias = bool(fuse_matmul_bias)
        local_in = local_in or in_features
        local_out = local_out or out_features
        self.weight = nn.Parameter(torch.empty(local_in, local_out,
                                               device=device, dtype=dtype))
        nn.init.xavier_normal_(self.weight)
        self.bias = (nn.Parameter(torch.zeros(local_out, device=device,
                                              dtype=dtype))
                     if has_bias else None)
        self._replicated = False

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias

    @torch.no_grad()
    def replicate_weight(self):
        """Hold the whole weight on every rank (gathered from the ranks'
        blocks); the forward then needs no collective on the weight's
        side. Collective over the mp group."""
        w = self.weight
        if self.mp_group.nranks > 1 and not self._replicated:
            whole = assemble(gather_blocks(w.detach(), self.mp_group),
                             w.mp_dim, w.mp_segments)
            p = nn.Parameter(whole, requires_grad=w.requires_grad)
            annotate_parameter(p, PartitionSpec())
            p.mp_dim, p.mp_segments = w.mp_dim, w.mp_segments
            self.weight = p
        self._replicated = True
        return self.weight

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class ColumnParallelLinear(_Linear):
    """``y = x W + b`` with this rank's ``W [in, out/mp]`` and bias; with
    ``gather_output`` every rank's columns, joined. ``fuse_matmul_bias``
    is stored and changes no value: the JAX package accepts it and
    ignores it too."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 segments=None):
        g = mp_group_of(mp_group)
        segments = tuple(segments) if segments else (out_features,)
        if sum(segments) != out_features:
            raise ValueError(f"segments {segments} do not tile "
                             f"out_features {out_features}")
        for s in segments:
            _divides(s, g.nranks, "out_features")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         fuse_matmul_bias, g, device, dtype,
                         local_out=out_features // g.nranks)
        self.gather_output = gather_output
        self.segments = segments if len(segments) > 1 else None
        mark_mp(self.weight, PartitionSpec(None, MP_AXIS), 1, self.segments)
        if self.bias is not None:
            mark_mp(self.bias, PartitionSpec(MP_AXIS), 0, self.segments)

    def forward(self, x):
        g = self.mp_group
        if g.nranks == 1:
            return super().forward(x)
        if self._replicated:
            y = mp_ops.c_split(torch.matmul(x, self.weight), g,
                               segments=self.segments)
            if self.bias is not None:
                y = y + self.bias
        else:
            y = mp_ops.column_parallel_linear(x, self.weight, self.bias, g)
        return (mp_ops.c_concat(y, g, segments=self.segments)
                if self.gather_output else y)


class RowParallelLinear(_Linear):
    """``y = x W + b`` with this rank's ``W [in/mp, out]``: the input is
    this rank's features (``input_is_parallel``) or split first; the
    partial products are summed over the group, then the bias is added.
    ``fuse_matmul_bias`` is stored and changes no value, as in the JAX
    package."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        g = mp_group_of(mp_group)
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         fuse_matmul_bias, g, device, dtype,
                         local_in=_divides(in_features, g.nranks,
                                           "in_features"))
        self.input_is_parallel = input_is_parallel
        mark_mp(self.weight, PartitionSpec(MP_AXIS, None), 0)
        if self.bias is not None:
            annotate_parameter(self.bias, PartitionSpec(None))

    def forward(self, x):
        g = self.mp_group
        if g.nranks == 1:
            return super().forward(x)
        if self._replicated:
            return super().forward(mp_ops.c_concat(x, g)
                                   if self.input_is_parallel else x)
        if not self.input_is_parallel:
            x = mp_ops.c_split(x, g)
        return mp_ops.row_parallel_linear(x, self.weight, self.bias, g)


class VocabParallelEmbedding(Embedding):
    """Embedding table with this rank's rows ``weight [V/mp, d]`` of the
    ``num_embeddings`` ids; a lookup sums the ranks' (zeros outside a
    rank's rows)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None):
        g = mp_group_of(mp_group)
        local = _divides(num_embeddings, g.nranks, "num_embeddings")
        super().__init__(local, embedding_dim, weight_attr=weight_attr,
                         device=device, dtype=dtype)
        self.mp_group = g
        self.num_embeddings = num_embeddings
        mark_mp(self.weight, PartitionSpec(MP_AXIS, None), 0)

    def forward(self, x):
        if self.mp_group.nranks == 1:
            return super().forward(x)
        return mp_ops.vocab_parallel_embedding(x, self.weight, self.mp_group)


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy per token over vocabulary-sharded logits
    (``mp_ops.parallel_cross_entropy``), in fp32; 0 at ``ignore_index``.
    With one rank, ``nn.functional.cross_entropy(reduction="none")``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if self.mp_group.nranks == 1:
            from ....nn import functional as F

            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        return mp_ops.parallel_cross_entropy(input, label, self.mp_group,
                                             self.ignore_index)
