"""Tensor-parallel primitives on this rank's shards
(``paddle_tpu/distributed/fleet/meta_parallel/mp_ops.py`` analog).

The JAX package writes these as ``jnp`` functions over local shards inside
a ``shard_map`` over the mp axis, and autodiff of its collectives gives the
backward. Here each rank is a process holding its shard, and each
primitive is a ``torch.autograd.Function`` over the rank's group along
``axis_name`` (a mesh axis name of the hybrid topology, or a ``Group``),
with the Megatron pairs of forward and backward (the reference's
PyLayers):

- ``c_identity``: forward the identity, backward an all-reduce (the entry
  of a column-parallel region);
- ``mp_allreduce``: forward an all-reduce, backward the identity (the exit
  of a row-parallel region);
- ``c_split``: forward this rank's chunk, backward a gather;
- ``c_concat``: forward a gather, backward this rank's chunk.

``c_split`` and ``c_concat`` take the dimension (the last by default) and
the ``segments`` it is made of (``sharding_utils.local_block``). With one
rank in the group every primitive returns its input: a world of one
computes what the layers compute without a group. The gradients are the
true gradients of the global function on each rank's part: where the
cotangent of a replicated output is the same on every rank, as in a
train step, each rank's backward gives its shard's gradient.
"""

from __future__ import annotations

import torch

from ...collective import axis_group
from ...communication import (ReduceOp, all_reduce, gather_blocks,
                              reduce_scatter_blocks)
from ...sharding_utils import assemble, local_block


def _group(axis_name):
    g = axis_group(axis_name)
    return g if g.nranks > 1 else None


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x, group, dim, segments):
    return assemble(gather_blocks(x, group), dim % x.dim(), segments)


def _chunk(x, group, dim, segments):
    return local_block(x, dim % x.dim(), group.rank, group.nranks,
                       segments).contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, segments):
        ctx.args = (group, dim, segments)
        return _chunk(x, group, dim, segments)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, segments):
        ctx.args = (group, dim, segments)
        return _gather(x, group, dim, segments)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim, None)
        n = group.nranks
        xs = x.movedim(dim, 0)
        stacked = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
        return reduce_scatter_blocks(stacked, group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


def c_identity(x, axis_name):
    """Forward the identity, backward the SUM over the group."""
    g = _group(axis_name)
    return x if g is None else _Identity.apply(x, g)


def mp_allreduce(x, axis_name):
    """Forward the SUM over the group, backward the identity."""
    g = _group(axis_name)
    return x if g is None else _AllReduce.apply(x, g)


def c_split(x, axis_name, *, dim: int = -1, segments=None):
    """This rank's chunk of ``dim`` (of each of its ``segments``)."""
    g = _group(axis_name)
    return x if g is None else _Split.apply(x, g, dim, segments)


def c_concat(x, axis_name, *, dim: int = -1, segments=None):
    """Every rank's ``x`` joined along ``dim`` (``segments``: the joined
    dimension's, each made of one chunk of every rank's)."""
    g = _group(axis_name)
    return x if g is None else _Concat.apply(x, g, dim, segments)


def reduce_scatter(x, axis_name, *, dim: int = 0):
    """The SUM over the group, of which this rank keeps chunk ``rank`` of
    ``dim``; backward gathers."""
    g = _group(axis_name)
    return x if g is None else _ReduceScatter.apply(x, g, dim % x.dim())


def vocab_parallel_embedding(ids, table_shard, axis_name):
    """The lookup in this rank's rows ``[r*V_local, (r+1)*V_local)`` of the
    table, zeros for ids outside them, summed over the group."""
    g = _group(axis_name)
    if g is None:
        return torch.nn.functional.embedding(ids, table_shard)
    v_local = table_shard.shape[0]
    local = ids - g.rank * v_local
    owned = (local >= 0) & (local < v_local)
    looked = torch.nn.functional.embedding(local.clamp(0, v_local - 1),
                                           table_shard)
    looked = torch.where(owned[..., None], looked, torch.zeros(
        (), dtype=looked.dtype, device=looked.device))
    return mp_allreduce(looked, g)


def column_parallel_linear(x, w_shard, b_shard=None, axis_name: str = "mp",
                           gather_output: bool = False):
    """``x @ W_shard (+ b_shard)``, this rank's columns; with
    ``gather_output`` every rank's, joined."""
    y = torch.matmul(c_identity(x, axis_name), w_shard)
    if b_shard is not None:
        y = y + b_shard
    return c_concat(y, axis_name) if gather_output else y


def row_parallel_linear(x_shard, w_shard, bias=None, axis_name: str = "mp"):
    """The partial product over this rank's rows of ``W``, summed over the
    group; the bias added once, after the sum."""
    y = mp_allreduce(torch.matmul(x_shard, w_shard), axis_name)
    if bias is not None:
        y = y + bias
    return y


def parallel_cross_entropy(logits_shard, labels, axis_name,
                           ignore_index: int = -100):
    """Softmax cross entropy over vocabulary-sharded logits, per token,
    in fp32 whatever the logits' dtype: the global max (its gradient
    stopped), the global sum of exponentials, and the label's logit from
    the rank that holds it; 0 where ``labels == ignore_index``."""
    g = _group(axis_name)
    lg = logits_shard.float()
    labels = labels.long()
    v_local = lg.shape[-1]
    start = 0 if g is None else g.rank * v_local
    gmax = lg.detach().amax(dim=-1)
    if g is not None:
        all_reduce(gmax, ReduceOp.MAX, group=g)
    shifted = lg - gmax[..., None]
    sumexp = mp_allreduce(shifted.exp().sum(dim=-1), g or axis_name)
    lse = torch.log(sumexp) + gmax
    local = labels - start
    owned = (local >= 0) & (local < v_local)
    pick = torch.gather(lg, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    zero = torch.zeros((), dtype=lg.dtype, device=lg.device)
    label_logit = mp_allreduce(torch.where(owned, pick, zero), g or axis_name)
    return torch.where(labels == ignore_index, zero, lse - label_logit)
