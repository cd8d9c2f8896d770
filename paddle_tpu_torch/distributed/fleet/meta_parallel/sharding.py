"""ZeRO group sharding, stages 1 and 2
(``paddle_tpu/distributed/fleet/meta_parallel/sharding.py`` analog).

The JAX package marks the optimizer (``_shard_state_axis``) and GSPMD
places each optimizer-state leaf on the ``sharding`` axis, on the first
free dimension the degree divides (``fleet/utils.py``
``_state_sharding_like``). Here every rank holds its slice of that
dimension of each state leaf (``ZeroPartition``), and the train step runs
the stage's collectives over the sharding group:

- stage 1 (``level="os"``): the gradients are averaged over every data
  rank (dp and sharding), each rank updates its slice of every parameter
  with its slice of the state, and the parameters are gathered back over
  the sharding group;
- stage 2 (``level="os_g"``): the gradients are averaged over dp and
  reduce-scattered over the sharding group, so each rank keeps only its
  slice of them; the update and the gather are stage 1's.

The slices of dimension 0 are views into the parameter (the fused AdamW
kernel updates them in place, at their storage offset); another
dimension's slice is a copy written back after the update. Stage 3
(``level="p_g_os"``, ``GroupShardedStage3``: parameters gathered on use)
is ROADMAP queue A item A5.3b and raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...communication import (ReduceOp, all_reduce, gather_blocks,
                              reduce_scatter_blocks)
from ...mesh import PartitionSpec
from ...sharding_utils import assemble, local_block

SHARDING_AXIS = "sharding"
_A53B = "ROADMAP queue A item A5.3b (ZeRO stage 3)"


def _first_divisible_dim(shape, degree: int) -> Optional[int]:
    for i, d in enumerate(shape):
        if d % degree == 0 and d >= degree:
            return i
    return None


def shard_spec_for(shape, degree: int, axis: str = SHARDING_AXIS):
    """ZeRO-3's placement of one parameter: its first divisible dimension
    over ``axis``; vectors (biases, norm scales) and indivisible shapes
    replicated."""
    if len(shape) < 2:
        return PartitionSpec()
    dim = _first_divisible_dim(shape, degree)
    if dim is None:
        return PartitionSpec()
    entries = [None] * len(shape)
    entries[dim] = axis
    return PartitionSpec(*entries)


def state_dim(shape, degree: int, taken=()) -> Optional[int]:
    """``_state_sharding_like``'s dimension for a state leaf of ``shape``:
    the first dimension not in ``taken`` (split over another axis) that
    the degree divides; None for a scalar or when none does."""
    if degree <= 1:
        return None
    for i, d in enumerate(shape):
        if i not in taken and d % degree == 0 and d >= degree:
            return i
    return None


class GroupShardedOptimizerStage2:
    """Marks ``optim`` for sharded state (stages 1 and 2): the train step
    gives each rank its slice of every state leaf. The optimizer's API is
    the inner one's."""

    def __init__(self, params, optim, group=None, offload=False, **kwargs):
        if offload:
            raise NotImplementedError(f"GroupShardedOptimizerStage2("
                                      f"offload=True) is not ported "
                                      f"({_A53B})")
        self._inner = optim
        optim._shard_state_axis = SHARDING_AXIS
        optim._sharding_group = group
        optim._zero_stage = max(getattr(optim, "_zero_stage", 1), 1)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    def step(self):
        return self._inner.step()

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)


class GroupShardedStage2(nn.Module):
    """Stage 2's model wrapper: the gradients of the wrapped model are
    reduce-scattered over the sharding group (by the train step), so each
    rank keeps only its slice. The forward is the model's."""

    def __init__(self, layer, sharding_optimizer=None, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23):
        super().__init__()
        self._layers = layer
        opts = sharding_optimizer if isinstance(
            sharding_optimizer, (list, tuple)) else [sharding_optimizer]
        for opt in opts:
            if opt is not None:
                inner = getattr(opt, "_inner", opt)
                inner._shard_state_axis = SHARDING_AXIS
                inner._zero_stage = 2
        for p in layer.parameters():
            p.grad_sharded = True

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, sd, *args, **kwargs):
        return self._layers.load_state_dict(sd, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class GroupShardedStage3(nn.Module):
    """Parameter sharding, gathered on use: not ported yet."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 segment_size=2 ** 20, offload=False):
        raise NotImplementedError(f"GroupShardedStage3: parameters gathered "
                                  f"on use are not ported yet ({_A53B})")


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           **kwargs):
    """``level``: ``"os"`` (stage 1: sharded optimizer state), ``"os_g"``
    (stage 2: and sharded gradients); ``"p_g_os"`` (stage 3) raises."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"level must be os|os_g|p_g_os, got {level!r}")
    if level == "p_g_os":
        raise NotImplementedError(f"group_sharded_parallel(level='p_g_os'):"
                                  f" ZeRO stage 3 is not ported yet "
                                  f"({_A53B})")
    optimizer = GroupShardedOptimizerStage2(None, optimizer, group=group,
                                            offload=offload)
    if level == "os_g":
        model = GroupShardedStage2(model, optimizer, group=group,
                                   sync_buffers=sync_buffers)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the wrapped model's ``state_dict`` to ``output.pdparams`` and
    the optimizer's to ``output.pdopt`` (``framework.io.save``): this
    rank's tensors. The global arrays of a sharded run come from the train
    step's ``state_for_checkpoint()``."""
    from ....framework import io as fio

    inner = getattr(model, "_layers", model)
    base = output[:-len(".pdparams")] if output.endswith(".pdparams") \
        else output
    fio.save(inner.state_dict(), base + ".pdparams")
    if optimizer is not None:
        fio.save(optimizer.state_dict(), base + ".pdopt")


def _moved(t, dim):
    return t if dim == 0 else t.movedim(dim, 0)


class ZeroPartition:
    """The slices of a sharded optimizer: ``dims[name]`` is the dimension
    of parameter ``name``'s (local) tensor along which this rank holds
    chunk ``rank`` of its state, over ``group`` (None: the whole state).
    ``stage`` 2 reduce-scatters the gradients into slices."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 dims: Dict[str, Optional[int]], group, stage: int):
        self.group, self.stage = group, stage
        self.n, self.rank = group.nranks, max(group.rank, 0)
        self.params = params
        self.dims = {k: d for k, d in dims.items() if d is not None}
        self.views = {}
        for name, d in self.dims.items():
            p = params[name]
            c = p.shape[d] // self.n
            v = p.detach().narrow(d, self.rank * c, c)
            self.views[name] = v if d == 0 else v.contiguous()
        self.slice_grads = {}

    def slice(self, name, t):
        """This rank's slice of ``t``, shaped like parameter ``name``."""
        d = self.dims.get(name)
        return t if d is None else local_block(t, d, self.rank, self.n)

    def whole(self, name, blocks):
        """The tensor of parameter ``name``'s shape from every rank's
        slice."""
        d = self.dims.get(name)
        return blocks[0] if d is None else assemble(blocks, d)

    def _by_dtype(self, names):
        out = {}
        for name in names:
            out.setdefault(self.params[name].dtype, []).append(name)
        return out.items()

    @torch.no_grad()
    def reduce_scatter_grads(self):
        """Stage 2: each sliced gradient's SUM over the group, this rank's
        slice kept (``slice_grads``) and divided by the group's size; the
        whole gradients are released. Unsliced gradients are averaged
        whole. One reduce-scatter per dtype."""
        inv = 1.0 / self.n
        for _, names in self._by_dtype(self.dims):
            rows = [torch.cat([_moved(self.params[k].grad, self.dims[k])
                               .reshape(self.n, -1)[i] for k in names])
                    for i in range(self.n)]
            flat = reduce_scatter_blocks(torch.stack(rows), self.group)
            flat.mul_(inv)
            off = 0
            for k in names:
                v = self.views[k]
                shape = _moved(v, self.dims[k]).shape
                g = flat[off:off + v.numel()].view(shape)
                self.slice_grads[k] = g if self.dims[k] == 0 \
                    else g.movedim(0, self.dims[k]).contiguous()
                off += v.numel()
                self.params[k].grad = None
        for name, p in self.params.items():
            if name not in self.dims and p.grad is not None:
                all_reduce(p.grad, ReduceOp.SUM, group=self.group)
                p.grad.mul_(inv)

    def grads(self):
        """``{name: gradient}`` the update reads: the slices for sliced
        parameters, the whole gradient for the others."""
        out = {}
        for name, p in self.params.items():
            if name in self.dims:
                out[name] = (self.slice_grads[name] if self.stage == 2
                             else self.slice(name, p.grad)
                             if p.grad is not None else None)
            else:
                out[name] = p.grad
        return out

    @torch.no_grad()
    def update(self, optimizer, grads, lr):
        """The optimizer's update of every sliced parameter's slice and of
        every other parameter whole, in place; the slices are then
        gathered over the group into the whole parameters (one gather per
        dtype)."""
        named = {}
        for name, p in self.params.items():
            g = grads.get(name)
            t = self.views.get(name, p)
            if name in self.dims and self.dims[name] != 0:
                t.copy_(self.slice(name, p.detach()))
            if g is not None and not g.is_contiguous() and t.is_cuda:
                g = g.contiguous()
            t.grad = g
            named[name] = t
        optimizer.apply_gradients(named, lr=lr)
        for t in named.values():
            t.grad = None
        for _, names in self._by_dtype(self.dims):
            flat = torch.cat([_moved(self.views[k], self.dims[k]).reshape(-1)
                              for k in names])
            blocks = gather_blocks(flat, self.group)
            off = 0
            for k in names:
                v = self.views[k]
                d = self.dims[k]
                shape = _moved(v, d).shape
                parts = [b[off:off + v.numel()].view(shape) for b in blocks]
                whole = torch.cat(parts, 0)
                self.params[k].copy_(whole if d == 0 else whole.movedim(0, d))
                off += v.numel()
