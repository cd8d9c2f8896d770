"""ZeRO group sharding, stages 1, 2 and 3
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
  slice of them; the update and the gather are stage 1's;
- stage 3 (``level="p_g_os"``, ``GroupShardedStage3``): each rank stores
  only its slice of every matrix not split over mp (the dimension its
  optimizer state takes), gathers the whole weight on use and
  reduce-scatters its gradient into the slice's; the other parameters
  are stage 2's.

Under expert parallelism a rank's expert stacks are its ep rank's
``[E/ep, ...]`` blocks, placed ``P("ep", ...)``: their state, and at stage
3 the stacks themselves, are sliced along the first other dimension the
degree divides, where ``_state_sharding_like`` places the state of a
``P("ep", None, None)`` parameter; the sharding group's ranks share the ep
rank, so they hold the same experts.

The slices of dimension 0 are views into the parameter (the fused AdamW
kernel updates them in place, at their storage offset); another
dimension's slice is a copy written back after the update. A stage-3
parameter is its slice, updated in place, and is not gathered after the
update.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import torch
from torch import nn
from torch.multiprocessing.reductions import StorageWeakRef

from ....nn.clip import ClipGradByGlobalNorm
from ...communication import (ReduceOp, all_reduce, gather_along,
                              gather_blocks, reduce_scatter_blocks)
from ...mesh import PartitionSpec, spec_axes
from ...sharding_utils import local_block

SHARDING_AXIS = "sharding"
_A8 = "ROADMAP queue A item A8 (the long tail)"


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


def state_dim(shape, degree: int, taken=(), whole_ok=False
              ) -> Optional[int]:
    """``_state_sharding_like``'s dimension for a state leaf of ``shape``:
    the first dimension not in ``taken`` (split over another axis) that
    the degree divides; None for a scalar or when none does, and for a
    degree of one unless ``whole_ok`` (stage 3's one-piece slice)."""
    if degree <= 1 and not whole_ok:
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
                                      f"offload=True): offloading to the "
                                      f"host is not ported ({_A8})")
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


class Stage3Stats:
    """What stage 3 did since ``reset()``: all-gathers of parameters
    (``gathers``), reduce-scatters of their gradients
    (``reduce_scatters``), and the bytes of gathered weights the port
    held at a gather, at most (``peak_bytes``; read at every
    gather, where the count can only have grown)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.gathers = self.reduce_scatters = 0
        self.peak_bytes = 0


class _Regather:
    """What autograd keeps of a gathered weight it saves for the backward:
    the parameter and the view, not the values (gathered again when the
    backward unpacks it)."""

    __slots__ = ("z", "size", "stride", "offset")

    def __init__(self, z, t):
        self.z, self.size = z, t.size()
        self.stride, self.offset = t.stride(), t.storage_offset()


class _Gather(torch.autograd.Function):
    """The whole weight from every rank's slice. Its backward hands the
    whole gradient to the parameter's stage-3 record, which sums every use
    of one step before the one reduce-scatter into the slice's
    gradient."""

    @staticmethod
    def forward(ctx, piece, z):
        ctx.z = z
        return z.gather()

    @staticmethod
    def backward(ctx, grad):
        ctx.z.add_grad(grad)
        return None, None


class _Z3Param:
    """One parameter under stage 3: ``param`` is this rank's slice (chunk
    ``rank`` of dimension ``dim`` of the whole ``shape``); ``full()``
    gathers the whole weight over the wrapper's group."""

    def __init__(self, param, dim, shape, owner):
        self.param, self.dim, self.shape, self.w = param, dim, shape, owner
        self.expert = False   # an ep rank's expert stack (train step's)
        self.pending = 0      # uses of this forward not yet back-propagated
        self.cur = None       # this backward's sum of the uses' gradients
        self.acc = None       # the step's whole gradient (deferred mode)

    def gather(self):
        if self.w.group.nranks == 1:  # the slice is the whole
            self.w.stats.gathers += 1
            return self.param.detach()
        # a root alias of the gathered buffer: the collective's own
        # reference to the buffer is not the port's (``_track``)
        full = gather_along(self.param.detach(), self.w.group,
                            self.dim).detach()
        self.w._track(self, full)
        return full

    def full(self):
        """The whole weight: differentiable (its gradient reaches the slice
        through ``add_grad``) when grad is enabled."""
        if torch.is_grad_enabled() and self.param.requires_grad:
            if self.w._counting:
                self.pending += 1
            return _Gather.apply(self.param, self)
        return self.gather()

    def add_grad(self, g):
        self.cur = g if self.cur is None else self.cur + g
        self.w._queue_flush()
        if self.pending > 0:
            self.pending -= 1
            if self.pending == 0:
                self.end_pass()

    def end_pass(self):
        """Every use of this backward has added its gradient: fold it into
        the step's, or reduce-scatter it into the slice's gradient."""
        if self.cur is None:
            return
        g, self.cur = self.cur, None
        if self.w._defer:
            self.acc = g if self.acc is None else self.acc + g
        else:
            self.reduce_scatter(g)

    @torch.no_grad()
    def reduce_scatter(self, g):
        """``g`` (the whole gradient) averaged over the data group first
        when the train step has one (an expert stack's summed over the
        replicas of its ep rank there and divided by the data group's
        size), then reduce-scattered over the wrapper's group: this rank's
        chunk of the SUM, times ``1/n``, added into the slice's ``.grad``
        (so accumulation microbatches add up there)."""
        w = self.w
        group, count = w._reduce[self.expert]
        if count > 1:
            g = g.contiguous()
            if group is not None:
                all_reduce(g, ReduceOp.SUM, group=group)
            g.mul_(1.0 / count)
        n, d = w.group.nranks, self.dim
        rows = _moved(g, d).reshape(n, -1)
        flat = reduce_scatter_blocks(rows, w.group)
        flat.mul_(1.0 / n)
        w.stats.reduce_scatters += 1
        shape = _moved(self.param, d).shape
        piece = flat.view(shape)
        piece = piece if d == 0 else piece.movedim(0, d).contiguous()
        p = self.param
        p.grad = piece if p.grad is None else p.grad + piece


def _stage3_getattr(sub):
    def __getattr__(self, name):
        z = self.__dict__.get("_z3_params")
        if z is not None and name in z:
            return z[name].full()
        return super(sub, self).__getattr__(name)
    return __getattr__


_STAGE3_CLASSES = {}


def _stage3_class(cls):
    """``cls`` with attribute reads of its stage-3 parameters gathering
    the whole weight (the slice stays the registered parameter)."""
    sub = _STAGE3_CLASSES.get(cls)
    if sub is None:
        sub = type(cls.__name__, (cls,), {"__module__": cls.__module__,
                                           "__qualname__": cls.__qualname__})
        sub.__getattr__ = _stage3_getattr(sub)
        _STAGE3_CLASSES[cls] = sub
    return sub


class GroupShardedStage3(nn.Module):
    """ZeRO stage 3: each rank stores only its slice of every parameter of
    two or more dimensions that is not split over an mp group of more
    than one rank: the first dimension the group's size divides that the
    parameter's own spec leaves free on the hybrid topology's mesh
    (``shard_spec_for``'s for a parameter with no spec; where
    ``_state_sharding_like`` places its optimizer state for one whose
    layer names mp). Vectors and mp-split weights stay whole. The
    ``nn.Parameter`` is the slice, so ``parameters()``, the optimizer, the
    clip and the fused AdamW see slices, and every optimizer-state leaf
    sits where the JAX step places it.

    Reading such a parameter as a module attribute (``linear.weight``)
    all-gathers the whole weight over ``group`` (default: the hybrid
    topology's sharding group); so each module gathers its weights just
    before it runs, the recomputed forward of a ``recompute`` region
    gathers again, and the tied embedding's two uses gather twice. Inside
    the wrapper's forward, autograd keeps no gathered weight for the
    backward: it saves the parameter and gathers again when the backward
    needs it (``saved_tensors_hooks``), so a weight lives from its gather
    to the end of its module's forward, and again for its backward. The
    gradients of a weight's uses are summed, and once they all have been
    (or at the end of the backward) the sum is reduce-scattered over the
    group into the slice's ``.grad``: the mean over the group's ranks,
    each of which ran its own rows. The other parameters' gradients are
    averaged over the group at the end of the backward (for the eager
    ``model(x).mean().backward(); opt.step()``); the train step takes
    over both reductions (its data group first, error feedback, and
    gradient accumulation).

    ``state_dict()`` gathers the whole arrays (collective) and
    ``set_state_dict``/``load_state_dict`` take whole arrays and keep
    this rank's slices. ``segment_size`` does not change the placement,
    as in the JAX package; ``offload=True`` raises. In a group of one rank
    every matrix is its own slice, in one piece: a gather returns it and
    a reduce-scatter is the identity.

    The JAX package leaves every weight whose layer names an mp axis
    whole, even where that axis has one rank (on GPT at sharding 2 it
    slices the position table only); the port slices those too, along
    their optimizer state's dimension, since nothing splits them. The
    numbers are the same: ZeRO changes no value, and on one mesh stage 3
    and stage 2 hold the same slices, so they agree to the bit."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 segment_size=2 ** 20, offload=False):
        if offload:
            raise NotImplementedError(f"GroupShardedStage3(offload=True): "
                                      f"offloading to the host is not "
                                      f"ported ({_A8})")
        super().__init__()
        from ...collective import axis_group
        from ...topology import get_hybrid_communicate_group

        from ...mesh import current_mesh
        from ...sharding_utils import resolve_spec

        hcg = get_hybrid_communicate_group()
        self._layers = layer
        self.group = group if group is not None else (
            hcg.get_sharding_parallel_group() if hcg is not None
            else axis_group(SHARDING_AXIS))
        n, rank = self.group.nranks, max(self.group.rank, 0)
        mp_n = hcg.get_model_parallel_world_size() if hcg is not None else 1
        mesh = hcg.get_mesh() if hcg is not None else current_mesh()
        self.stats = Stage3Stats()
        self._live = {}
        self._counting = False
        self._defer = False
        self._reduce = {False: (None, 1), True: (None, 1)}
        self._in_step = False
        self._flush_queued = False
        self.z3 = {}  # name -> _Z3Param
        made = {}
        with torch.no_grad():
            for mname, mod in layer.named_modules():
                for k, p in list(mod._parameters.items()):
                    if p is None:
                        continue
                    name = f"{mname}.{k}" if mname else k
                    z = made.get(id(p))
                    if z is None:
                        spec = getattr(p, "dist_spec", None) or ()
                        mp_split = mp_n > 1 and "mp" in spec_axes(spec)
                        if mesh is not None:
                            spec = resolve_spec(spec, mesh)
                        d = None if mp_split or p.dim() < 2 else state_dim(
                            p.shape, n, {i for i, e in enumerate(spec)
                                         if e is not None}, whole_ok=True)
                        if d is None:
                            continue
                        piece = nn.Parameter(
                            local_block(p.detach(), d, rank, n).clone(),
                            requires_grad=p.requires_grad)
                        for a in ("dist_spec", "is_distributed", "mp_dim",
                                  "mp_segments"):
                            if hasattr(p, a):
                                setattr(piece, a, getattr(p, a))
                        piece.zero3_dim = d
                        piece.zero3_shape = tuple(p.shape)
                        z = made[id(p)] = _Z3Param(piece, d, tuple(p.shape),
                                                   self)
                        self._swap_in_optimizer(optimizer, p, piece)
                    mod._parameters[k] = z.param
                    mod.__dict__.setdefault("_z3_params", {})[k] = z
                    mod.__class__ = _stage3_class(type(mod))
                    self.z3[name] = z
        if optimizer is not None:
            inner = getattr(optimizer, "_inner", optimizer)
            inner._shard_state_axis = SHARDING_AXIS
            inner._sharding_group = self.group
            inner._zero_stage = 3
            self._wrap_clip(inner)

    def _swap_in_optimizer(self, optimizer, old, new):
        """The optimizer's parameters become the slices (a state made for
        the whole parameter is dropped)."""
        if optimizer is None:
            return
        inner = getattr(optimizer, "_inner", optimizer)
        for k, p in list(inner._params.items()):
            if p is old:
                inner._params[k] = new
                inner.state.pop(k, None)

    def _wrap_clip(self, inner):
        from ....nn.clip import ClipGradByGlobalNorm

        clip = inner._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) \
                and not isinstance(clip, _Stage3Clip):
            inner._grad_clip = _Stage3Clip(clip, self, inner)

    # ---------- the forward and the backward ----------
    @contextlib.contextmanager
    def forward_scope(self):
        """The original forward: gathers are counted as uses, and a
        gathered weight that autograd saves is kept as a note to gather it
        again."""
        prev = self._counting
        self._counting = True
        self._flush_queued = False
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._counting = prev

    def _track(self, z, full):
        """Record a gathered weight (weakly): its storage for ``_pack``,
        the tensor for the live count."""
        st = full.untyped_storage()
        self._live = {k: v for k, v in self._live.items()
                      if v[3]() is not None}
        self._live[st.data_ptr()] = (z, StorageWeakRef(st), st.nbytes(),
                                     weakref.ref(full))
        self.stats.gathers += 1
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.live_bytes)

    @property
    def live_bytes(self) -> int:
        """Bytes of gathered weights the port holds now: the tensor
        ``gather`` returned, or a view of it, is alive. The storage may
        outlive them a moment: gloo's worker thread drops its reference
        to an all-gather's output after the call has returned."""
        return sum(n for _, _, n, ref in self._live.values()
                   if ref() is not None)

    def _pack(self, t):
        try:
            key = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            return t
        hit = self._live.get(key)
        if hit is None or hit[1].expired():
            return t
        return _Regather(hit[0], t)

    @staticmethod
    def _unpack(x):
        if isinstance(x, _Regather):
            return x.z.gather().as_strided(x.size, x.stride, x.offset)
        return x

    def _queue_flush(self):
        if not self._flush_queued:
            self._flush_queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)

    def _after_backward(self):
        """The end of a backward: every gradient still pending is folded or
        reduce-scattered; in eager use, the other parameters' gradients
        are averaged over the group."""
        self._flush_queued = False
        for z in self.z3.values():
            z.pending = 0
            z.end_pass()
        if not self._in_step and self.group.nranks > 1:
            inv = 1.0 / self.group.nranks
            with torch.no_grad():
                for name, p in self._layers.named_parameters():
                    if name not in self.z3 and p.grad is not None:
                        all_reduce(p.grad, ReduceOp.SUM, group=self.group)
                        p.grad.mul_(inv)

    def step_mode(self, dp_group=None, defer=False, *, experts=(),
                  expert_group=None):
        """Hand the reductions to the train step: the whole gradients are
        averaged over ``dp_group`` before the reduce-scatter (those of
        the parameters named in ``experts`` summed over ``expert_group``,
        their ep rank's replicas, and divided by ``dp_group``'s size), or,
        with ``defer`` (for the gradient reducer), summed over the step's
        backwards and left to ``whole_grads``."""
        self._in_step = True
        n = dp_group.nranks if dp_group is not None else 1
        self._reduce = {
            False: (dp_group if n > 1 else None, n),
            True: (expert_group if expert_group is not None
                   and expert_group.nranks > 1 else None, n)}
        for name, z in self.z3.items():
            z.expert = name in experts
        self._defer = bool(defer)

    def whole_grads(self, scale=None):
        """``{name: whole gradient}`` summed over the step's backwards
        (deferred mode), times ``scale``; they are released here."""
        out = {}
        for name, z in self.z3.items():
            if z.acc is not None:
                out[name] = z.acc if scale is None else z.acc * scale
                z.acc = None
        return out

    def forward(self, *args, **kwargs):
        with self.forward_scope():
            return self._layers(*args, **kwargs)

    def forward_with_loss(self, *args, **kwargs):
        with self.forward_scope():
            return self._layers.forward_with_loss(*args, **kwargs)

    # ---------- whole arrays ----------
    @torch.no_grad()
    def state_dict(self, *args, **kwargs):
        """The wrapped model's state dict with every slice gathered into
        the whole array (collective over the group)."""
        sd = self._layers.state_dict(*args, **kwargs)
        return {k: (self.z3[k].gather().clone() if k in self.z3 else v)
                for k, v in sd.items()}

    @torch.no_grad()
    def set_state_dict(self, sd, *args, **kwargs):
        """Load whole arrays: each stage-3 parameter keeps its slice."""
        n, rank = self.group.nranks, max(self.group.rank, 0)
        local = {}
        for k, v in sd.items():
            v = torch.as_tensor(v)
            z = self.z3.get(k)
            local[k] = local_block(v, z.dim, rank, n) if z is not None else v
        return self._layers.load_state_dict(local, *args, **kwargs)

    load_state_dict = set_state_dict

    @torch.no_grad()
    def whole_optimizer_state(self, optimizer):
        """``optimizer.state_dict()`` with every slot of a stage-3
        parameter (shaped like its slice) gathered into the whole array
        (collective over the group)."""
        inner = getattr(optimizer, "_inner", optimizer)
        out = dict(inner.state_dict())
        by_id = {id(z.param): z for z in self.z3.values()}
        for name, slots in inner.state.items():
            z = by_id.get(id(inner._params.get(name)))
            if z is None:
                continue
            for k, v in slots.items():
                if torch.is_tensor(v) and v.shape == z.param.shape:
                    out[f"{name}_{k}"] = gather_along(v, self.group, z.dim)
        return out

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class _Stage3Clip(ClipGradByGlobalNorm):
    """The optimizer's global-norm clip for the eager step of a stage-3
    model: the slices' squares are summed over the group, an mp block's
    over the mp group, a whole parameter's counted once. The train step
    reads ``clip_norm`` and ``auto_skip_clip`` and clips over its own
    groups."""

    def __init__(self, clip, stage3, inner):
        super().__init__(clip.clip_norm, auto_skip_clip=getattr(
            clip, "auto_skip_clip", False))
        self._stage3, self._inner = stage3, inner

    @torch.no_grad()
    def clip_(self, grads):
        from ...collective import axis_group
        from ..hybrid_parallel_optimizer import hybrid_clip_

        params = list(self._inner._params.values())
        mp = axis_group("mp")
        if len(params) != len(grads) or (self._stage3.group.nranks == 1
                                         and mp.nranks == 1):
            return super().clip_(grads)
        sliced = {id(z.param) for z in self._stage3.z3.values()}
        keep = [i for i, g in enumerate(grads) if g is not None]
        hybrid_clip_(self, [grads[i] for i in keep],
                     mp_split=[mp.nranks > 1 and "mp" in spec_axes(
                         getattr(params[i], "dist_spec", None) or ())
                         for i in keep],
                     sliced=[id(params[i]) in sliced for i in keep],
                     mp_group=mp, sharding_group=self._stage3.group)


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           **kwargs):
    """``level``: ``"os"`` (stage 1: sharded optimizer state), ``"os_g"``
    (stage 2: and sharded gradients), ``"p_g_os"`` (stage 3: and the
    parameters themselves, gathered on use: ``GroupShardedStage3``)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"level must be os|os_g|p_g_os, got {level!r}")
    if level == "p_g_os":
        model = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                   sync_buffers=sync_buffers,
                                   offload=offload)
        return model, optimizer, scaler
    optimizer = GroupShardedOptimizerStage2(None, optimizer, group=group,
                                            offload=offload)
    if level == "os_g":
        model = GroupShardedStage2(model, optimizer, group=group,
                                   sync_buffers=sync_buffers)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the wrapped model's ``state_dict`` to ``output.pdparams`` and
    the optimizer's to ``output.pdopt`` (``framework.io.save``). Stages 1
    and 2: this rank's tensors (the global arrays of a sharded run come
    from the train step's ``state_for_checkpoint()``). Stage 3: the whole
    arrays, the parameters' and their optimizer slots', gathered over the
    group (collective: every rank calls it) and written by the group's
    first rank."""
    from ....framework import io as fio

    base = output[:-len(".pdparams")] if output.endswith(".pdparams") \
        else output
    if isinstance(model, GroupShardedStage3):
        sd = model.state_dict()
        osd = model.whole_optimizer_state(optimizer) \
            if optimizer is not None else None
        if max(model.group.rank, 0) != 0:
            return
    else:
        sd = getattr(model, "_layers", model).state_dict()
        osd = optimizer.state_dict() if optimizer is not None else None
    fio.save(sd, base + ".pdparams")
    if osd is not None:
        fio.save(osd, base + ".pdopt")


def _moved(t, dim):
    return t if dim == 0 else t.movedim(dim, 0)


class ZeroPartition:
    """The slices of a sharded optimizer: ``dims[name]`` is the dimension
    of parameter ``name``'s (local) tensor along which this rank holds
    chunk ``rank`` of its state, over ``group`` (None: the whole state).
    ``stage`` 2 and 3 reduce-scatter the gradients into slices. The names
    in ``z3`` are stage-3 parameters: the parameter is already the slice
    (of a whole tensor ``zero3_shape``) and its gradient the slice's."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 dims: Dict[str, Optional[int]], group, stage: int, z3=()):
        self.group, self.stage = group, stage
        self.n, self.rank = group.nranks, max(group.rank, 0)
        self.params = params
        self.dims = {k: d for k, d in dims.items() if d is not None}
        self.z3 = set(z3)
        self.views = {}
        for name, d in self.dims.items():
            p = params[name]
            if name in self.z3:
                self.views[name] = p
                continue
            c = p.shape[d] // self.n
            v = p.detach().narrow(d, self.rank * c, c)
            self.views[name] = v if d == 0 else v.contiguous()
        self.slice_grads = {}

    def slice(self, name, t):
        """This rank's slice of ``t``, shaped like parameter ``name``'s
        whole tensor."""
        d = self.dims.get(name)
        return t if d is None else local_block(t, d, self.rank, self.n)

    def _by_dtype(self, names):
        out = {}
        for name in names:
            if name not in self.z3:
                out.setdefault(self.params[name].dtype, []).append(name)
        return out.items()

    @torch.no_grad()
    def reduce_scatter_grads(self):
        """Stages 2 and 3: each sliced gradient's SUM over the group, this
        rank's slice kept (``slice_grads``) and divided by the group's
        size; the whole gradients are released. Unsliced gradients are
        averaged whole. One reduce-scatter per dtype; a stage-3
        parameter's gradient is its slice's already."""
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

    def take_slices(self, grads):
        """Stages 2 and 3 after a reduction over every data axis (the
        gradient reducer): each sliced gradient's slice of the reduced
        whole ``grads[name]``, kept as ``slice_grads`` (a stage-3
        parameter's as its ``.grad``)."""
        for name in self.dims:
            g = self.slice(name, grads[name]).contiguous()
            if name in self.z3:
                self.params[name].grad = g
            else:
                self.slice_grads[name] = g
                self.params[name].grad = None

    def grads(self):
        """``{name: gradient}`` the update reads: the slices for sliced
        parameters, the whole gradient for the others."""
        out = {}
        for name, p in self.params.items():
            if name in self.z3:
                out[name] = p.grad
            elif name in self.dims:
                out[name] = (self.slice_grads[name] if self.stage >= 2
                             else self.slice(name, p.grad)
                             if p.grad is not None else None)
            else:
                out[name] = p.grad
        return out

    @torch.no_grad()
    def update(self, optimizer, grads, lr):
        """The optimizer's update of every sliced parameter's slice and of
        every other parameter whole, in place; the slices of the
        parameters that are not stage 3's are then gathered over the
        group into the whole parameters (one gather per dtype)."""
        named = {}
        for name, p in self.params.items():
            g = grads.get(name)
            t = self.views.get(name, p)
            if name in self.dims and self.dims[name] != 0 \
                    and name not in self.z3:
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
