"""Explicit gradient reduction over process groups
(``paddle_tpu/distributed/comm_opt/reduce.py`` analog).

The ``GradReducer`` runs the JAX package's per-bucket schedule on this
rank's gradients, with the collectives of ``torch.distributed`` over the
rank's groups along the data axes:

  flatten leaves into buckets (fp32, zero-padded) -> [x 1/scale]
  -> [+ error-feedback residual]
  -> per stage: quantize as n chunks -> all-to-all payload and scales
     over the stage's group -> dequantize -> sum      (a reduce-scatter)
  -> divide by world (gradients are means of per-rank local means)
  -> quantize the owned shard once -> all-gather payload and scales back
     up the stages in reverse -> dequantize -> [x scale] -> unflatten.

A stage is one data axis (``hierarchical``, in ``resolved_axis_order``)
or all of them at once (flat). Within a stage group a rank's position is
the row-major fold of its coordinates along the stage's axes, first axis
outermost, as the JAX package orders the replica groups of an axis
tuple; chunk ``j`` of a stage goes to position ``j`` whatever the ranks'
numbers. ``fp32`` mode runs a reduce-scatter per stage, scales by
1/world and all-gathers back (hierarchical), or one all-reduce over the
data axes and the scale (flat).

Error feedback: each rank keeps one fp32 residual row of the bucket's
padded length, in local-gradient units, added to its local gradient
before compression on the next step. A stage's compression error enters
the sum with weight one and is stored as it is; the broadcast's error is
in mean units and is stored times world. In a checkpoint the rows of a
bucket form one ``[world * groups, padded]`` array (``bucket{i:03d}``),
row ``i`` the rank at position ``i`` of the data axes then the model
axes, the JAX package's layout.

On a mesh whose non-data axes of size above 1 are all model axes
(``mp``, a non-batch ``sharding``), each model shard's data group reduces
its own blocks independently: the plan is built from the model-shard
local shapes (``_localize``), every leaf block-aligned when quantized,
and ``fp32`` runs flat, as the JAX package forces it there. The JAX
package's two-region ``shard_map`` schedule, which exists for its
partitioner, has no counterpart here: each rank already holds its
blocks.

``record_reduce_metrics`` (the ``comm.*`` metrics) belongs to ROADMAP
queue A item A6 and raises; the ``comm-quant-downgrade`` finding that the
JAX package records for its analyzers (A7) is not kept.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import replace as _replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...kernels.quant import dequantize_block_scaled, quantize_block_scaled
from ..collective import group_of
from ..communication import (all_reduce, all_to_all_blocks, gather_blocks,
                             reduce_scatter_blocks)
from ..parallel import get_rank
from .config import QUANT_COMPATIBLE_AXES, GradReduceConfig
from .plan import ReducePlan, build_plan

__all__ = ["GradReducer", "reducer_for_step", "record_reduce_metrics",
           "QUANT_COMPATIBLE_AXES"]

_F32 = np.float32


def mesh_axis_group(mesh, axes, name=None):
    """This rank's group along ``axes`` of ``mesh`` (collective: every rank
    builds every group of the axes, in one order)."""
    me, mine = get_rank(), None
    for ranks in mesh.groups_along(axes):
        g = group_of(ranks, mesh, ",".join(axes) or None, name=name)
        if me in ranks:
            mine = g
    return mine


def _fold(coords, axes, sizes) -> int:
    """Row-major index over ``axes``, the first outermost."""
    i = 0
    for a in axes:
        i = i * sizes[a] + coords[a]
    return i


class _Stage:
    """This rank's group along a stage's axes and every member's position
    in the JAX package's order (``perm[k]``: the position of the group's
    ``k``-th rank)."""

    def __init__(self, mesh, axes, group_fn):
        self.axes = tuple(axes)
        self.group = group_fn(self.axes)
        sizes = mesh.shape
        self.perm = [_fold(mesh.coords(r), self.axes, sizes)
                     for r in self.group.ranks]
        self.n = len(self.perm)
        self.pos = _fold(mesh.coords(get_rank()), self.axes, sizes)

    def _to_ranks(self, x):
        """Rows indexed by position -> rows in the group's rank order."""
        return x[self.perm] if self.perm != list(range(self.n)) else x

    def _to_positions(self, rows):
        if self.perm == list(range(self.n)):
            return rows
        out = torch.empty_like(rows)
        out[self.perm] = rows
        return out

    def all_to_all(self, x):
        """``x [n, C]``, row ``j`` for position ``j`` -> ``[n, C]``, row
        ``j`` from position ``j``."""
        return self._to_positions(all_to_all_blocks(self._to_ranks(x),
                                                    self.group))

    def reduce_scatter(self, v):
        """The SUM over the group of chunk ``pos`` of ``v``."""
        return reduce_scatter_blocks(
            self._to_ranks(v.reshape(self.n, -1)), self.group)

    def all_gather(self, v):
        """Every position's ``v``, concatenated in position order."""
        blocks = gather_blocks(v, self.group)
        ordered = [None] * self.n
        for k, b in enumerate(blocks):
            ordered[self.perm[k]] = b
        return torch.cat(ordered)

    def all_reduce(self, v):
        all_reduce(v, group=self.group)
        return v


def _blocks(q, s, bs):
    """``q [..., C]`` as fp32 blocks ``[..., C/bs, bs]`` and ``s`` as
    ``[..., C/bs, 1]`` (bf16: ``q`` as fp32 and a scale of one)."""
    if s is None:
        return q.float(), None
    return q.float().reshape(q.shape[:-1] + (-1, bs)), s[..., None]


def _minus_dequantized(v, q, s, bs):
    """``v - dequantize(q, s)`` as one fused multiply-add per element
    (``addcmul``), as XLA's CPU backend fuses the JAX package's stage
    error (and not its broadcast error: there the product is rounded
    first)."""
    b, sc = _blocks(q, s, bs)
    if sc is None:
        return v - b.reshape(v.shape)
    return torch.addcmul(v.reshape(b.shape), b, sc, value=-1).reshape(
        v.shape)


def _sum_dequantized(q, s, bs):
    """``sum_j dequantize(q[j], s[j])`` over the rows in order, from +0,
    one fused multiply-add per row and element: the JAX package's reduce
    as XLA's CPU backend fuses it (a -0 sum is +0)."""
    b, sc = _blocks(q, s, bs)
    acc = torch.zeros_like(b[0])
    for j in range(b.shape[0]):
        if sc is None:
            acc += b[j]
        else:
            acc = torch.addcmul(acc, b[j], sc[j])
    return acc.reshape(q.shape[1:])


class GradReducer:
    """Bucketed quantized/hierarchical gradient reduction for one step.

    Construct it through ``reducer_for_step``, which owns the activation
    rules (collective: every rank builds it, in one order).
    ``templates`` is ``{name: (shape, dtype)}`` of the gradients, the
    same on every rank (global shapes; with ``grad_specs`` on a hybrid
    mesh, each localized to its model shard). ``group_fn(axes)`` returns
    this rank's group along mesh axes (default: one built over
    ``mesh.groups_along``)."""

    def __init__(self, config: GradReduceConfig, mesh,
                 templates: Dict[str, Tuple[Tuple[int, ...], object]],
                 data_axes: Tuple[str, ...], hybrid: bool = False,
                 grad_specs: Optional[Dict[str, Tuple]] = None, *,
                 group_fn=None):
        if hybrid and not config.quantized and config.hierarchical:
            # as the JAX package: the hybrid fp32 reduction is one flat
            # all-reduce per bucket over the data axes
            config = _replace(config, hierarchical=False)
        self.hybrid = bool(hybrid)
        self.config = config
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        sizes = mesh.shape
        self.model_axes: Tuple[str, ...] = tuple(
            a for a in mesh.axis_names
            if a not in self.data_axes and sizes[a] > 1) if hybrid else ()
        self._grad_specs: Dict[str, Tuple] = {}
        shapes = {n: tuple(shape) for n, (shape, _) in templates.items()}
        if self.hybrid:
            shapes = {n: self._localize(n, s, grad_specs)
                      for n, s in shapes.items()}
        self.shapes = shapes
        self.plan: ReducePlan = build_plan(
            shapes, {a: sizes[a] for a in self.data_axes}, config,
            group_axes={a: sizes[a] for a in self.model_axes})
        self.world = self.plan.world
        self.groups = self.plan.groups
        self._dtypes = {n: dt for n, (_, dt) in templates.items()}
        axes = list(self.plan.axes)
        if config.hierarchical or len(axes) <= 1:
            self._stages = [(a, n) for a, n in axes]
        else:
            self._stages = [(tuple(a for a, _ in axes), self.world)]
        group_fn = group_fn or (lambda ax: mesh_axis_group(mesh, ax))
        self._groups = [
            _Stage(mesh, ax if isinstance(ax, tuple) else (ax,), group_fn)
            for ax, _n in self._stages]
        self._ef_stage = _Stage(mesh, self.ef_axes, group_fn) \
            if self.has_ef else None

    def _localize(self, name, shape, grad_specs):
        """Model-shard-local leaf shape: each dim divided by the degree of
        the model axes its grad spec entry names (data-axis entries are
        dropped)."""
        sizes = self.mesh.shape
        raw = tuple((grad_specs or {}).get(name) or ())
        entries, local = [], []
        for i, d in enumerate(shape):
            e = raw[i] if i < len(raw) else None
            names = e if isinstance(e, tuple) else ((e,) if e else ())
            kept = tuple(a for a in names if a in self.model_axes)
            deg = int(np.prod([sizes[a] for a in kept], dtype=np.int64)) \
                if kept else 1
            if d % deg:
                raise ValueError(
                    f"grad leaf {name!r} dim {i} ({d}) not divisible by "
                    f"its model-axis shard degree {deg} ({kept})")
            entries.append(kept if len(kept) > 1 else
                           (kept[0] if kept else None))
            local.append(d // deg)
        while entries and entries[-1] is None:
            entries.pop()
        self._grad_specs[name] = tuple(entries)
        return tuple(local)

    @property
    def ef_axes(self) -> Tuple[str, ...]:
        """The axes a residual row is indexed by: the data axes, then the
        model axes on hybrid meshes."""
        return self.data_axes + self.model_axes

    @property
    def stage_axes(self):
        """The reduction stages' axes, in order."""
        return [ax for ax, _n in self._stages]

    # ---------------- error-feedback state ----------------
    @property
    def has_ef(self) -> bool:
        return (self.config.quantized and self.config.error_feedback
                and self.world > 1)

    def _ef_key(self, bucket_index: int) -> str:
        return f"bucket{bucket_index:03d}"

    def init_ef(self) -> Dict[str, np.ndarray]:
        """Zero residuals in the checkpoint's form: one ``[world * groups,
        padded_length]`` fp32 array per bucket."""
        if not self.has_ef:
            return {}
        return {self._ef_key(b.index):
                np.zeros((self.world * self.groups, b.padded_length),
                         np.float32)
                for b in self.plan.buckets}

    def ef_matches(self, ef) -> bool:
        """Whether a restored residual tree fits this plan (a topology or
        bucket-layout change invalidates residuals: reset them)."""
        if not self.has_ef:
            return not ef
        want = {self._ef_key(b.index):
                (self.world * self.groups, b.padded_length)
                for b in self.plan.buckets}
        try:
            got = {k: tuple(np.shape(v)) for k, v in dict(ef).items()}
        except Exception:
            return False
        return got == want

    @property
    def ef_row(self) -> int:
        """This rank's row of the residual arrays."""
        return self._ef_stage.pos if self._ef_stage is not None else 0

    def local_ef(self, ef, device) -> Dict[str, torch.Tensor]:
        """This rank's rows of a residual tree in the checkpoint's form
        (tensor or numpy leaves), as fp32 tensors on ``device``."""
        r = self.ef_row
        return {k: torch.as_tensor(np.asarray(v, np.float32)[r]
                                   if not isinstance(v, torch.Tensor)
                                   else v[r]).to(device, torch.float32)
                .clone() for k, v in dict(ef).items()}

    def global_ef(self, ef_local) -> Dict[str, torch.Tensor]:
        """Every rank's rows as the checkpoint's ``[world * groups,
        padded]`` arrays (collective over the data and model axes)."""
        if not ef_local:
            return {}
        return {k: self._ef_stage.all_gather(v[None])
                for k, v in sorted(ef_local.items())}

    # ---------------- the reduction ----------------
    @torch.no_grad()
    def reduce(self, grads, ef_local, inv_scale=None):
        """``(grads, residuals) -> (reduced grads, new residuals)``.

        ``grads`` is ``{name: tensor}`` of this rank's local gradients
        (any float dtype; reduced in fp32 and cast back); ``ef_local`` is
        ``{bucket: [padded] fp32}``, this rank's rows; ``inv_scale`` (an
        fp32 0-dim tensor or None) unscales loss-scaled gradients before
        the residual is added and rescales after, so residuals stay in
        unscaled units."""
        cfg = self.config
        out = dict(grads)
        new_ef = dict(ef_local)
        dev = next(iter(grads.values())).device
        for b in self.plan.buckets:
            v = torch.zeros(b.padded_length, dtype=torch.float32, device=dev)
            for s in b.leaves:
                g = grads[s.name]
                if tuple(g.shape) != s.shape:
                    raise ValueError(f"grad {s.name!r} is {tuple(g.shape)}, "
                                     f"the plan's leaf is {s.shape}")
                v[s.offset:s.offset + s.size] = g.reshape(-1)
            if inv_scale is not None:
                v = v * inv_scale
            key = self._ef_key(b.index)
            ef_b = ef_local.get(key) if self.has_ef else None
            if ef_b is not None:
                v = v + ef_b
            if cfg.quantized and self.world > 1:
                red, err = self._reduce_bucket_quant(v, ef_b is not None)
                if ef_b is not None:
                    new_ef[key] = err
            elif self.world > 1:
                red = self._reduce_bucket_fp32(v)
            else:
                red = v
            if inv_scale is not None:
                red = red / inv_scale
            for s in b.leaves:
                out[s.name] = red[s.offset:s.offset + s.size].view(
                    s.shape).to(self._dtypes[s.name])
        return out, new_ef

    def _reduce_bucket_fp32(self, v):
        """Hierarchical: a reduce-scatter per stage, the scale, then the
        all-gathers in reverse; flat: one all-reduce and the scale. Each
        sum is taken from +0, as XLA's collectives take it (a sum of -0s
        is +0)."""
        inv = float(_F32(1.0 / self.world))
        if self.config.hierarchical and len(self._groups) > 1:
            cur = v
            for st in self._groups:
                cur = st.reduce_scatter(cur) + 0.0
            cur = cur * inv
            for st in reversed(self._groups):
                cur = st.all_gather(cur)
            return cur
        return (self._groups[0].all_reduce(v.clone()) + 0.0) * inv

    def _reduce_bucket_quant(self, v, ef: bool):
        """Block-scaled compressed reduce of one flat bucket ``[L]``: per
        stage, quantize as n chunks, exchange chunk j with position j,
        dequantize and sum (in position order); then divide by world,
        quantize the owned shard once and all-gather payload and scales
        back up the stages."""
        cfg = self.config
        bs = cfg.block_size
        err = None
        cur, cur_len, start = v, v.numel(), 0
        for k, st in enumerate(self._groups):
            C = cur_len // st.n
            x = cur.reshape(st.n, C)
            q, s = quantize_block_scaled(x, bs, cfg.dtype)
            if ef:
                e = _minus_dequantized(cur, q, s, bs)
                if k == 0:
                    err = e
                else:
                    err[start:start + cur_len] += e
            qr = st.all_to_all(q)
            sr = None if s is None else st.all_to_all(s)
            cur = _sum_dequantized(qr, sr, bs)
            start += st.pos * C
            cur_len = C
        cur = cur * float(_F32(1.0 / self.world))
        q, s = quantize_block_scaled(cur, bs, cfg.dtype)
        if ef:
            # the broadcast's error is in mean units; reintroduced through
            # one rank's local gradient it is divided by world again
            e = (cur - dequantize_block_scaled(q, s, bs)) \
                * float(_F32(self.world))
            err[start:start + cur_len] += e
        for st in reversed(self._groups):
            q = st.all_gather(q)
            if s is not None:
                s = st.all_gather(s)
        return dequantize_block_scaled(q, s, bs), err


def reducer_for_step(config: GradReduceConfig, mesh,
                     data_axes: Tuple[str, ...],
                     templates: Dict[str, Tuple[Tuple[int, ...], object]],
                     warn: bool = True,
                     grad_specs: Optional[Dict[str, Tuple]] = None, *,
                     group_fn=None) -> Optional[GradReducer]:
    """The activation rules: a ``GradReducer``, or None meaning "the step
    keeps its own reduction".

    - mode off, or a data world of one: None.
    - every non-data axis of size 1: a full reducer.
    - the non-data axes above 1 all in ``QUANT_COMPATIBLE_AXES``: a hybrid
      reducer, one independent reduction per model shard's data group.
    - any other non-data axis above 1: None, with a warning naming it.
    """
    if not config.active:
        return None
    sizes = mesh.shape
    data_axes = tuple(a for a in data_axes if a in sizes)
    world = math.prod(sizes[a] for a in data_axes) if data_axes else 1
    if world <= 1:
        return None
    nondata = {a: n for a, n in sizes.items()
               if a not in data_axes and n > 1}
    if not nondata:
        return GradReducer(config, mesh, templates, data_axes,
                           group_fn=group_fn)
    blocked = {a: n for a, n in nondata.items()
               if a not in QUANT_COMPATIBLE_AXES}
    if blocked:
        if warn:
            warnings.warn(
                f"grad_reduce mode={config.mode!r} disabled: mesh axes "
                f"{blocked} are active non-data axes with no hybrid "
                "reduction path (only model-parallel axes "
                f"{QUANT_COMPATIBLE_AXES} can stay around the reduction) "
                "— the step keeps its own all-reduce", stacklevel=3)
        return None
    return GradReducer(config, mesh, templates, data_axes, hybrid=True,
                       grad_specs=grad_specs, group_fn=group_fn)


def record_reduce_metrics(reducer: GradReducer, steps: int = 1,
                          reductions_per_step: int = 1):
    """The ``comm.grad_reduce.*`` metrics: observability is ROADMAP queue
    A item A6, not ported yet."""
    raise NotImplementedError("record_reduce_metrics: the comm.* metrics "
                              "belong to observability, not ported yet "
                              "(ROADMAP queue A item A6)")
