"""The train step (``paddle_tpu/distributed/fleet/utils.py`` analog), one
device.

``make_sharded_train_step(model, optimizer)`` returns a callable
``step(x, y, lr=None) -> loss`` with the JAX step's semantics on one
device: the loss through the model's ``forward_with_loss`` unless a
``loss_fn`` is given, gradient accumulation over ``accumulate_steps``
microbatches (microbatch ``m`` is rows ``m::M``; losses and gradients are
averaged), global-norm clipping when the optimizer carries a
``ClipGradByGlobalNorm``, then the optimizer's update at the optimizer's
learning rate (a float or the ``LRScheduler``'s ``last_lr``) unless ``lr``
is given. ``step.run_steps(xs, ys, lr=None)`` takes K steps over stacked
``[K, ...]`` batches at one learning rate and returns the ``[K]`` losses
on the device, the same values as K calls.

PyTorch runs eagerly, so there is nothing to compile; the JAX step's
donated buffers become in-place updates of the model's parameters and the
optimizer state, and its scan over K batches a loop of the same step.

With ``scaler=GradScaler(...)`` the loss is scaled before the backward,
the gradients are unscaled in fp32 and, when any is non-finite, the step
skips the update, leaving parameters and optimizer state as they were;
the scaler's ``(scale, good, bad)`` automaton then advances as the JAX
step's does, and the loss is reported unscaled. The JAX step selects old
or new values on the device; the update here happens in place (and Adam's
step powers are host numbers), so whether to skip is read on the host
once per step: the one synchronisation a scaled step makes. Without a
scaler, no step synchronises.

Dropout draws are keyed on ``(seed, step)`` as the JAX step keys its
own: step ``i`` (counted from 1) runs under the device's default
generator seeded with ``mix_seed(seed, i)`` (``paddle_tpu_torch.data``'s
splitmix64 mix, so runs at adjacent seeds never share a step's masks)
inside ``torch.random.fork_rng``, so the caller's RNG stream is left as
it was and a restored step replays the same masks. ``donate`` is accepted: the
port always updates in place.

``state_for_checkpoint()`` returns the JAX step's ``TrainState`` tree
(params and optimizer state by name, ``rng={"seed"}``, ``step`` and the
scaler's ``[scale, good, bad]`` under ``extra.scaler_state``);
``restore_from_checkpoint(tree)`` copies a restored tree, with tensor or
numpy leaves, into the live parameters and state in place.

Over a mesh (``mesh=``, by default the ``fleet.init`` topology's, else
the whole world as one ``dp`` axis) the step runs the parallelisms of its
axes:

- data (``dp``, and ``sharding`` and ``ep``, which carry data as well):
  ``batch_spec`` names the mesh axes dim 0 of a batch is split over (the
  JAX step's default ``PartitionSpec(("dp", "sharding", "ep"))``), and
  each rank passes its *local* rows, the JAX package's multi-process
  contract; a batch whose rows differ across the data group in count
  raises (checked each step over a gloo group on the host). The gradients
  are views into persistent flat buffers (``parallel.GradBuffers``), which
  the backward accumulates into; after it (after all
  ``accumulate_steps`` microbatches) each bucket is all-reduced by SUM
  over the data group in place and each buffer scaled by ``1/world`` in
  its dtype, so the clip's norm and the update are the global batch's;
  the returned loss is the global mean (an AVG all-reduce of the local
  mean, nothing read on the host). With a scaler, the found-inf flag is
  all-reduced with MAX before its host read, so every rank skips the same
  steps. Dropout's key folds in the rank's index over the data axes only
  (never mp: the ranks of an mp group draw the same masks on their
  replicated activations). A model wrapped in ``DataParallel`` must
  average over the data group's ranks;
- tensor parallelism (``mp``): the model's mp layers hold their blocks
  and call their collectives over the hybrid topology's mp group, which
  must be the step's. The replicated parameters get the same gradients on
  every rank of the group and stay bitwise equal; with a clip, the global
  norm sums each mp-split gradient's squares over the group and counts
  each replicated one once;
- ZeRO (``sharding``, with an optimizer marked by
  ``group_sharded_parallel``): each rank updates its slice of every
  parameter with its slice of the optimizer state
  (``meta_parallel.sharding.ZeroPartition``: the first dimension, not
  split over mp, that the degree divides, as ``_state_sharding_like``
  places it), and the slices are gathered back; stage 2 reduce-scatters
  the gradients over the sharding group instead of averaging them there;
  stage 3 (a ``GroupShardedStage3`` model) stores only the slices of the
  parameters it shards, gathers them on use inside the step's forward
  and reduce-scatters their gradients into the slices during the
  backward (after an average over the other data axes), and updates the
  slices in place with nothing gathered after the update; with
  ``accumulate_steps`` above 1 the whole gradients are summed over the
  microbatches first;
- expert parallelism (``ep``, with a GPT-MoE model built after
  ``fleet.init``): each rank holds its ep rank's experts and routes its
  rows over the data axes (``models.gpt.GPTMoEMLP``). The expert stacks'
  gradients are summed over the ranks holding the same experts (dp and
  sharding, never ``ep``) and divided by the whole data group's size,
  through flat buffers of their own; every other gradient is averaged
  over the data group as above. The clip sums the stacks' squares over
  the ep group; ZeRO slices the stacks (and at stage 3 stores them) along
  the dimension ``_state_sharding_like`` gives a ``P("ep", None, None)``
  parameter's state. Over mp the experts are whole on every mp rank, so
  their gradients are not reduced there and their squares are counted
  once. A ``MoELayer(group=)``'s expert modules are its ep rank's
  ``E/n`` experts and are trained as the stacks are; the checkpoint names
  them as the JAX package's layer names all ``E`` (local ``expert_i`` of
  ep rank ``r`` is ``expert_{r*E/n+i}``).

``grad_reduce`` (``None``, a shorthand of ``comm_opt.normalize_grad_reduce``,
a dict or a ``GradReduceConfig``) replaces the all-reduce over the data
axes with ``comm_opt``'s explicit reduction (``reducer_for_step``'s
rules): the gradients of every parameter, whole over the ZeRO axis (which
is a data axis), are flattened into the plan's buckets and reduced in
fp32, bf16 or block-scaled int8 with error feedback; each ZeRO rank then
takes its slice. With a scaler the gradients are unscaled before the
residual is added and rescaled after, and a skipped step leaves the
residuals as they were. With ``accumulate_steps`` above 1 and
``overlap``, each microbatch's gradients are reduced at its boundary and
the reduced means averaged. The residuals (this rank's row of each
bucket) travel in ``state_for_checkpoint().extra["grad_reduce_ef"]`` as
the JAX package writes them, one ``[world * groups, padded]`` array per
bucket, and ``restore_from_checkpoint`` reads them back (a plan they do
not fit resets them, as in the JAX package). At an ep degree above 1 the
reduction takes the JAX step's semantics, whose fully-manual region gets
the parameters whole: each rank routes its own rows alone over the whole
expert stacks (gathered over ep for the step's own forward only,
``GPTMoEMLP.local_ep``), the reducer sums the whole stacks' gradients over
every data axis, ep included, and each rank keeps its ep slice. A
``MoELayer(group=)``'s expert modules go the same way
(``MoELayer.local_ep``): each rank routes its rows over all ``E`` experts,
their stacked weights gathered over ep, every expert's gradient is
reduced under its JAX name (``expert_j``, in the JAX package's
name-sorted buckets) and each rank keeps its own experts'; their experts
must be same-shaped ``ExpertMLP``s (else ``NotImplementedError``).
``moe_dispatch="quant"`` raises there (no ep exchange is left to
compress; the JAX step fails).

Pipeline parallelism (a ``pp`` axis above 1, the model providing
``pipeline_spec()``, as the JAX step asks): each rank keeps its stage's
chunks of the block stack (chunk ``r * pp + stage`` for ``r`` below
``virtual_pp_degree``; the other stages' blocks are dropped from the
model and the optimizer) and the parameters outside it, replicated over
pp. Each step splits the batch into ``accumulate_steps`` (default: the pp
degree) microbatches, rows ``m::M``, and runs them through the schedule
(``meta_parallel.pipeline_parallel``): ``pp_schedule`` ``"1f1b"`` (the
interleaved 1F1B table under ``virtual_pp_degree`` with ``pp_remat``) or
``"gpipe"`` (the interleaved forward-then-backward table under
``virtual_pp_degree``), ``pp_remat`` recomputing each cell's forward in
its backward (the model's own recompute policy does not run inside a
cell, as in the JAX step). Each (microbatch, global chunk) cell runs
under generators seeded from ``mix_seed(step key, m, chunk)``, so
dropout draws the same masks under every schedule and in a recomputed
forward; every schedule runs a chunk's backward cells in microbatch
order, so 1f1b, gpipe and no-remat runs agree to the bit. The gradients
are averaged over the microbatches, those of the parameters every stage
holds (the embeddings, the tied head, the final LayerNorm) summed over
pp before the reduction over the data axes; the clip counts each block on
its stage and each replicated parameter once; the scaler's found-inf
flag is reduced over pp too; the returned loss is the last stage's mean
(plus a MoE model's aux term, summed over pp), on every rank.
``state_for_checkpoint()`` names the blocks as the JAX pp step does,
``{prefix}.__stacked__.<suffix>`` of shape ``[pp, L/pp, ...]`` (``[pp, v,
L/(pp*v), ...]`` under interleaving), each a ``ShardedTensor`` of this
stage's blocks (stacked, a copy) placed ``P("pp", None, *spec)``, and the
optimizer state alike; ``restore_from_checkpoint`` takes such leaves (or
their global arrays) back into the stage's blocks. ZeRO stage 3 and
expert parallelism at pp above 1 raise ``NotImplementedError`` naming
ROADMAP queue A item A5.6b.

``param_specs`` (``{name: PartitionSpec}``) is honoured where the port can
realise the spec: the layer's own; ``PartitionSpec()`` on the weight of
an mp linear (the whole weight on every rank: ``replicate_weight``); and a
``sharding`` entry on a dimension the degree divides, which places that
parameter's optimizer state there. Any other spec raises
``NotImplementedError`` naming ROADMAP queue A item A7 (autoshard's
layouts). ``state_for_checkpoint()`` gives the arrays in the JAX
package's layout: the live tensor where the step holds one whole, a
``ShardedTensor`` of the live block and its placement over mp, ep and
sharding, with nothing gathered (``resharding.gather_tree`` gathers,
counted, where a caller wants whole arrays), so a ``CheckpointManager``
save writes each rank's replica-0 blocks. ``checkpoint_shardings()``
gives the step's placements, which
``CheckpointManager.restore`` honours on any mesh (each rank reads its
blocks, as ``ShardedTensor`` leaves); ``live_state()`` gives the live
blocks as ``ShardedTensor`` leaves, which ``restore(live_state=)`` moves
device to device onto another step's layout through the resharding
executor. ``restore_from_checkpoint`` slices whole arrays, adopts a
``ShardedTensor`` placed as its own and reshards one placed otherwise.
At a world of one with a process group (NCCL at world size 1) the
reductions run and change no bit.

Options of the JAX step that the port has not reached raise
``NotImplementedError`` naming their ROADMAP items: a mesh axis of size
above 1 for context parallelism (A5.7), a batch split along another
dimension than dim 0 (A5.7) and ``health_stats`` (A6). None is silently
ignored; the pipeline options act only at a pp axis above 1, as in the
JAX step.
"""

from __future__ import annotations

import contextlib
import re

import numpy as np
import torch

from ...amp.grad_scaler import inverse, nonfinite_flag
from ...data.protocol import mix_seed
from ...device import resolve_device
from ...nn.clip import ClipGradByGlobalNorm
from ...optimizer.optimizer import _load_slot
from ...weights import to_torch
from ..collective import group_of
from ..comm_opt import normalize_grad_reduce, reducer_for_step
from ..communication import ReduceOp, all_reduce
from ..mesh import (DeviceMesh, NamedSharding, PartitionSpec, device_count,
                    spec_axes)
from ..parallel import DataParallel, GradBuffers, get_rank, grad_buffers
from ..sharding_utils import (EP_AXIS, local_block, placement,
                              resolve_spec, spec_dim)
from ..topology import LATER_AXES, get_hybrid_communicate_group
from .hybrid_parallel_optimizer import hybrid_clip_
from .meta_parallel.mp_layers import _Linear
from .meta_parallel.sharding import (SHARDING_AXIS, GroupShardedStage2,
                                     GroupShardedStage3, ZeroPartition,
                                     state_dim)
from .meta_parallel.tensor_parallel import MetaParallelBase

_ITEM = "ROADMAP queue A item"
_A7 = f"{_ITEM} A7 (autoshard's layouts)"


def _unwrap(model):
    """The model inside fleet's and ZeRO's wrappers, the ranks of a
    ``DataParallel`` wrapper's group (None without one), the ZeRO stage a
    ``GroupShardedStage2`` or ``GroupShardedStage3`` wrapper asks for (0
    without one) and the stage-3 wrapper (None without one)."""
    ranks, stage, stage3 = None, 0, None
    while isinstance(model, (DataParallel, MetaParallelBase,
                             GroupShardedStage2, GroupShardedStage3)):
        if isinstance(model, DataParallel):
            ranks = model.group.ranks
        if isinstance(model, GroupShardedStage2):
            stage = 2
        if isinstance(model, GroupShardedStage3):
            stage, stage3 = 3, model
        model = model._layers
    return model, ranks, stage, stage3


def _drop_axis(spec, axis) -> PartitionSpec:
    out = []
    for e in spec:
        kept = tuple(a for a in spec_axes(e) if a != axis)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _mp_split(p) -> bool:
    """Whether ``p`` is this rank's block of a tensor split over mp."""
    return getattr(p, "mp_dim", None) is not None \
        and "mp" in spec_axes(getattr(p, "dist_spec", ()) or ())


class ShardedTrainStep:
    """Holds the model's named parameters and runs one optimizer step per
    call. Batches (token ids ``[B, S]`` as tensors or numpy arrays; over
    data axes, this rank's rows) are moved to ``device``, which defaults
    to ``cuda``; the model must already live there."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 batch_spec=PartitionSpec(("dp", "sharding", "ep")),
                 donate=True, seed=0, accumulate_steps=None,
                 pp_remat=True, virtual_pp_degree=1, pp_schedule="1f1b",
                 scaler=None, grad_reduce=None, health_stats=None,
                 param_specs=None, *, device=None):
        if health_stats:
            raise NotImplementedError(f"make_sharded_train_step: health_stats "
                                      f"is not ported yet ({_ITEM} A6 "
                                      "(observability))")
        if param_specs is not None and not isinstance(param_specs, dict):
            raise NotImplementedError(
                f"param_specs must be a {{name: PartitionSpec}} table, got "
                f"{type(param_specs).__name__} ({_A7})")
        self._grad_reduce = normalize_grad_reduce(grad_reduce)
        model, wrapper, stage, stage3 = _unwrap(model)
        self._stage3 = stage3
        self._seed = int(seed)
        self._donate = donate
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        if mesh is None:
            hcg = get_hybrid_communicate_group()
            mesh = hcg.get_mesh() if hcg is not None \
                else DeviceMesh(np.arange(device_count()), ("dp",))
        off = sorted(n for n, p in model.named_parameters()
                     if p.device.type != self.device.type)
        if off:
            raise ValueError(f"model parameters {off[:3]} are not on "
                             f"{self.device}; build the model there")
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"{type(clip).__name__}: only ClipGradByGlobalNorm is ported")
        self._clip = clip
        self._pp_n = mesh.shape.get("pp", 1)
        self._pspec = None
        if self._pp_n > 1:
            self._setup_pipeline(mesh, accumulate_steps, pp_remat,
                                 virtual_pp_degree, pp_schedule, param_specs)
        self.params = dict(model.named_parameters())
        self._scaler = scaler if scaler is not None and scaler.is_enable() \
            else None
        self._use_fwl = loss_fn is None and hasattr(model, "forward_with_loss")
        self.loss_fn = loss_fn if loss_fn is not None \
            else getattr(model, "loss", None)
        if self._pspec is None:
            if not self._use_fwl and self.loss_fn is None:
                raise ValueError(f"{type(model).__name__} has no .loss/"
                                 ".forward_with_loss; pass loss_fn= to "
                                 "make_sharded_train_step")
            self._accum = accumulate_steps if accumulate_steps else 1
        self._step_i = 0  # optimizer steps taken, as the JAX step counts
        self._init_parallel(mesh, batch_spec, wrapper, stage,
                            param_specs or {})
        optimizer.init_state(self._state_targets())

    # ---------- pipeline parallelism ----------
    def _setup_pipeline(self, mesh, accumulate_steps, remat, vpp, schedule,
                        param_specs):
        """The model's ``PipelineSpec``, this rank's chunks of blocks (the
        other stages' blocks dropped from the model and the optimizer),
        the microbatch count and the schedule, as the JAX step takes them
        at a pp axis above 1. Every refusal comes before the model or the
        optimizer is changed."""
        from .meta_parallel.pipeline_parallel import (block_param_name,
                                                      stage_chunks)

        pp, model = self._pp_n, self.model
        pipe_b = f"{_ITEM} A5.6b (pipeline parallelism with ZeRO-3 and " \
            "expert parallelism)"
        if self._stage3 is not None:
            raise NotImplementedError(
                f"ZeRO stage 3 (p_g_os) at pp degree {pp} is not ported yet "
                f"({pipe_b})")
        if mesh.shape.get(EP_AXIS, 1) > 1:
            raise NotImplementedError(
                f"expert parallelism at pp degree {pp} is not ported yet "
                f"({pipe_b})")
        if not hasattr(model, "pipeline_spec"):
            raise ValueError(
                f"mesh has pp={pp} but {type(model).__name__} provides no "
                "pipeline_spec(); implement the PipelineSpec protocol "
                "(see meta_parallel.pipeline_parallel)")
        if param_specs:
            raise ValueError("param_specs overrides are not supported with "
                             "pipeline parallelism (pp>1): block params are "
                             "restacked with a pp leading dim")
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"pp_schedule must be '1f1b' or 'gpipe', got "
                             f"{schedule!r}")
        spec = model.pipeline_spec()
        v = max(int(vpp), 1)
        L = spec.n_blocks
        stage = mesh.coords(get_rank())["pp"]
        chunks = stage_chunks(L, stage, pp, v)
        prefix = spec.block_prefix
        box = model.get_submodule(prefix) if prefix else model
        self._my_layers = [i for ch in chunks for i in ch]
        missing = [i for i in self._my_layers
                   if box._modules.get(str(i)) is None]
        if missing:
            raise ValueError(f"the model lacks blocks {missing} of pipeline "
                             f"stage {stage}")
        self._pspec, self._vpp = spec, v
        self._remat, self._pp_schedule = bool(remat), schedule
        self._accum = accumulate_steps if accumulate_steps else pp
        keep = set(self._my_layers)
        for i in range(L):
            if i not in keep and box._modules.get(str(i)) is not None:
                setattr(box, str(i), None)
        self._chunks = [[box._modules[str(i)] for i in ch] for ch in chunks]
        self._block_re = re.compile(
            rf"^{re.escape(prefix)}\.(\d+)\.(.+)$" if prefix
            else r"^(\d+)\.(.+)$")
        first = self._my_layers[0]
        self._suffixes = sorted(
            n for n, _ in box._modules[str(first)].named_parameters())
        self._layer_name = lambda i, sfx: block_param_name(prefix, i, sfx)
        self._stack_prefix = (f"{prefix}." if prefix else "") + "__stacked__."
        live = {id(p) for p in model.parameters()}
        _prune_optimizer(self.optimizer, live)
        #: the last run's schedule facts (``peak_stash``, ``ticks``)
        self.pp_stats = {}
        #: the transfers' shapes by the batch's shape and dtype: a step on a
        #: batch of a shape seen before sends no shape headers
        self._edge_shapes = {}

    def _is_block(self, name) -> bool:
        """Whether ``name`` is a block parameter (pp-split): the others
        every stage holds, replicated over pp."""
        return self._pspec is not None and bool(self._block_re.match(name))

    def _cuda_index(self):
        """The step's card's index (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return self.device.index if self.device.index is not None \
            else torch.cuda.current_device()

    def _reseed(self, key):
        """Seed the default generators of the CPU and the step's card."""
        torch.random.default_generator.manual_seed(key)
        dev = self._cuda_index()
        if dev is not None:
            torch.cuda.default_generators[dev].manual_seed(key)

    def _pipeline_forward_backward(self, x, y, scale):
        """The pp step's forward and backward: microbatch ``m`` (rows
        ``m::M``) through this rank's chunks under the schedule, each cell
        under generators seeded from ``mix_seed(step key, m, chunk)``; the
        gradients averaged over the microbatches and those of the
        parameters every stage holds summed over pp. Returns the mean loss
        (times ``scale``), the same on every pp rank."""
        from .meta_parallel import pipeline_parallel as P

        M, spec, v = self._accum, self._pspec, self._vpp
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accumulate_steps {M}")
        xs = [x[m::M] for m in range(M)]
        ys = [y[m::M] for m in range(M)]
        with_aux = spec.block_with_aux is not None

        def stage_fn(blocks, h, c):
            if c == 0:
                h = spec.pre(h)
            aux = None
            for blk in blocks:
                if with_aux:
                    h, a = spec.block_with_aux(blk, h)
                    aux = a if aux is None else aux + a
                else:
                    h = spec.block(blk, h)
            return (h, aux) if with_aux else h

        key = self._key
        kw = dict(loss_fn=lambda h, m: spec.post_loss(h, ys[m]),
                  aux_weight=spec.aux_weight, grad_scale=scale,
                  cell_seed=lambda m, c: self._reseed(mix_seed(key, m, c)),
                  group=self._pp, device=self.device, stats=self.pp_stats,
                  edge_shapes=self._edge_shapes.setdefault(
                      (tuple(x.shape), x.dtype), {}))
        if v > 1:
            fn = P.pipeline_schedule_interleaved_1f1b \
                if self._pp_schedule == "1f1b" and self._remat \
                else P.pipeline_schedule_interleaved
            out = fn(stage_fn, self._chunks, xs, "pp", self._pp_n,
                     virtual_stages=v, remat=self._remat, with_aux=with_aux,
                     **kw)
        else:
            fn = P.pipeline_schedule_1f1b if self._pp_schedule == "1f1b" \
                else P.pipeline_schedule
            out = fn(stage_fn, self._chunks[0], xs, "pp", self._pp_n,
                     remat=self._remat, with_aux=with_aux, **kw)
        losses, aux = out if with_aux else (out, None)
        total = losses.sum() if losses is not None else torch.zeros(
            (), dtype=torch.float32, device=self.device)
        all_reduce(total, ReduceOp.SUM, group=self._pp)
        if aux is not None:
            total = total + spec.aux_weight * aux
        inv = 1.0 / M
        with torch.no_grad():
            for n, p in self.params.items():
                if M > 1 and p.grad is not None:
                    p.grad.mul_(inv)
                if not self._is_block(n) and p.requires_grad:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    all_reduce(p.grad, ReduceOp.SUM, group=self._pp)
        loss = total * inv
        return loss if scale is None else loss * scale

    # ---------- the mesh, its groups and the placements ----------
    def _axis_group(self, axes, name):
        """This rank's group along ``axes`` of the step's mesh: the hybrid
        topology's when the mesh is its and the axis one of its groups,
        else one over ``group_of`` (collective: every rank builds every
        group of the axes, in one order)."""
        hcg = get_hybrid_communicate_group()
        if len(axes) == 1 and hcg is not None and hcg.get_mesh() == self.mesh \
                and axes[0] in hcg._groups:
            return hcg._groups[axes[0]]
        me, mine = get_rank(), None
        for ranks in self.mesh.groups_along(axes):
            g = group_of(ranks, self.mesh, ",".join(axes) or None, name=name)
            if me in ranks:
                mine = g
        return mine

    def _init_parallel(self, mesh, batch_spec, wrapper, stage, param_specs):
        """The mesh, the batch's data axes and this rank's groups along
        them, along mp and along sharding; the placements of the
        parameters and their optimizer state, ``param_specs`` realised;
        the gradients' buffers (collective: every rank builds the
        step)."""
        self.mesh = mesh
        spec = resolve_spec(batch_spec, mesh)
        if any(e is not None for e in spec[1:]):
            raise NotImplementedError(
                f"batch_spec {spec}: a batch split along another dimension "
                f"than its rows is context parallelism, not ported yet "
                f"({_ITEM} A5.7)")
        data_axes = spec_axes(spec[:1])
        for axis, n in mesh.shape.items():
            if n > 1 and axis in LATER_AXES:
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {n}: the train step runs "
                    f"data, tensor, ZeRO, expert and pipeline parallelism "
                    f"({_ITEM} {LATER_AXES[axis]})")
        if mesh.shape.get(SHARDING_AXIS, 1) > 1 \
                and SHARDING_AXIS not in data_axes:
            raise ValueError(f"batch_spec {spec} leaves out the sharding "
                             "axis, which carries data under ZeRO")
        me = get_rank()
        mesh.coords(me)  # raises unless this rank is on the mesh
        self._dp = self._axis_group(data_axes, "dp_group")
        self._mp = self._axis_group(("mp",) if "mp" in mesh.shape else (),
                                    "mp_group")
        self._sh = self._axis_group(
            (SHARDING_AXIS,) if SHARDING_AXIS in mesh.shape else (),
            "sharding_group")
        self._ep = self._axis_group(
            (EP_AXIS,) if EP_AXIS in mesh.shape else (), "ep_group")
        self._pp = self._axis_group(("pp",) if "pp" in mesh.shape else (),
                                    "pp_group")
        if wrapper is not None and wrapper != self._dp.ranks:
            raise ValueError(
                f"the model's DataParallel averages over ranks "
                f"{wrapper}, the step's dp group is {self._dp.ranks}: "
                "pass the mesh whose data axes are the wrapper's ranks")
        self._dp_world, self._dp_rank = self._dp.nranks, self._dp.rank
        self._check_moe()
        for mod in self.model.modules():
            g = getattr(mod, "mp_group", None)
            if g is not None and g.ranks != self._mp.ranks:
                raise ValueError(
                    f"the model's mp layers run over ranks {g.ranks}, the "
                    f"step's mp group is {self._mp.ranks}: build the model "
                    "after fleet.init, on the step's mesh")
        # stage 3's slices: the parameter is this rank's chunk of dimension
        # zero3_dim of the whole tensor
        self._z3 = {n: p.zero3_dim for n, p in self.params.items()
                    if getattr(p, "zero3_dim", None) is not None}
        if self._z3 and self._stage3 is None:
            raise ValueError("the model holds stage-3 slices: pass the "
                             "GroupShardedStage3 wrapper to the step")
        if self._stage3 is not None \
                and self._stage3.group.ranks != self._sh.ranks:
            raise ValueError(
                f"GroupShardedStage3 shards over ranks "
                f"{self._stage3.group.ranks}, the step's sharding group is "
                f"{self._sh.ranks}: build it on the step's mesh")
        self._realise_specs(param_specs)
        self._zero_stage = max(stage, getattr(self.optimizer, "_zero_stage",
                                              0))
        self._zero = None
        dims = {**self._state_dims, **self._z3}
        if any(d is not None for d in dims.values()):
            self._zero = ZeroPartition(self.params, dims, self._sh,
                                       max(self._zero_stage, 1),
                                       z3=self._z3)
        # stages 2 and 3 average over the data axes but sharding in the
        # buffers and reduce-scatter over sharding after them
        grads_group, grads_axes = self._dp, data_axes
        if self._zero is not None and self._zero.stage >= 2:
            grads_axes = tuple(a for a in data_axes if a != SHARDING_AXIS)
            grads_group = self._axis_group(grads_axes, "dp_only")
        # an ep rank's expert stacks and MoELayer expert modules: summed
        # over its replicas only
        self._experts = {n for n, p in self.params.items()
                         if self._ep.nranks > 1 and EP_AXIS in spec_axes(
                             getattr(p, "dist_spec", None) or ())}
        self._experts |= set(self._ep_local)
        expert_group = self._axis_group(
            tuple(a for a in grads_axes if a != EP_AXIS), "ep_replicas") \
            if self._experts else None
        self._reducer = None
        cfg = self._grad_reduce
        # under the explicit reduction at ep every rank routes its own rows
        # over the whole stacks, whose whole gradients the reducer sums
        self._whole_experts = {}
        self._whole = self._local_routes() if cfg.active else {}
        if cfg.active:
            self._reducer = reducer_for_step(
                cfg, mesh, data_axes, {
                    g: (self._reduced_shape(n, p), p.dtype)
                    for n, p in self.params.items() if p.requires_grad
                    for g in self._reduced_names(n)},
                group_fn=lambda axes: self._axis_group(axes, "grad_reduce"))
        red = self._reducer
        if red is None:
            self._whole, self._whole_experts = {}, {}
        self.ef_state = red.local_ef(red.init_ef(), self.device) \
            if red is not None else {}
        # with overlap, every accumulation microbatch reduces its own
        # gradients (the wire volume per step scales by accumulate_steps)
        self._reductions_per_step = self._accum if (
            red is not None and cfg.overlap and self._accum > 1) else 1
        if self._stage3 is not None:  # the reducer takes whole gradients
            self._stage3.step_mode(
                dp_group=grads_group if red is None else None,
                defer=red is not None, experts=self._experts,
                expert_group=expert_group)
        # the reducer packs the gradients itself: no flat buffers then;
        # the expert stacks' gradients have buffers of their own
        self._grads = self._expert_grads = None
        if red is None:
            self._grads = grad_buffers(
                [p for n, p in self.params.items()
                 if n not in self._z3 and n not in self._experts],
                grads_group)
            stacks = [p for n, p in self.params.items()
                      if n in self._experts and n not in self._z3]
            if stacks and grads_group.nranks > 1:
                self._expert_grads = GradBuffers(stacks, expert_group,
                                                 divisor=grads_group.nranks)
        self._host = None
        if self._dp_world > 1:
            # the rows check runs on the host, on a gloo group of its own
            for ranks in mesh.groups_along(data_axes):
                g = group_of(ranks, backend="gloo")
                if me in ranks:
                    self._host = g

    def _check_moe(self):
        """A MoE block routes over the step's data group and ep group: one
        built before ``fleet.init`` (routing its rank's rows alone) or on
        another mesh cannot join a data world above one. At an ep degree
        above 1 a ``MoELayer``'s expert modules are its ep rank's
        ``E/n`` experts: ``_ep_local`` maps each of their parameters to
        ``(prefix, i, rest, n)`` (``{prefix}expert_{i}.{rest}``, ``n``
        local experts), the global expert being ``r * n + i`` on ep rank
        ``r``, as the JAX package's layer names all ``E``."""
        self._ep_local = {}
        for mname, mod in self.model.named_modules():
            if not hasattr(mod, "gate_weight") or not hasattr(mod, "groups"):
                continue
            g = mod.groups
            data = g.data.ranks if g is not None else [get_rank()]
            ep = g.ep.ranks if g is not None else [get_rank()]
            if data != self._dp.ranks or ep != self._ep.ranks:
                raise ValueError(
                    f"a MoE block routes over ranks {data} (experts split "
                    f"over {ep}), the step's data group is {self._dp.ranks} "
                    f"(ep group {self._ep.ranks}): build the model after "
                    "fleet.init, on the step's mesh")
            experts = getattr(mod, "experts", None)
            if len(ep) == 1 or not isinstance(experts, list):
                continue
            prefix = f"{mname}." if mname else ""
            for i, e in enumerate(experts):
                for rest, _ in e.named_parameters():
                    self._ep_local[f"{prefix}expert_{i}.{rest}"] = (
                        prefix, i, rest, len(experts))

    def _global_names(self, name):
        """The checkpoint names of parameter ``name`` on every ep rank, in
        rank order: a MoELayer expert's global names, else ``[name]``."""
        if name not in self._ep_local:
            return [name]
        prefix, i, rest, n = self._ep_local[name]
        return [f"{prefix}expert_{r * n + i}.{rest}"
                for r in range(self._ep.nranks)]

    def _local_routes(self):
        """``{name: (block, key)}`` of the expert stacks whose blocks route
        locally under the explicit reduction at an ep degree above 1 (the
        JAX step's fully-manual region: parameters whole, each device's
        rows routed alone); and ``_whole_experts``, ``{global name:
        (layer, key, expert)}`` of a MoELayer's expert parameters there,
        each reduced under its JAX name from the layer's gathered
        ``whole_grads[key][expert]``."""
        from ...incubate.distributed.models.moe.moe_layer import STACK_KEYS

        if self._ep.nranks == 1:
            return {}
        out = {}
        for mname, mod in self.model.named_modules():
            if not hasattr(mod, "whole_grads"):
                continue
            mode = getattr(mod, "dispatch_mode", None) \
                or getattr(getattr(mod, "cfg", None), "moe_dispatch", None)
            if mode == "quant":
                raise ValueError(
                    "moe_dispatch='quant' with grad_reduce at ep degree "
                    f"{self._ep.nranks}: each rank routes its own rows over "
                    "the whole expert stacks there, so no ep exchange is "
                    "left to compress (the JAX step fails at this "
                    "combination: its region hands whole stacks an ep "
                    "rank's dispatch slots); route dense")
            if isinstance(getattr(mod, "experts", None), list):
                if not mod.fusable():
                    raise NotImplementedError(
                        f"grad_reduce at ep degree {self._ep.nranks} over "
                        f"MoELayer {mname!r}: its experts run gathered as "
                        "stacks there, which same-shaped ExpertMLPs alone "
                        f"make ({_ITEM} A5.4d)")
                prefix = f"{mname}." if mname else ""
                n = len(mod.experts)
                for j in range(n * self._ep.nranks):
                    for key in STACK_KEYS:
                        self._whole_experts[f"{prefix}expert_{j}.{key}"] = (
                            mod, key, j)
                continue
            for key in ("w1", "b1", "w2", "b2"):
                out[f"{mname}.{key}"] = (mod, key)
        return out

    def _local_mods(self):
        """The MoE blocks and layers that route locally in the step's own
        forward, each once."""
        mods = [m for m, _ in self._whole.values()] \
            + [m for m, _, _ in self._whole_experts.values()]
        return list({id(m): m for m in mods}.values())

    def _reduced_names(self, name):
        """The names parameter ``name``'s gradient is reduced under: a
        locally routed MoELayer expert's every ep rank's global name (the
        reducer takes all ``E`` experts' gradients, as the JAX layer holds
        them), else ``[name]``."""
        if self._whole_experts and name in self._ep_local:
            return self._global_names(name)
        return [name]

    def _reduced_shape(self, name, p):
        """The shape of ``name``'s gradient in the explicit reduction: the
        whole parameter (a stage-3 slice's whole, a locally routed
        stack's every expert)."""
        shape = tuple(getattr(p, "zero3_shape", p.shape))
        if name in self._whole:
            shape = (shape[0] * self._ep.nranks,) + shape[1:]
        return shape

    def _realise_specs(self, param_specs):
        """Each parameter's placement: its layer's spec, or the one
        ``param_specs`` gives where the port can realise it; and the
        dimension of its optimizer state split over sharding, if any."""
        unknown = sorted(set(param_specs) - set(self.params))
        if unknown:
            raise KeyError(f"param_specs names no parameter of the model: "
                           f"{unknown[:4]}")
        for name, want in param_specs.items():
            p = self.params[name]
            own = resolve_spec(getattr(p, "dist_spec", None), self.mesh)
            core = _drop_axis(resolve_spec(want, self.mesh), SHARDING_AXIS)
            if core == own:
                continue
            owner = self.model.get_submodule(name.rpartition(".")[0])
            if core == PartitionSpec() and isinstance(owner, _Linear) \
                    and name.endswith(".weight") and _mp_split(p):
                owner.replicate_weight()
                continue
            raise NotImplementedError(
                f"param_specs[{name!r}] = {want!r}: the port realises the "
                f"layer's own spec {own!r}, PartitionSpec() on an mp "
                f"linear's weight and the sharding axis on the optimizer "
                f"state, not this layout ({_A7})")
        self.params = dict(self.model.named_parameters())
        zero = getattr(self.optimizer, "_shard_state_axis", None) \
            == SHARDING_AXIS
        n = self._sh.nranks
        self._state_dims = {}
        for name, p in self.params.items():
            if name in self._z3:  # the parameter is already its slice
                want = param_specs.get(name)
                d = spec_dim(resolve_spec(want, self.mesh), SHARDING_AXIS) \
                    if want is not None else None
                if d not in (None, self._z3[name]):
                    raise NotImplementedError(
                        f"param_specs[{name!r}] = {want!r}: stage 3 holds "
                        f"this parameter's slice of dimension "
                        f"{self._z3[name]} ({_A7})")
                self._state_dims[name] = None
                continue
            # as _state_sharding_like: every dimension the parameter's
            # spec places on an axis of the mesh is taken
            taken = {i for i, e in enumerate(resolve_spec(
                getattr(p, "dist_spec", None), self.mesh)) if e is not None}
            want = param_specs.get(name)
            d = spec_dim(resolve_spec(want, self.mesh), SHARDING_AXIS) \
                if want is not None else None
            if d is not None and n > 1:
                if d in taken or d >= p.dim() or p.shape[d] % n:
                    raise NotImplementedError(
                        f"param_specs[{name!r}] = {want!r}: the optimizer "
                        f"state of a {tuple(p.shape)} block cannot split "
                        f"dimension {d} over {n} sharding ranks ({_A7})")
            elif zero:
                d = state_dim(p.shape, n, taken)
            self._state_dims[name] = d if n > 1 else None

    def _state_targets(self):
        """What the optimizer's state is shaped like, by name: this rank's
        ZeRO slice of a parameter, or the parameter."""
        views = self._zero.views if self._zero is not None else {}
        return {n: views.get(n, p) for n, p in self.params.items()}

    def _batch(self, a):
        return torch.as_tensor(a).to(self.device)

    @contextlib.contextmanager
    def _routed_locally(self):
        """The step's own forward under the explicit reduction at ep: each
        GPT-MoE block routes this rank's rows alone over its whole stacks
        (``GPTMoEMLP.local_ep``), and routes globally again after it."""
        mods = self._local_mods()
        for m in mods:
            m.local_ep = self._ep
        try:
            yield
        finally:
            for m in mods:
                m.local_ep = None

    def _loss(self, x, y):
        scope = self._stage3.forward_scope() if self._stage3 is not None \
            else contextlib.nullcontext()
        with scope, self._routed_locally():
            if self._use_fwl:
                return self.model.forward_with_loss(x, y).float()
            return self.loss_fn(self.model(x), y).float()

    def _forward_backward(self, x, y, scale):
        """The (mean) loss, times ``scale`` when given, with the gradients
        of that value in the parameters' ``.grad`` (a stage-3 slice's, or
        in deferred mode the stage-3 wrapper's whole sums)."""
        M = self._accum
        if M <= 1:
            loss = self._loss(x, y)
            if scale is not None:
                loss = loss * scale
            loss.backward()
            return loss.detach()
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accumulate_steps {M}")
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for m in range(M):
            lm = self._loss(x[m::M], y[m::M])
            if scale is not None:
                lm = lm * scale
            lm.backward()  # .grad sums the microbatches in its dtype
            loss += lm.detach()
        inv = 1.0 / M
        with torch.no_grad():
            for p in self.params.values():
                if p.grad is not None:
                    p.grad.mul_(inv)
            for mod in self._local_mods():
                for g in mod.whole_grads.values():
                    g.mul_(inv)
        return loss * inv

    def _whole_grads(self, scale=None):
        """``{name: this rank's gradient}``, whole over the ZeRO axis (a
        stage-3 parameter's from the wrapper's deferred sums, times
        ``scale``); a parameter without one gets zeros."""
        z3 = self._stage3.whole_grads(scale) if self._stage3 is not None \
            else {}
        out = {}
        for n, p in self.params.items():
            if not p.requires_grad:
                continue
            for r in self._reduced_names(n):
                if r in self._whole_experts:
                    mod, key, j = self._whole_experts[r]
                    g = mod.whole_grads.get(key)
                    g = None if g is None else g[j]
                elif n in self._whole:
                    mod, key = self._whole[n]
                    g = mod.whole_grads.get(key)
                else:
                    g = z3.get(n) if n in self._z3 else p.grad
                if g is None:
                    g = torch.zeros(self._reduced_shape(n, p), dtype=p.dtype,
                                    device=p.device)
                out[r] = g
        return out

    def _clear_whole(self):
        for mod in self._local_mods():
            mod.whole_grads.clear()

    def _inv_scale(self, scale):
        return None if scale is None else torch.tensor(
            inverse(scale), dtype=torch.float32, device=self.device)

    def _reduce_explicitly(self, x, y, scale):
        """The gradient reducer's path: the loss, with every parameter's
        reduced gradient adopted (this rank's slice under ZeRO), and the
        new residuals (committed by the caller unless the step skips)."""
        red, M = self._reducer, self._accum
        inv = self._inv_scale(scale)
        if self._reductions_per_step == 1:
            loss = self._forward_backward(x, y, scale)
            reduced, ef = red.reduce(
                self._whole_grads(1.0 / M if M > 1 else None),
                self.ef_state, inv)
        else:  # overlap: each microbatch reduced at its boundary
            if x.shape[0] % M:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"accumulate_steps {M}")
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            reduced, ef = None, self.ef_state
            for m in range(M):
                for p in self.params.values():
                    p.grad = None
                self._clear_whole()
                lm = self._loss(x[m::M], y[m::M])
                if scale is not None:
                    lm = lm * scale
                lm.backward()
                loss += lm.detach()
                g, ef = red.reduce(self._whole_grads(), ef, inv)
                reduced = g if reduced is None else {
                    k: reduced[k] + g[k] for k in g}
            loss = loss * (1.0 / M)
            reduced = {k: g * (1.0 / M) for k, g in reduced.items()}
        for n in self._whole:  # this ep rank's experts of the whole stack
            reduced[n] = local_block(reduced[n], 0, self._ep.rank,
                                     self._ep.nranks).contiguous()
        if self._whole_experts:  # this ep rank's MoELayer experts
            mine = {n: reduced[self._global_names(n)[self._ep.rank]]
                    for n in self._ep_local}
            for g in self._whole_experts:
                reduced.pop(g, None)
            reduced.update(mine)
        zero = self._zero
        if zero is not None and zero.stage >= 2:
            zero.take_slices(reduced)
        for n, p in self.params.items():
            if n in reduced and (zero is None or zero.stage < 2
                                 or n not in zero.dims):
                p.grad = reduced[n]
        return loss, ef

    def _check_rows(self, x):
        """Every rank of the data group passes as many rows (the mean of
        the local means is then the global mean): one small all-reduce on
        the host's gloo group."""
        if self._host is None:
            return
        rows = torch.tensor([x.shape[0], -x.shape[0]], dtype=torch.int64)
        all_reduce(rows, ReduceOp.MAX, group=self._host)
        if int(rows[0]) != -int(rows[1]):
            raise ValueError(f"local batches of {-int(rows[1])} to "
                             f"{int(rows[0])} rows across the dp group: every "
                             "rank must pass as many rows")

    def _step(self, x, y, lr):
        self._check_rows(x)
        self._step_i += 1
        key = mix_seed(self._seed, self._step_i)
        if self._dp_world > 1:  # ranks draw apart for their own rows
            key = mix_seed(key, self._dp_rank)
        self._key = key
        dev = self._cuda_index()
        with torch.random.fork_rng(devices=[] if dev is None else [dev]):
            self._reseed(key)
            return self._keyed_step(x, y, lr)

    def _global_mean(self, loss):
        """The data group's mean of the local mean losses, on the
        device."""
        all_reduce(loss, ReduceOp.AVG, group=self._dp)
        return loss

    def _clip_(self, grads):
        """The global-norm clip over the step's gradients: plain on one
        rank's whole gradients; over the groups when some are mp blocks
        or ZeRO-2 slices."""
        zero = self._zero
        sliced = zero is not None and zero.stage >= 2 and zero.n > 1
        pp = self._pp.nranks > 1
        if self._mp.nranks == 1 and not sliced and not self._experts \
                and not pp:
            self._clip.clip_(list(grads.values()))
            return
        names = [k for k, g in grads.items() if g is not None]
        # over pp each block counts on its stage, the rest on stage 0
        first = self._pp.rank == 0
        hybrid_clip_(
            self._clip, [grads[k] for k in names],
            mp_split=[_mp_split(self.params[k]) for k in names],
            sliced=[sliced and k in zero.dims for k in names],
            mp_group=self._mp, sharding_group=self._sh,
            ep_split=[k in self._experts for k in names], ep_group=self._ep,
            pp_counted=[first or self._is_block(k) for k in names],
            pp_group=self._pp if pp else None)

    def _buffers(self):
        return [b for b in (self._grads, self._expert_grads) if b is not None]

    def _keyed_step(self, x, y, lr):
        for n, p in self.params.items():
            if self._grads is None or n in self._z3:
                p.grad = None
        self._clear_whole()
        for buffers in self._buffers():
            buffers.attach()
        sc = self._scaler
        scale = sc._scale if sc is not None else None
        zero, ef = self._zero, None
        if self._reducer is not None:
            loss, ef = self._reduce_explicitly(x, y, scale)
        else:
            loss = self._forward_backward(x, y, scale) \
                if self._pspec is None \
                else self._pipeline_forward_backward(x, y, scale)
            for buffers in self._buffers():
                buffers.reduce()
            if zero is not None and zero.stage >= 2:
                zero.reduce_scatter_grads()
        if zero is not None and zero.stage >= 2:
            grads = zero.grads()  # slices, and the unsliced whole
        else:
            grads = {k: p.grad for k, p in self.params.items()}
        if sc is not None:
            flag = nonfinite_flag(list(grads.values()), scale)
            if flag is not None:  # every rank skips alike
                all_reduce(flag, ReduceOp.MAX, group=self._dp)
                all_reduce(flag, ReduceOp.MAX, group=self._mp)
                all_reduce(flag, ReduceOp.MAX, group=self._sh)
                all_reduce(flag, ReduceOp.MAX, group=self._pp)
            skip = flag is not None and bool(flag)
            sc._found_inf = skip
            sc.update()
            loss = loss * inverse(scale)
            if skip:  # the residuals stay the pre-step ones too
                return self._global_mean(loss)
        if ef is not None:
            self.ef_state = ef
        if self._clip is not None:
            self._clip_(grads)
        if zero is not None:
            zero.update(self.optimizer, zero.grads(), lr)
        else:
            self.optimizer.apply_gradients(self.params, lr=lr)
        return self._global_mean(loss)

    def __call__(self, x, y, lr=None):
        """One step on the batch ``(x, y)`` (this rank's rows); returns the
        (global mean, unscaled) loss as a 0-dim fp32 tensor on the
        device."""
        lr = self.optimizer.get_lr() if lr is None else float(lr)
        return self._step(self._batch(x), self._batch(y), lr)

    def run_steps(self, xs, ys, lr=None):
        """K steps over stacked ``[K, B, ...]`` batches, all at one learning
        rate (the optimizer's unless ``lr`` is given); returns the ``[K]``
        losses as one device tensor. Parameters, optimizer state and losses
        are those of K calls."""
        lr = self.optimizer.get_lr() if lr is None else float(lr)
        xs, ys = self._batch(xs), self._batch(ys)
        if xs.shape[0] != ys.shape[0]:
            raise ValueError(f"run_steps: {xs.shape[0]} inputs but "
                             f"{ys.shape[0]} labels")
        return torch.stack([self._step(xs[k], ys[k], lr)
                            for k in range(xs.shape[0])])

    def loss_scaling(self) -> float:
        """Current dynamic loss scale (1.0 when no scaler is attached)."""
        return 1.0 if self._scaler is None else self._scaler._scale

    @property
    def step_index(self) -> int:
        """Optimizer steps completed so far (a restore rewinds it)."""
        return self._step_i

    # ---------- checkpointing (paddle_tpu_torch.checkpoint) ----------
    def _leaves(self, name, t, sliced=False):
        """``{checkpoint name: leaf}`` of parameter ``name``'s tensor ``t``
        (the parameter, or a state leaf shaped like it, ``sliced`` under
        ZeRO), with no copy and no collective: ``t`` itself where this
        step places the array whole on every rank, else a
        ``ShardedTensor`` of ``t`` and its placement; a MoELayer expert at
        ep, which one ep rank holds whole, under every ep rank's global
        name, each placed whole on the ranks of that ep rank (the block
        None on the others)."""
        from ..resharding import ShardedTensor

        if name in self._ep_local:
            devs = self.mesh.devices
            ax = self.mesh.axis_names.index(EP_AXIS)
            names = [a for a in self.mesh.axis_names if a != EP_AXIS]
            me = self._ep.rank
            return {g: ShardedTensor(
                t if r == me else None,
                NamedSharding(DeviceMesh(np.take(devs, r, axis=ax), names),
                              PartitionSpec()), t.shape, t.dtype)
                for r, g in enumerate(self._global_names(name))}
        where = self._placement(name, sliced)
        return {name: t if where.is_replicated else ShardedTensor(t, where)}

    def _local(self, name, t, sliced=False):
        """This rank's block of the global array ``t``."""
        p = self.params[name]
        if self._mp.nranks > 1 and _mp_split(p):
            t = local_block(t, p.mp_dim, self._mp.rank, self._mp.nranks,
                            p.mp_segments)
        if name in self._experts and name not in self._ep_local:
            t = local_block(t, 0, self._ep.rank, self._ep.nranks)
        if sliced:
            t = self._zero.slice(name, t)
        return t

    def _sliced(self, name) -> bool:
        return self._zero is not None and name in self._zero.dims

    def state_for_checkpoint(self):
        """The step's resume state as the JAX step's ``TrainState``: the
        parameters and optimizer state by name, buffers, ``rng={"seed"}``,
        the step count and, with a scaler, ``extra.scaler_state`` ``[scale
        (fp32), good, bad (int32)]``; with error feedback,
        ``extra.grad_reduce_ef`` (``{"bucket000": [world * groups,
        padded] fp32, ...}``). Over mp or ZeRO the arrays are the global
        ones, gathered, as are the residuals (every rank must call this,
        in one order); otherwise the live tensors: save (the snapshot)
        before the next step. The step powers are fp32 host scalars."""
        from ...checkpoint import TrainState

        sc = self._scaler
        extra = {}
        if sc is not None:
            extra["scaler_state"] = [
                np.float32(sc._scale), np.int32(sc._good_steps),
                np.int32(sc._bad_steps)]
        if self.ef_state:
            extra["grad_reduce_ef"] = self._reducer.global_ef(self.ef_state)
        extra = extra or None
        with torch.no_grad():
            params = {}
            for n, p in self.params.items():
                if not self._is_block(n):
                    params.update(self._leaves(n, p.detach(), n in self._z3))
            opt_state = {}
            for n, s in self.optimizer.state.items():
                if self._is_block(n):
                    continue
                slots = {k: self._leaves(n, v, self._sliced(n))
                         if isinstance(v, torch.Tensor) else None
                         for k, v in s.items()}
                for g in self._global_names(n):
                    opt_state[g] = {k: s[k] if v is None else v[g]
                                    for k, v in slots.items()}
            if self._pspec is not None:
                params.update(self._stacked_params())
                opt_state.update(self._stacked_state())
        return TrainState(
            params=params,
            opt_state=opt_state,
            buffers=dict(self.model.named_buffers()) or None,
            rng={"seed": int(self._seed)},
            step=self._step_i,
            extra=extra,
        )

    def axis_sizes(self):
        """{axis: size} of this step's mesh."""
        return dict(self.mesh.shape)

    # ---------- the JAX package's stacked layout at pp ----------
    def _stacked_placement(self, sfx, sliced):
        """Where the stacked leaf of block suffix ``sfx`` lies: over ``pp``
        on dim 0 (``[pp, L/pp, ...]``, or ``[pp, v, L/(pp*v), ...]`` under
        interleaving), then each block's own placement."""
        base = self._placement(self._layer_name(self._my_layers[0], sfx),
                               sliced)
        lead = ("pp", None, None) if self._vpp > 1 else ("pp", None)
        return NamedSharding(self.mesh, PartitionSpec(*lead, *base.spec),
                             segments={d + len(lead): sz
                                       for d, sz in base.segments})

    def _stacked(self, sfx, get, sliced):
        """A ``ShardedTensor`` of this stage's blocks of suffix ``sfx``
        stacked (``get(name)`` gives each block's tensor), placed over
        pp."""
        from ..resharding import ShardedTensor
        from .meta_parallel.pipeline_parallel import stack_stage

        block = stack_stage([get(self._layer_name(i, sfx))
                             for i in self._my_layers], self._vpp)
        return ShardedTensor(block, self._stacked_placement(sfx, sliced))

    def _stacked_params(self):
        return {self._stack_prefix + sfx: self._stacked(
            sfx, lambda n: self.params[n].detach(), False)
            for sfx in self._suffixes}

    def _stacked_state(self):
        out = {}
        for sfx in self._suffixes:
            ref = self._layer_name(self._my_layers[0], sfx)
            first = self.optimizer.state[ref]
            out[self._stack_prefix + sfx] = {
                k: self._stacked(sfx, lambda n, k=k: self.optimizer.state[n][k],
                                 self._sliced(ref))
                if isinstance(v, torch.Tensor) else v
                for k, v in first.items()}
        return out

    def _unstack(self, saved, sliced_of, slots=False):
        """``saved`` (by checkpoint name) with each stacked leaf turned
        into this rank's blocks by layer name (``_Mine``, each already the
        block this rank holds; with ``slots``, dicts of them)."""
        from ..resharding import ShardedTensor, reshard
        from .meta_parallel.pipeline_parallel import stage_rows

        out = {}
        stage = self._pp.rank
        for name, v in saved.items():
            if not name.startswith(self._stack_prefix):
                out[name] = v
                continue
            sfx = name[len(self._stack_prefix):]
            ref = self._layer_name(self._my_layers[0], sfx)
            sliced = sliced_of(ref)

            def mine(leaf):
                if isinstance(leaf, ShardedTensor):
                    want = self._stacked_placement(sfx, sliced)
                    block = leaf.block if leaf.sharding == want \
                        else reshard(leaf, want).block
                    return [_Mine(b) for b in stage_rows(block, self._vpp)]
                if np.ndim(leaf) == 0:  # a step power: every block's
                    return [leaf] * len(self._my_layers)
                flat = stage_rows(_as_tensor(leaf)[stage:stage + 1],
                                  self._vpp)
                return [_Mine(self._local(self._layer_name(i, sfx), flat[j],
                                          sliced))
                        for j, i in enumerate(self._my_layers)]

            if slots:
                per = {k: mine(x) for k, x in v.items()}
                for j, i in enumerate(self._my_layers):
                    out[self._layer_name(i, sfx)] = {
                        k: x[j] for k, x in per.items()}
            else:
                for i, x in zip(self._my_layers, mine(v)):
                    out[self._layer_name(i, sfx)] = x
        return out

    def _placement(self, name, sliced):
        if name in self._ep_local:  # a whole expert on one ep rank
            return NamedSharding(self.mesh, PartitionSpec())
        extra = None
        if sliced:
            d = self._zero.dims[name]
            extra = [None] * d + [SHARDING_AXIS]
        return placement(self.params[name], self.mesh, extra)

    def checkpoint_shardings(self):
        """Placements aligned with ``state_for_checkpoint().to_tree()``'s
        params and optimizer state, each the layout this step holds: each
        parameter's spec (mp blocks over ``mp``, the qkv projection's as
        segments, expert stacks over ``ep``), each state leaf's with its
        ZeRO slice over ``sharding``; a MoELayer expert at ep, which one
        ep rank holds whole, replicated. ``CheckpointManager.restore``
        honours them: each rank reads its blocks, as ``ShardedTensor``
        leaves that ``restore_from_checkpoint`` adopts as they are."""
        params, opt = {}, {}
        for n in self.params:
            if self._is_block(n):
                continue
            for g in self._global_names(n):
                params[g] = self._placement(n, n in self._z3)
        whole = NamedSharding(self.mesh, PartitionSpec())
        for n, slots in self.optimizer.state.items():
            if self._is_block(n):
                continue
            for g in self._global_names(n):
                opt[g] = {k: self._placement(n, self._sliced(n))
                          if isinstance(v, torch.Tensor) else whole
                          for k, v in slots.items()}
        for sfx in (self._suffixes if self._pspec is not None else ()):
            ref = self._layer_name(self._my_layers[0], sfx)
            params[self._stack_prefix + sfx] = self._stacked_placement(
                sfx, False)
            opt[self._stack_prefix + sfx] = {
                k: self._stacked_placement(sfx, self._sliced(ref))
                if isinstance(v, torch.Tensor) else whole
                for k, v in self.optimizer.state[ref].items()}
        return {"params": params, "opt_state": opt}

    def live_state(self):
        """``state_for_checkpoint().to_tree()``'s structure with the live
        blocks this rank holds as ``resharding.ShardedTensor`` leaves (no
        copy, no collective): ``restore(live_state=)`` and
        ``restore_from_checkpoint`` move them device to device onto
        another step's layout. A state leaf that is not a tensor stays as
        it is; a MoELayer expert at ep is None (read from the files)."""
        from ..resharding import ShardedTensor

        def placed(n, t, sliced):
            if n in self._ep_local:
                return None
            return ShardedTensor(t.detach(), self._placement(n, sliced))

        out = {
            "params": {g: placed(n, p, n in self._z3)
                       for n, p in self.params.items()
                       if not self._is_block(n)
                       for g in self._global_names(n)},
            "opt_state": {
                g: {k: placed(n, v, self._sliced(n))
                    if isinstance(v, torch.Tensor) else v
                    for k, v in slots.items()}
                for n, slots in self.optimizer.state.items()
                if not self._is_block(n)
                for g in self._global_names(n)}}
        if self._pspec is not None:  # stacked copies of the stage's blocks
            with torch.no_grad():
                out["params"].update(self._stacked_params())
                out["opt_state"].update(self._stacked_state())
        return out

    def _adopt(self, name, v, live, sliced):
        """This rank's block for the live tensor ``live`` of parameter
        ``name``: a ``ShardedTensor``'s block as it is when its placement is
        this step's, else moved onto this step's layout; a global array
        sliced. A plain tensor of another shape is refused: which elements
        a block holds depends on its placement, and only a
        ``ShardedTensor`` carries one."""
        from ..resharding import ShardedTensor, reshard

        if isinstance(v, _Mine):
            return v.block
        want = self._placement(name, sliced)
        if isinstance(v, ShardedTensor):
            if v.sharding == want:
                return v.block
            if v.sharding.is_replicated and v.block is not None:
                # whole on its ranks (a MoELayer expert's ep rank)
                return self._local(name, v.block, sliced)
            return reshard(v, want).block
        t = _as_tensor(v)
        whole = ShardedTensor(live, want).shape
        if tuple(t.shape) != whole:
            raise ValueError(
                f"restore_from_checkpoint: {name!r} is a plain tensor of "
                f"shape {tuple(t.shape)}, not the global {whole}: a block "
                "comes as a ShardedTensor, which carries its placement "
                "(restore(shardings=) and live_state() give them)")
        return self._local(name, t, sliced)

    def _mine(self, saved, names, what):
        """``saved`` (by checkpoint name) by this step's ``names``: a
        MoELayer expert's entry of this ep rank."""
        want = {g for n in names for g in self._global_names(n)}
        if set(saved) != want:
            raise KeyError(f"restore_from_checkpoint: {what} names differ "
                           f"from the step's: "
                           f"{sorted(set(saved) ^ want)[:4]}")
        r = self._ep.rank
        return {n: saved[self._global_names(n)[r] if n in self._ep_local
                         else n] for n in names}

    @torch.no_grad()
    def restore_from_checkpoint(self, tree):
        """Adopt a restored ``TrainState`` (or its tree, as
        ``CheckpointManager.restore`` or the JAX package's ``load_tree``
        returns it). Each parameter and optimizer slot is this rank's
        block, copied into the live tensor in place: a global array
        (tensor or numpy) is sliced, a ``ShardedTensor`` placed as this
        step places it (``restore(shardings=step.checkpoint_shardings())``)
        is adopted as it is, and one of another layout (another step's
        ``live_state()``, a restore onto other placements) is resharded
        onto this one device to device (collective: every rank restores the
        same tree); a plain tensor that is not the global array raises.
        Names, slots and shapes must match; the step powers are restored
        to the same fp32 bits; the step count, the seed, the scaler's
        automaton and this rank's error-feedback residuals follow
        (residuals that do not fit the step's plan, or a step without one,
        start from zeros, as in the JAX package)."""
        from ...checkpoint import TrainState

        ts = tree if isinstance(tree, TrainState) \
            else TrainState.from_tree(tree)
        params_in, opt_in = ts.params, ts.opt_state
        if self._pspec is not None:
            params_in = self._unstack(params_in, lambda n: False)
            opt_in = self._unstack(opt_in, self._sliced, slots=True)
        saved = self._mine(params_in, self.params, "params")
        _copy_named(self.params, {
            n: self._adopt(n, v, self.params[n], n in self._z3)
            for n, v in saved.items()}, "params")
        if ts.buffers:
            _copy_named(dict(self.model.named_buffers()), ts.buffers,
                        "buffers")
        state = self.optimizer.init_state(self._state_targets())
        opt = self._mine(opt_in, state, "opt_state")
        for name, slots in state.items():
            if set(opt[name]) != set(slots):
                raise KeyError(f"restore_from_checkpoint: {name}'s slots "
                               f"{sorted(opt[name])} are not the "
                               f"optimizer's {sorted(slots)}")
            for k in list(slots):
                v = opt[name][k]
                if isinstance(slots[k], torch.Tensor):
                    v = self._adopt(name, v, slots[k], self._sliced(name))
                slots[k] = _load_slot(slots[k], v, f"{name}_{k}")
        sc_state = (ts.extra or {}).get("scaler_state")
        if sc_state is not None and self._scaler is not None:
            self._scaler._scale = float(np.float32(float(sc_state[0])))
            self._scaler._good_steps = int(sc_state[1])
            self._scaler._bad_steps = int(sc_state[2])
        red = self._reducer
        if red is not None and red.has_ef:
            ef_in = (ts.extra or {}).get("grad_reduce_ef")
            self.ef_state = red.local_ef(
                ef_in if ef_in is not None and red.ef_matches(ef_in)
                else red.init_ef(), self.device)
        self._step_i = int(ts.step)
        if ts.rng and "seed" in ts.rng:
            self._seed = int(ts.rng["seed"])
        return self


class _Mine:
    """A block this rank holds already (a stacked leaf's row of this
    stage), adopted as it is."""

    def __init__(self, block):
        self.block = block


def _prune_optimizer(optimizer, live):
    """Drop from the optimizer (and the wrappers around it) the parameters
    the model no longer holds (``live``: the ``id``s it does)."""
    seen = set()
    while optimizer is not None and id(optimizer) not in seen:
        seen.add(id(optimizer))
        params = getattr(optimizer, "_params", None)
        if isinstance(params, dict):
            optimizer._params = {k: p for k, p in params.items()
                                 if id(p) in live}
        optimizer = getattr(optimizer, "_inner_opt",
                            getattr(optimizer, "_inner", None))


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else to_torch(np.asarray(v))


def _copy_named(live, saved, what):
    """Copy ``saved[name]`` into each live tensor in place."""
    if set(saved) != set(live):
        raise KeyError(f"restore_from_checkpoint: {what} names differ from "
                       f"the step's: {sorted(set(saved) ^ set(live))[:4]}")
    for name, t in live.items():
        v = saved[name]
        src = v if isinstance(v, torch.Tensor) else to_torch(np.asarray(v))
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(f"restore_from_checkpoint: {what} {name!r} is "
                             f"{tuple(src.shape)}/{src.dtype}, the step "
                             f"holds {tuple(t.shape)}/{t.dtype}")
        t.copy_(src)


def make_sharded_train_step(model, optimizer, loss_fn=None, mesh=None,
                            autoshard: bool = False,
                            autoshard_fixed_mesh: bool = False, **kwargs):
    """Build a ``ShardedTrainStep``; ``autoshard`` and
    ``autoshard_fixed_mesh`` (the layout search) are not ported yet."""
    if autoshard or autoshard_fixed_mesh:
        raise NotImplementedError("autoshard is not ported yet (ROADMAP "
                                  "queue A item A7)")
    return ShardedTrainStep(model, optimizer, loss_fn=loss_fn, mesh=mesh,
                            **kwargs)
