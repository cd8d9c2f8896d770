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
the whole world as one ``dp`` axis) the step is data parallel: a model
wrapped in ``DataParallel`` must average over the same ranks as the
step's dp group. ``batch_spec`` names the
mesh axes dim 0 of a batch is split over (the JAX step's default
``PartitionSpec(("dp", "sharding", "ep"))``), and each rank passes its
*local* rows, the JAX package's multi-process contract; a batch whose rows
differ across the dp group in count raises (checked each step over a gloo
group on the host). The gradients are views into persistent flat buffers
(``parallel.GradBuffers``), which the backward accumulates into; after it
(after all ``accumulate_steps`` microbatches) each bucket is all-reduced
by SUM over the dp group in place and each buffer scaled by ``1/world`` in
its dtype, so the
clip's norm and the update are the global batch's; the returned loss is
the global mean (an AVG all-reduce of the local mean, nothing read on the
host). With a scaler, the found-inf flag is all-reduced with MAX before
its host read, so every rank skips the same steps. Dropout's key folds in
the rank's dp index at dp above 1, so ranks draw different masks for
different rows. At a dp world of one with a process group (NCCL at world
size 1) the reductions run and change no bit. The replicas stay bitwise
equal: every rank applies the same reduced gradients.

Options of the JAX step that the port has not reached raise
``NotImplementedError`` naming their ROADMAP items: a mesh axis of size
above 1 other than data's (tensor and ZeRO parallelism A5.3, expert A5.4,
pipeline A5.6, context A5.7), a batch split along another dimension than
dim 0 (A5.7), ``param_specs`` (A5.3), ``grad_reduce`` (A5.4), a GPT-MoE
model at dp above 1 (A5.4: the JAX package routes over the global token
count), the pipeline options (A5.6) and ``health_stats`` (A6). None is
silently ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from ...amp.grad_scaler import inverse, nonfinite_flag
from ...data.protocol import mix_seed
from ...device import resolve_device
from ...nn.clip import ClipGradByGlobalNorm
from ...optimizer.optimizer import _load_slot
from ...weights import to_torch
from ..collective import group_of
from ..communication import ReduceOp, all_reduce
from ..mesh import (DeviceMesh, NamedSharding, PartitionSpec, device_count,
                    spec_axes)
from ..parallel import DataParallel, get_rank, grad_buffers
from ..topology import LATER_AXES, get_hybrid_communicate_group

_ITEM = "ROADMAP queue A item"


def resolve_spec(spec, mesh: DeviceMesh) -> PartitionSpec:
    """Drop spec axes the mesh does not have (an mp spec on a dp-only mesh
    is replicated), as the JAX step resolves its specs."""
    if spec is None:
        return PartitionSpec()
    if not isinstance(spec, tuple):
        raise TypeError(f"batch_spec must be a PartitionSpec, got "
                        f"{type(spec).__name__}")
    out = []
    for e in spec:
        kept = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a in mesh.axis_names)
        out.append(None if not kept else kept if isinstance(e, tuple)
                   else kept[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


class ShardedTrainStep:
    """Holds the model's named parameters and runs one optimizer step per
    call. Batches (token ids ``[B, S]`` as tensors or numpy arrays; at dp,
    this rank's rows) are moved to ``device``, which defaults to ``cuda``;
    the model must already live there."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 batch_spec=PartitionSpec(("dp", "sharding", "ep")),
                 donate=True, seed=0, accumulate_steps=None,
                 pp_remat=True, virtual_pp_degree=1, pp_schedule="1f1b",
                 scaler=None, grad_reduce=None, health_stats=None,
                 param_specs=None, *, device=None):
        pipe = f"{_ITEM} A5.6 (pipeline parallelism)"
        for what, on, item in (
                ("pp_remat", pp_remat is not True, pipe),
                ("virtual_pp_degree", virtual_pp_degree != 1, pipe),
                ("pp_schedule", pp_schedule != "1f1b", pipe),
                ("grad_reduce", grad_reduce is not None,
                 f"{_ITEM} A5.4 (gradient compression)"),
                ("health_stats", bool(health_stats), f"{_ITEM} A6 "
                 "(observability)"),
                ("param_specs", param_specs is not None,
                 f"{_ITEM} A5.3 (tensor and sharding parallelism)")):
            if on:
                raise NotImplementedError(f"make_sharded_train_step: {what} "
                                          f"is not ported yet ({item})")
        wrapper = model.group if isinstance(model, DataParallel) else None
        if wrapper is not None:
            model = model._layers  # the step reduces the gradients itself
        self._seed = int(seed)
        self._donate = donate
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.params = dict(model.named_parameters())
        off = sorted(n for n, p in self.params.items()
                     if p.device.type != self.device.type)
        if off:
            raise ValueError(f"model parameters {off[:3]} are not on "
                             f"{self.device}; build the model there")
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"{type(clip).__name__}: only ClipGradByGlobalNorm is ported")
        self._clip = clip
        self._scaler = scaler if scaler is not None and scaler.is_enable() \
            else None
        self._use_fwl = loss_fn is None and hasattr(model, "forward_with_loss")
        self.loss_fn = loss_fn if loss_fn is not None \
            else getattr(model, "loss", None)
        if not self._use_fwl and self.loss_fn is None:
            raise ValueError(f"{type(model).__name__} has no .loss/"
                             ".forward_with_loss; pass loss_fn= to "
                             "make_sharded_train_step")
        self._accum = accumulate_steps if accumulate_steps else 1
        self._step_i = 0  # optimizer steps taken, as the JAX step counts
        self._init_dp(mesh, batch_spec, wrapper)
        optimizer.init_state(self.params)

    def _init_dp(self, mesh, batch_spec, wrapper):
        """The mesh, the batch's data axes, the dp group this rank reduces
        over (it must be a ``DataParallel`` wrapper's group, when the model
        came wrapped) and the gradients' buffers (collective: every rank
        builds the step)."""
        if mesh is None:
            hcg = get_hybrid_communicate_group()
            mesh = hcg.get_mesh() if hcg is not None \
                else DeviceMesh(np.arange(device_count()), ("dp",))
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
                    f"data parallelism only ({_ITEM} {LATER_AXES[axis]})")
        me = get_rank()
        mesh.coords(me)  # raises unless this rank is on the mesh
        for ranks in mesh.groups_along(data_axes):
            g = group_of(ranks, mesh, ",".join(data_axes) or None,
                         name="dp_group")
            if me in ranks:
                self._dp = g
        if wrapper is not None and wrapper.ranks != self._dp.ranks:
            raise ValueError(
                f"the model's DataParallel averages over ranks "
                f"{wrapper.ranks}, the step's dp group is {self._dp.ranks}: "
                "pass the mesh whose data axes are the wrapper's ranks")
        self._dp_world, self._dp_rank = self._dp.nranks, self._dp.rank
        self._grads = grad_buffers(self.params.values(), self._dp)
        self._host = None
        if self._dp_world > 1:
            if getattr(getattr(self.model, "cfg", None), "moe_num_experts",
                       0):
                raise NotImplementedError(
                    "a GPT-MoE model at dp above 1: the JAX package routes "
                    "over the global batch's tokens (capacity cf*T/E), "
                    "which per-rank routing would change; expert "
                    f"parallelism is {_ITEM} A5.4")
            # the rows check runs on the host, on a gloo group of its own
            for ranks in mesh.groups_along(data_axes):
                g = group_of(ranks, backend="gloo")
                if me in ranks:
                    self._host = g

    def _batch(self, a):
        return torch.as_tensor(a).to(self.device)

    def _loss(self, x, y):
        if self._use_fwl:
            return self.model.forward_with_loss(x, y).float()
        return self.loss_fn(self.model(x), y).float()

    def _forward_backward(self, x, y, scale):
        """The (mean) loss, times ``scale`` when given, with the gradients
        of that value in the parameters' ``.grad``."""
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
        return loss * inv

    def _check_rows(self, x):
        """Every rank of the dp group passes as many rows (the mean of the
        local means is then the global mean): one small all-reduce on the
        host's gloo group."""
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
        cuda = self.device.type == "cuda"
        dev = (self.device.index if self.device.index is not None
               else torch.cuda.current_device()) if cuda else None
        with torch.random.fork_rng(devices=[dev] if cuda else []):
            torch.random.default_generator.manual_seed(key)
            if cuda:
                torch.cuda.default_generators[dev].manual_seed(key)
            return self._keyed_step(x, y, lr)

    def _global_mean(self, loss):
        """The dp group's mean of the local mean losses, on the device."""
        all_reduce(loss, ReduceOp.AVG, group=self._dp)
        return loss

    def _keyed_step(self, x, y, lr):
        if self._grads is None:
            for p in self.params.values():
                p.grad = None
        else:
            self._grads.attach()
        sc = self._scaler
        scale = sc._scale if sc is not None else None
        loss = self._forward_backward(x, y, scale)
        if self._grads is not None:
            self._grads.reduce()
        grads = [p.grad for p in self.params.values()]
        if sc is not None:
            flag = nonfinite_flag(grads, scale)
            if flag is not None:  # every rank skips alike
                all_reduce(flag, ReduceOp.MAX, group=self._dp)
            skip = flag is not None and bool(flag)
            sc._found_inf = skip
            sc.update()
            loss = loss * inverse(scale)
            if skip:
                return self._global_mean(loss)
        if self._clip is not None:
            self._clip.clip_(grads)
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
    def state_for_checkpoint(self):
        """The step's resume state as the JAX step's ``TrainState``: the
        live parameters and optimizer state by name (tensors; the step
        powers fp32 host scalars), buffers, ``rng={"seed"}``, the step
        count and, with a scaler, ``extra.scaler_state`` ``[scale (fp32),
        good, bad (int32)]``. The tensors are the live ones: save (the
        snapshot) before the next step."""
        from ...checkpoint import TrainState

        sc = self._scaler
        extra = None if sc is None else {"scaler_state": [
            np.float32(sc._scale), np.int32(sc._good_steps),
            np.int32(sc._bad_steps)]}
        return TrainState(
            params=dict(self.params),
            opt_state={n: dict(s) for n, s in self.optimizer.state.items()},
            buffers=dict(self.model.named_buffers()) or None,
            rng={"seed": int(self._seed)},
            step=self._step_i,
            extra=extra,
        )

    def axis_sizes(self):
        """{axis: size} of this step's mesh."""
        return dict(self.mesh.shape)

    def checkpoint_shardings(self):
        """Placements aligned with ``state_for_checkpoint().to_tree()``'s
        params and optimizer state, for ``CheckpointManager.restore``: all
        replicated over the mesh at data parallelism (every rank reads the
        whole array)."""
        rep = NamedSharding(self.mesh, PartitionSpec())
        return {"params": {n: rep for n in self.params},
                "opt_state": {n: {k: rep for k in slots} for n, slots
                              in self.optimizer.state.items()}}

    @torch.no_grad()
    def restore_from_checkpoint(self, tree):
        """Adopt a restored ``TrainState`` (or its tree, as
        ``CheckpointManager.restore`` or the JAX package's ``load_tree``
        returns it: tensor or numpy leaves). Parameters, optimizer slots
        and buffers are copied into the live tensors in place (names,
        slots and shapes must match), the step powers restored to the same
        fp32 bits; the step count, the seed and the scaler's automaton
        follow."""
        from ...checkpoint import TrainState

        ts = tree if isinstance(tree, TrainState) \
            else TrainState.from_tree(tree)
        if ts.extra and ts.extra.get("grad_reduce_ef") is not None:
            raise NotImplementedError(
                "a checkpoint with grad_reduce_ef (error-feedback residuals "
                f"of a gradient reducer) needs grad_reduce ({_ITEM} A5.4)")
        _copy_named(self.params, ts.params, "params")
        if ts.buffers:
            _copy_named(dict(self.model.named_buffers()), ts.buffers,
                        "buffers")
        state = self.optimizer.init_state(self.params)
        if set(ts.opt_state) != set(state):
            raise KeyError(f"restore_from_checkpoint: opt_state names differ "
                           f"from the step's: {sorted(set(ts.opt_state) ^ set(state))[:4]}")
        for name, slots in state.items():
            if set(ts.opt_state[name]) != set(slots):
                raise KeyError(f"restore_from_checkpoint: {name}'s slots "
                               f"{sorted(ts.opt_state[name])} are not the "
                               f"optimizer's {sorted(slots)}")
            for k in list(slots):
                slots[k] = _load_slot(slots[k], ts.opt_state[name][k],
                                      f"{name}_{k}")
        sc_state = (ts.extra or {}).get("scaler_state")
        if sc_state is not None and self._scaler is not None:
            self._scaler._scale = float(np.float32(float(sc_state[0])))
            self._scaler._good_steps = int(sc_state[1])
            self._scaler._bad_steps = int(sc_state[2])
        self._step_i = int(ts.step)
        if ts.rng and "seed" in ts.rng:
            self._seed = int(ts.rng["seed"])
        return self


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
