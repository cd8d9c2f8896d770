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

Options of the JAX step that need a mesh, a gradient reducer, in-graph
health statistics, per-parameter sharding or a pipeline raise
``NotImplementedError`` naming their ROADMAP items; none is silently
ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from ...amp.grad_scaler import inverse, unscale_grads
from ...data.protocol import mix_seed
from ...device import resolve_device
from ...nn.clip import ClipGradByGlobalNorm
from ...optimizer.optimizer import _load_slot
from ...weights import to_torch

_A5 = "ROADMAP queue A item A5 (distribution)"


class ShardedTrainStep:
    """Holds the model's named parameters and runs one optimizer step per
    call. Batches (token ids ``[B, S]`` as tensors or numpy arrays) are
    moved to ``device``, which defaults to ``cuda``; the model must already
    live there."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 batch_spec=None, donate=True, seed=0, accumulate_steps=None,
                 pp_remat=True, virtual_pp_degree=1, pp_schedule="1f1b",
                 scaler=None, grad_reduce=None, health_stats=None,
                 param_specs=None, *, device=None):
        pipe = "ROADMAP queue A item A5.6 (pipeline parallelism)"
        for what, on, item in (
                ("mesh", mesh is not None, _A5),
                ("batch_spec", batch_spec is not None, _A5),
                ("pp_remat", pp_remat is not True, pipe),
                ("virtual_pp_degree", virtual_pp_degree != 1, pipe),
                ("pp_schedule", pp_schedule != "1f1b", pipe),
                ("grad_reduce", grad_reduce is not None, _A5),
                ("health_stats", bool(health_stats),
                 "ROADMAP queue A item A6 (observability)"),
                ("param_specs", param_specs is not None, _A5)):
            if on:
                raise NotImplementedError(f"make_sharded_train_step: {what} "
                                          f"is not ported yet ({item})")
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
        optimizer.init_state(self.params)

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

    def _step(self, x, y, lr):
        self._step_i += 1
        key = mix_seed(self._seed, self._step_i)
        cuda = self.device.type == "cuda"
        dev = (self.device.index if self.device.index is not None
               else torch.cuda.current_device()) if cuda else None
        with torch.random.fork_rng(devices=[dev] if cuda else []):
            torch.random.default_generator.manual_seed(key)
            if cuda:
                torch.cuda.default_generators[dev].manual_seed(key)
            return self._keyed_step(x, y, lr)

    def _keyed_step(self, x, y, lr):
        for p in self.params.values():
            p.grad = None
        sc = self._scaler
        scale = sc._scale if sc is not None else None
        loss = self._forward_backward(x, y, scale)
        if sc is not None:
            sc._found_inf = unscale_grads(
                [p.grad for p in self.params.values()], scale)
            skip = sc._found_inf
            sc.update()
            loss = loss * inverse(scale)
            if skip:
                return loss
        if self._clip is not None:
            self._clip.clip_([p.grad for p in self.params.values()])
        self.optimizer.apply_gradients(self.params, lr=lr)
        return loss

    def __call__(self, x, y, lr=None):
        """One step on the batch ``(x, y)``; returns the (mean, unscaled)
        loss as a 0-dim fp32 tensor on the device."""
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

    def checkpoint_shardings(self):
        """The JAX step's per-array layouts for a restore onto its mesh;
        the port has no mesh yet."""
        raise NotImplementedError(f"checkpoint_shardings is not ported yet "
                                  f"({_A5})")

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
                f"of a gradient reducer) needs grad_reduce ({_A5})")
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
