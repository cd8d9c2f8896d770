"""The train step (``paddle_tpu/distributed/fleet/utils.py`` analog), one
device.

``make_sharded_train_step(model, optimizer)`` returns a callable
``step(x, y, lr=None) -> loss`` with the JAX step's semantics on one
device: the loss through the model's ``forward_with_loss`` unless a
``loss_fn`` is given, gradient accumulation over ``accumulate_steps``
microbatches (microbatch ``m`` is rows ``m::M``; losses and gradients are
averaged), global-norm clipping when the optimizer carries a
``ClipGradByGlobalNorm``, then the optimizer's update. PyTorch runs
eagerly, so there is nothing to compile; the JAX step's donated buffers
become in-place updates of the model's parameters and the optimizer state.

Options of the JAX step that need a mesh, a loss scaler, a gradient
reducer, in-graph health statistics or per-parameter sharding raise
``NotImplementedError`` naming their ROADMAP items; none is silently
ignored.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from ...nn.clip import ClipGradByGlobalNorm


class ShardedTrainStep:
    """Holds the model's named parameters and runs one optimizer step per
    call. Batches (token ids ``[B, S]`` as tensors or numpy arrays) are
    moved to ``device``, which defaults to ``cuda``; the model must already
    live there."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 accumulate_steps=None, scaler=None, grad_reduce=None,
                 health_stats=None, param_specs=None, device=None):
        for what, val, item in (
                ("mesh", mesh, "ROADMAP queue A item 5 (distribution; a pp "
                 "axis comes with it)"),
                ("scaler", scaler, "ROADMAP queue A item 3b (amp)"),
                ("grad_reduce", grad_reduce, "ROADMAP queue A item 3d"),
                ("health_stats", health_stats or None,
                 "ROADMAP queue A item 3d"),
                ("param_specs", param_specs, "ROADMAP queue A item 5")):
            if val is not None:
                raise NotImplementedError(f"make_sharded_train_step: {what} "
                                          f"is not ported yet ({item})")
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

    def __call__(self, x, y, lr=None):
        """One step on the batch ``(x, y)``; returns the (mean) loss as a
        0-dim fp32 tensor on the device."""
        lr = self.optimizer.get_lr() if lr is None else float(lr)
        self._step_i += 1
        x, y = self._batch(x), self._batch(y)
        for p in self.params.values():
            p.grad = None
        M = self._accum
        if M <= 1:
            loss = self._loss(x, y)
            loss.backward()
            loss = loss.detach()
        else:
            if x.shape[0] % M:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"accumulate_steps {M}")
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for m in range(M):
                lm = self._loss(x[m::M], y[m::M])
                lm.backward()  # .grad sums the microbatches in its dtype
                loss += lm.detach()
            inv = 1.0 / M
            with torch.no_grad():
                for p in self.params.values():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            loss = loss * inv
        if self._clip is not None:
            self._clip.clip_([p.grad for p in self.params.values()])
        self.optimizer.apply_gradients(self.params, lr=lr)
        return loss


def make_sharded_train_step(model, optimizer, loss_fn=None, mesh=None,
                            autoshard: bool = False, **kwargs):
    """Build a ``ShardedTrainStep``; ``autoshard`` (the layout search) is
    not ported yet."""
    if autoshard:
        raise NotImplementedError("autoshard is not ported yet (ROADMAP "
                                  "queue A item 7)")
    return ShardedTrainStep(model, optimizer, loss_fn=loss_fn, mesh=mesh,
                            **kwargs)
