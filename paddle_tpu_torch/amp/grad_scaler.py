"""Dynamic loss scaling (``paddle_tpu/amp/grad_scaler.py`` analog).

The eager API is the JAX package's: ``scale``, ``unscale_``, ``step``,
``minimize``, ``update``, ``state_dict``/``load_state_dict``. The scale and
its (good, bad) step counters live here on the host, and ``update``
computes them in fp32, as the JAX train step's device automaton does, so
the two agree bit for bit; a train step built with this scaler
(``make_sharded_train_step(..., scaler=)``) drives the same ``update``.

``unscale_`` multiplies every gradient by ``1/scale`` in fp32 and casts it
back to its dtype. Whether any is non-finite decides whether the update
runs, and the optimizer updates in place, so the decision is needed on the
host before the update: it is read once per step, one synchronisation for
all gradients (the JAX package's eager scaler reads one per parameter; its
compiled step selects old or new values on the device instead).
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32


def inverse(scale) -> float:
    """``1/scale`` rounded to fp32, as the JAX step computes it."""
    return float(_F32(1.0) / _F32(scale))


def nonfinite_flag(grads, scale):
    """Multiply each gradient in place by ``1/scale`` (fp32 math, cast back
    to its dtype); returns a device flag, 1.0 when any is non-finite (None
    without gradients). Nothing is read on the host."""
    inv = inverse(scale)
    flags = []
    with torch.no_grad():
        for g in grads:
            if g is None:
                continue
            g32 = g.float() * inv
            flags.append(torch.isfinite(g32).all())
            g.copy_(g32)
    return (~torch.stack(flags).all()).float() if flags else None


def unscale_grads(grads, scale) -> bool:
    """``nonfinite_flag``, read on the host: True when any gradient is
    non-finite (one synchronisation)."""
    flag = nonfinite_flag(grads, scale)
    return flag is not None and bool(flag)


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(_F32(init_loss_scaling)) if enable else 1.0
        self._incr_ratio, self._decr_ratio = incr_ratio, decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(_F32(v))

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        self._found_inf = unscale_grads(
            [p.grad for p in optimizer._params.values()], self._scale)
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not self._enable or not self._dynamic:
            self._unscaled = False
            return
        scale = _F32(self._scale)
        with np.errstate(over="ignore", invalid="ignore"):
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every:
                    scale = max(scale * _F32(self._decr_ratio), _F32(1.0))
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every:
                    scale = scale * _F32(self._incr_ratio)
                    self._good_steps = 0
        self._scale = float(scale)
        self._found_inf = False
        self._unscaled = False

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)

    set_state_dict = load_state_dict

