"""Optimizer base and Adam/AdamW (``paddle_tpu/optimizer/optimizer.py``
analog).

The JAX package keeps each optimizer's arithmetic in a pure per-tensor
``_update`` and returns new arrays. Here updates happen **in place**: the
parameter (or its fp32 master weight), the moments and the step powers are
written where they lie, which is the port's counterpart of the JAX train
step's donated buffers. With ``multi_precision=True`` a bf16 parameter
keeps an fp32 master copy in its state; the update runs on the master and
the parameter is then copied from it in one ``copy_``.

``Adam`` and ``AdamW`` send every float32/bfloat16 tensor with
float32/bfloat16 moments through the fused AdamW kernel
(``kernels/fused_optim.py``, which says why there is no size gate); Adam's
L2 term is folded into the gradient first and it runs with no decoupled
decay. The JAX package's plain Adam arithmetic stays only for ``amsgrad``
(the kernel keeps no running maximum) and for other dtypes.
``beta1_pow``/``beta2_pow`` are fp32 scalars multiplied in fp32 on the
host, as the JAX state multiplies them, so trajectories match.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_dtype
from ..kernels.fused_optim import fused_adamw_update

_F32 = np.float32
_LOW = (torch.bfloat16, torch.float16)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class Optimizer:
    """Holds per-parameter state by name; the train step calls
    ``apply_gradients`` with the model's named parameters (clipping is the
    train step's). ``parameters`` is taken for paddle's signature: the state
    is built for whatever ``apply_gradients`` is given."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if isinstance(learning_rate, bool) \
                or not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP queue "
                "A item 3a); pass a float learning_rate")
        self._lr = float(learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        #: per-parameter state by name: moments, step powers, master weight
        self.state = {}

    def get_lr(self) -> float:
        return self._lr

    # ---- state ----
    def _init_state(self, value) -> dict:
        return {}

    def _use_master(self, p) -> bool:
        return self._multi_precision and p.dtype in _LOW

    @torch.no_grad()
    def init_state(self, named_params):
        """Create the state of every parameter that has none yet
        (``init_state_pytree`` analog); returns ``self.state``."""
        for name, p in named_params.items():
            if name in self.state:
                continue
            master = self._use_master(p)
            base = p.detach().float() if master else p
            s = self._init_state(base)
            if master:
                s["master_weight"] = base
            self.state[name] = s
        return self.state

    # ---- the per-tensor update (override) ----
    def _update(self, value, grad, state, lr, name):
        """Update ``value`` and ``state`` in place."""
        raise NotImplementedError

    def _coupled_wd(self) -> float:
        """L2 regularisation folded into the gradient (Adam style)."""
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "coeff", wd))

    def _takes_native_grad(self, value, state) -> bool:
        """True when ``_update`` takes the grad at its own dtype (the fused
        kernel casts in registers), so no fp32 copy of it is made."""
        return False

    @torch.no_grad()
    def apply_gradients(self, named_params, lr=None):
        """Update every parameter of ``{name: param}`` that has a ``.grad``,
        in place (``apply_gradients`` analog; no clipping here)."""
        lr = self.get_lr() if lr is None else float(lr)
        self.init_state(named_params)
        for name, p in named_params.items():
            g = p.grad
            if g is None:
                continue
            s = self.state[name]
            value = s.get("master_weight", p)
            gv = g if self._takes_native_grad(value, s) else g.to(value.dtype)
            cwd = self._coupled_wd()
            if cwd:
                gv = gv.to(value.dtype) + cwd * value
            self._update(value, gv, s, lr, name)
            if value is not p:
                p.copy_(value)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, amsgrad=False,
                 moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        # moment_dtype='bfloat16' halves the moments' memory; the update
        # still runs in fp32
        self._moment_dtype = (None if moment_dtype is None
                              else resolve_dtype(moment_dtype))

    def _init_state(self, value):
        mdt = self._moment_dtype or value.dtype
        s = {"moment1": torch.zeros(value.shape, dtype=mdt,
                                    device=value.device),
             "moment2": torch.zeros(value.shape, dtype=mdt,
                                    device=value.device),
             "beta1_pow": _F32(1.0), "beta2_pow": _F32(1.0)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros(value.shape, dtype=mdt,
                                           device=value.device)
        return s

    def _next_pows(self, state):
        b1p = _F32(state["beta1_pow"] * _F32(self._beta1))
        b2p = _F32(state["beta2_pow"] * _F32(self._beta2))
        state["beta1_pow"], state["beta2_pow"] = b1p, b2p
        return b1p, b2p

    def _use_fused_kernel(self, value, state) -> bool:
        return (not self._amsgrad and value.dtype in _KERNEL_DTYPES
                and state["moment1"].dtype in _KERNEL_DTYPES)

    _takes_native_grad = _use_fused_kernel

    def _decay(self, name) -> float:
        """The decoupled weight decay of parameter ``name``."""
        return 0.0

    def _update(self, value, grad, state, lr, name):
        decay = self._decay(name)
        if self._use_fused_kernel(value, state):
            b1p, b2p = self._next_pows(state)
            fused_adamw_update(
                value, grad, state["moment1"], state["moment2"], lr=lr,
                beta1=self._beta1, beta2=self._beta2, eps=self._epsilon,
                weight_decay=decay, beta1_pow=b1p, beta2_pow=b2p)
            return
        self._adam(value, grad, state, lr,
                   decay=float(_F32(1) - _F32(lr) * _F32(decay)))

    def _adam(self, value, grad, state, lr, decay):
        """``Adam._update`` of the JAX package, written back in place, for
        what the kernel does not take (``amsgrad``, other dtypes);
        ``decay`` (AdamW's ``1 - lr*wd``) scales the fp32 value first."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g32 = grad.float()
        m = b1 * state["moment1"].float() + (1 - b1) * g32
        v = b2 * state["moment2"].float() + (1 - b2) * g32 * g32
        b1p, b2p = self._next_pows(state)
        m_hat = m / float(_F32(1) - b1p)
        if self._amsgrad:
            v_max = torch.maximum(state["moment2_max"].float(), v)
            state["moment2_max"].copy_(v_max)
            v_hat = v_max / float(_F32(1) - b2p)
        else:
            v_hat = v / float(_F32(1) - b2p)
        value.copy_(value.float() * decay
                    - lr * m_hat / (torch.sqrt(v_hat) + eps))
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)


class AdamW(Adam):
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` False skips
    the decay for that parameter (names come from ``named_parameters()``
    or the train step)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, amsgrad=False, moment_dtype=None):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW lr_ratio is not ported yet "
                                      "(ROADMAP queue A item 3a)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision, amsgrad=amsgrad,
                         moment_dtype=moment_dtype)
        self._wd_coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _coupled_wd(self):
        return 0.0

    def _decay(self, name):
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd_coeff
