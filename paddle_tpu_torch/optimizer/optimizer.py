"""Optimizer base and Adam/AdamW (``paddle_tpu/optimizer/optimizer.py``
analog), with a float learning rate or an ``LRScheduler`` (``lr.py``).

The JAX package keeps each optimizer's arithmetic in a pure per-tensor
``_update`` and returns new arrays. Here updates happen **in place**: the
parameter (or its fp32 master weight), the moments and the step powers are
written where they lie, which is the port's counterpart of the JAX train
step's donated buffers. With ``multi_precision=True`` a bf16 parameter
keeps an fp32 master copy in its state; the update runs on the master and
the parameter is then written from it (by the fused kernel in the same
pass, or by one ``copy_``, counted in ``master_copies``).

``Adam`` and ``AdamW`` send every tensor whose (value, grad, moments)
dtypes the fused AdamW kernel takes (float32/bfloat16,
``kernels/fused_optim.py``, which says why there is no size gate) through
it together: ``apply_gradients`` collects them and makes one launch per
dtype combination (``fused_adamw_multi``), each tensor with its own
learning rate, decay and step powers. Adam's L2 term is folded into the
gradient first and it runs with no decoupled decay. The JAX package's
plain Adam arithmetic stays only for ``amsgrad`` (the kernel keeps no
running maximum) and for other dtypes (an fp16 gradient, say).
``beta1_pow``/``beta2_pow`` are fp32 scalars multiplied in fp32 on the
host, as the JAX state multiplies them, so trajectories match.

``state_dict()`` / ``set_state_dict()`` (``set_dict``) use the JAX
package's keys: ``f"{name}_{slot}"`` for every parameter's state,
``global_step`` (the eager ``step()`` calls) and ``LR_Scheduler``. The
state's tensors are returned as they live (no copy); ``set_state_dict``
copies into them in place and restores the step powers to the same fp32
bits.

``lazy_mode`` (paddle: update only the rows a sparse gradient touches)
changes no value with the dense gradients the port makes, in paddle as
here, and ``use_multi_tensor`` (paddle: one fused launch over many
tensors) changes none either: the port always groups. Both are kept on the
optimizer. ``name`` is accepted and unused, as in paddle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_dtype
from ..kernels.fused_optim import COMBOS, fused_adamw_multi
from ..weights import to_torch
from .lr import LRScheduler

_F32 = np.float32
_LOW = (torch.bfloat16, torch.float16)


def _load_slot(cur, v, key):
    """``v`` into the slot ``cur``: a tensor slot is copied into in place
    (shape must match), a host step power becomes an fp32 scalar."""
    if isinstance(cur, torch.Tensor):
        src = v if isinstance(v, torch.Tensor) else to_torch(np.asarray(v))
        if tuple(src.shape) != tuple(cur.shape):
            raise ValueError(f"set_state_dict: {key} is "
                             f"{tuple(src.shape)}, the state holds "
                             f"{tuple(cur.shape)}")
        cur.copy_(src)
        return cur
    return _F32(float(v))


def _named(parameters) -> dict:
    """``{name: tensor}`` from ``named_parameters()`` pairs, a dict, or bare
    tensors (named by position)."""
    if parameters is None:
        return {}
    if isinstance(parameters, dict):
        return dict(parameters)
    items = list(parameters)
    if all(isinstance(p, tuple) for p in items):
        return dict(items)
    return {str(i): p for i, p in enumerate(items)}


class Optimizer:
    """Holds per-parameter state by name. The train step calls
    ``apply_gradients`` with the model's named parameters (clipping is the
    train step's); ``step()`` updates the ``parameters`` given here
    (``named_parameters()``, a dict, or tensors) from their ``.grad``,
    clipping first, as the JAX package's eager step does.

    ``learning_rate`` is a float or an ``LRScheduler``, whose ``last_lr``
    each step reads; the caller advances the scheduler."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate).__name__}")
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._params = _named(parameters)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        #: per-parameter state by name: moments, step powers, master weight
        self.state = {}
        self._step_count = 0  # eager step() calls (``global_step``)
        #: master weights copied into their parameters by a ``copy_`` (the
        #: fused kernel writes a contiguous bf16 parameter itself)
        self.master_copies = 0

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr.last_lr)
        return self._lr

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("Cannot set_lr when a LRScheduler is attached")
        self._lr = float(value)

    # ---- eager step over the parameters given at construction ----
    @torch.no_grad()
    def step(self):
        """Clip the ``.grad`` of the parameters given at construction with
        ``grad_clip``, then update them in place."""
        if not self._params:
            raise ValueError("Optimizer constructed without parameters; pass "
                             "parameters=model.named_parameters()")
        if self._grad_clip is not None:
            self._grad_clip.clip_([p.grad for p in self._params.values()])
        self._step_count += 1
        self.apply_gradients(self._params)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._params.values():
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        """``{f"{name}_{slot}": value}`` for every parameter that has
        state, ``global_step``, and ``LR_Scheduler`` when the learning rate
        is a scheduler (the JAX package's keys)."""
        out = {f"{name}_{k}": v for name, s in self.state.items()
               for k, v in s.items()}
        out["global_step"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load what ``state_dict`` gave (or the JAX package's, numpy or
        tensors): each slot of the parameters given at construction (and of
        any with state already) is copied into its tensor in place; the
        step powers are restored as fp32 host scalars."""
        if "global_step" in state_dict:
            self._step_count = int(state_dict["global_step"])
        if "LR_Scheduler" in state_dict and isinstance(self._lr,
                                                       LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        self.init_state(self._params)
        for name, s in self.state.items():
            for k in list(s):
                key = f"{name}_{k}"
                if key in state_dict:
                    s[k] = _load_slot(s[k], state_dict[key], key)

    set_dict = set_state_dict

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

    # ---- the updates (override) ----
    def _update(self, value, grad, state, lr, name):
        """Update ``value`` and ``state`` in place, for one tensor the
        grouped update does not take; ``grad`` is in ``value``'s dtype."""
        raise NotImplementedError

    def _groups(self, value, grad, state) -> bool:
        """True when ``_update_grouped`` takes this tensor with ``grad`` at
        its own dtype (the fused kernel casts in registers)."""
        return False

    def _update_grouped(self, items, lr):
        """Update every ``(name, param, value, grad, state)`` of ``items``
        in place, writing each ``param`` from a master ``value``."""
        raise NotImplementedError

    def _coupled_wd(self) -> float:
        """L2 regularisation folded into the gradient (Adam style)."""
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "coeff", wd))

    def _copy_master(self, p, value):
        p.copy_(value)
        self.master_copies += 1

    @torch.no_grad()
    def apply_gradients(self, named_params, lr=None):
        """Update every parameter of ``{name: param}`` that has a ``.grad``,
        in place (``apply_gradients`` analog; no clipping here): the
        tensors ``_groups`` takes all at once, the others one by one."""
        lr = self.get_lr() if lr is None else float(lr)
        self.init_state(named_params)
        cwd = self._coupled_wd()
        grouped = []
        for name, p in named_params.items():
            g = p.grad
            if g is None:
                continue
            s = self.state[name]
            value = s.get("master_weight", p)
            if cwd:
                g = g.to(value.dtype) + cwd * value
            if self._groups(value, g, s):
                grouped.append((name, p, value, g, s))
                continue
            self._update(value, g.to(value.dtype), s, lr, name)
            if value is not p:
                self._copy_master(p, value)
        if grouped:
            self._update_grouped(grouped, lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._lazy_mode = bool(lazy_mode)
        self._use_multi_tensor = bool(use_multi_tensor)
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

    def _groups(self, value, grad, state) -> bool:
        return (not self._amsgrad and (value.dtype, grad.dtype,
                                       state["moment1"].dtype) in COMBOS
                and state["moment2"].dtype == state["moment1"].dtype)

    def _tensor_lr(self, lr, name) -> float:
        """The learning rate of parameter ``name``."""
        return lr

    def _decay(self, name) -> float:
        """The decoupled weight decay of parameter ``name``."""
        return 0.0

    def _update_grouped(self, items, lr):
        """The fused kernel over every tensor of ``items``: one launch per
        dtype combination. A master's bf16 parameter is written by the
        same launch where it is contiguous, by ``copy_`` otherwise."""
        names, params, values, grads, states = zip(*items)
        b1p = np.array([s["beta1_pow"] for s in states], _F32) \
            * _F32(self._beta1)
        b2p = np.array([s["beta2_pow"] for s in states], _F32) \
            * _F32(self._beta2)
        low = []
        for s, x1, x2, p, value in zip(states, b1p, b2p, params, values):
            s["beta1_pow"], s["beta2_pow"] = x1, x2
            low.append(p if value is not p and p.dtype == torch.bfloat16
                       and p.is_contiguous() else None)
        fused_adamw_multi(
            values, grads, [s["moment1"] for s in states],
            [s["moment2"] for s in states],
            lr=[self._tensor_lr(lr, n) for n in names], beta1=self._beta1,
            beta2=self._beta2, eps=self._epsilon,
            weight_decay=[self._decay(n) for n in names],
            beta1_pow=list(b1p), beta2_pow=list(b2p), low=low)
        for p, value, lo in zip(params, values, low):
            if value is not p and lo is None:
                self._copy_master(p, value)

    def _update(self, value, grad, state, lr, name):
        lr = self._tensor_lr(lr, name)
        self._adam(value, grad, state, lr, decay=float(
            _F32(1) - _F32(lr) * _F32(self._decay(name))))

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
    the decay for that parameter, and ``lr_ratio(name)`` multiplies its
    learning rate, as in paddle's AdamW (names come from
    ``named_parameters()`` or the train step). The JAX package stores
    ``lr_ratio`` without applying it; with ``lr_ratio`` None the two agree."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad,
                         moment_dtype=moment_dtype)
        self._wd_coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _coupled_wd(self):
        return 0.0

    def _tensor_lr(self, lr, name):
        if self._lr_ratio is not None:
            return lr * float(self._lr_ratio(name))
        return lr

    def _decay(self, name):
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd_coeff
