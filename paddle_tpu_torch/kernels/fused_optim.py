"""Fused AdamW update, CUDA C++ for Hopper (``csrc/fused_adamw.cu``).

Replaces ``paddle_tpu/kernels/fused_optim.py`` ``_adamw_kernel`` (launched
by ``fused_adamw_update``): moments, bias correction, decoupled decay and
the new parameter in one pass over memory, with p, g, m and v read at their
native dtypes and cast in registers. The kernel source says what bounds it
and how it is laid out; this module holds the plain PyTorch version, the
``ctypes`` binding and the wrapper.

Two differences from the TPU side, both deliberate:

* The update happens in place: p, m and v are written where they lie (the
  JAX function returns new arrays). The wrapper returns the same tensors.
* The JAX optimizer sends only tensors of 65536 elements or more to the
  kernel (``optimizer.py`` ``_use_fused_kernel``), because the TPU kernel
  pads each tensor to ``(rows, 128)`` lanes. The Hopper kernel is a
  grid-stride loop with no such cost, so ``AdamW`` in this package sends
  every float32/bfloat16 tensor (not ``amsgrad``) through it. The JAX
  non-fused arithmetic (decay, then ``Adam._update``) agrees with the
  kernel's to rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fused_adamw": [_P] * 4 + [_LL] + [_I] * 3 + [_F] * 9 + [_P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (param, grad, moments) dtype combinations the optimizer produces: the
# grad is in the param's dtype, or bf16 beside an fp32 master weight
_COMBOS = {(p, g, m) for p in _DTYPE_CODE for m in _DTYPE_CODE
           for g in {p, torch.bfloat16}}


def _hyper(lr, beta1, beta2, eps, weight_decay, beta1_pow, beta2_pow):
    """The kernel's fp32 constants, computed as the TPU kernel computes them
    from its fp32 scalars: 1-b1, 1-b2, 1-lr*wd, 1-b1p, 1-b2p."""
    f = np.float32
    one = f(1.0)
    return dict(lr=f(lr), b1=f(beta1), omb1=one - f(beta1), b2=f(beta2),
                omb2=one - f(beta2), eps=f(eps),
                decay=one - f(lr) * f(weight_decay),
                omb1p=one - f(beta1_pow), omb2p=one - f(beta2_pow))


def adamw_ref(param, grad, m, v, *, lr, beta1, beta2, eps, weight_decay,
              beta1_pow, beta2_pow):
    """Plain PyTorch version of ``_adamw_kernel``: returns new
    ``(param, m, v)`` in their own dtypes, computed in fp32 with one
    rounding per operation, in the kernel's order. ``beta*_pow`` are the new
    powers (``beta**t``)."""
    c = {k: torch.tensor(x, dtype=torch.float32, device=param.device)
         for k, x in _hyper(lr, beta1, beta2, eps, weight_decay, beta1_pow,
                            beta2_pow).items()}
    g = grad.float()
    m32 = c["b1"] * m.float() + c["omb1"] * g
    v32 = c["b2"] * v.float() + c["omb2"] * g * g
    m_hat = m32 / c["omb1p"]
    v_hat = v32 / c["omb2p"]
    p32 = param.float() * c["decay"] \
        - c["lr"] * m_hat / (torch.sqrt(v_hat) + c["eps"])
    return p32.to(param.dtype), m32.to(m.dtype), v32.to(v.dtype)


def fused_adamw_update(param, grad, m, v, *, lr, beta1, beta2, eps,
                       weight_decay, beta1_pow, beta2_pow):
    """One AdamW step for one tensor, in place: ``param``, ``m`` and ``v``
    are overwritten and returned. ``beta*_pow`` are the new powers.
    CPU tensors run ``adamw_ref``; CUDA tensors launch the kernel or
    raise."""
    for name, t in (("grad", grad), ("m", m), ("v", v)):
        if t.shape != param.shape or t.device != param.device:
            raise ValueError(f"fused_adamw_update: {name} must be "
                             f"{tuple(param.shape)} on {param.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if (param.dtype, grad.dtype, m.dtype) not in _COMBOS or m.dtype != v.dtype:
        raise ValueError("fused_adamw_update: unsupported dtypes param "
                         f"{param.dtype}, grad {grad.dtype}, m {m.dtype}, "
                         f"v {v.dtype}")
    hp = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, beta1_pow=beta1_pow,
              beta2_pow=beta2_pow)
    if param.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip((param, m, v), adamw_ref(param, grad, m, v,
                                                         **hp)):
                dst.copy_(src)
        return param, m, v
    if param.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: unsupported device "
                         f"{param.device}")
    if not all(t.is_contiguous() for t in (param, grad, m, v)):
        raise ValueError("fused_adamw_update: tensors must be contiguous")
    n = param.numel()
    if n:
        h = {k: float(x) for k, x in _hyper(**hp).items()}  # exact
        lib = _build.load("fused_adamw", _SIGNATURES)
        err = lib.fused_adamw(
            param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(), n,
            _DTYPE_CODE[param.dtype], _DTYPE_CODE[grad.dtype],
            _DTYPE_CODE[m.dtype], h["lr"], h["b1"], h["omb1"], h["b2"],
            h["omb2"], h["eps"], h["decay"], h["omb1p"], h["omb2p"],
            torch.cuda.current_stream(param.device).cuda_stream)
        _build.check(err, "fused_adamw")
        fused_adamw_update.launches += 1
    return param, m, v


fused_adamw_update.launches = 0
