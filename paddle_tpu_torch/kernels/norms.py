"""Fused LayerNorm and RMSNorm, forward and backward, CUDA C++ for Hopper
(``csrc/norms.cu``).

Replaces ``paddle_tpu/kernels/norms.py`` ``_ln_kernel`` (launched by
``_ln_fwd``, wrapped by ``fused_layer_norm``): row-wise LayerNorm with
affine, mean and biased variance in fp32, ``rsqrt(var + eps)`` and the
affine in fp32, the result cast to x's dtype. And ``_rms_kernel`` (launched
by ``_rms_fwd``, wrapped by ``fused_rms_norm``): ``x * rsqrt(mean(x^2) +
eps) * w`` with the statistic in fp32. The backwards are ``_ln_bwd_rule``
and ``_rms_bwd_rule``, which the JAX package computes outside Pallas and
XLA fuses; here one kernel (and a small one that sums its per-block
partials of dw and db) is their counterpart.

The kernel source says what bounds them and how they are laid out. This
module holds the plain PyTorch versions (``layer_norm_ref``,
``layer_norm_bwd_ref``, ``rms_norm_ref``, ``rms_norm_bwd_ref``), which CPU
tensors run, the ``ctypes`` binding, and the four wrappers. On CUDA tensors
each wrapper launches its kernel or raises. ``LayerNormFunction`` and
``RMSNormFunction`` join each forward to its backward; the forwards go
through them only when autograd needs a backward, so calls under
``no_grad`` reach the kernel with no autograd overhead. The decode step
calls the forwards on a few rows, where the host's cost of a call is most
of its time, so the launch path creates no device tensor from a host
value and copies only what is not contiguous; ``_build.load`` keeps the
bound library.

Each wrapper counts its launches in ``launches`` and by route in
``route_launches`` (``ROUTES``; ``route`` picks one from the shape).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"norm_fwd": [_P] * 4 + [_I] * 2 + [_F] + [_I] * 4 + [_P],
               "norm_bwd_grid": [_I] * 6,
               "norm_bwd": [_P] * 7 + [_I] * 2 + [_F] + [_I] * 5 + [_P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LN, _RMS = 0, 1
#: the kernels' routes and their codes: one warp per row, the row in
#: registers; or one block per row, for any H
ROUTES = {"warp": 0, "block": 1}
#: the widest row the warp route holds in registers
WARP_MAX_H = 2048


def route(H: int, itemsize: int, ptrs) -> str:
    """The route for rows of ``H`` elements of ``itemsize`` bytes whose
    tensors start at the addresses ``ptrs``: ``"warp"`` when H is a
    multiple of the 16-byte vector, at most ``WARP_MAX_H``, and every
    address is 16-byte aligned; else ``"block"``."""
    if H % (16 // itemsize) == 0 and H <= WARP_MAX_H \
            and not any(p % 16 for p in ptrs):
        return "warp"
    return "block"


def _dense(t):
    return t if t.is_contiguous() else t.contiguous()


def _check(name, x, params, weight):
    """x's and the parameters' device, shape and dtype codes, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    H = x.shape[-1]
    for pname, t in params:
        if t.device != x.device or t.shape != (H,):
            raise ValueError(f"{name}: {pname} must be [{H}] on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if t.dtype != weight.dtype:
            raise ValueError(f"{name}: {pname} is {t.dtype}, the weight "
                             f"{weight.dtype}")
    xd, wd = _DTYPE_CODE.get(x.dtype), _DTYPE_CODE.get(weight.dtype)
    if xd is None or wd is None:
        raise ValueError(f"{name}: unsupported dtypes x {x.dtype}, weight "
                         f"{weight.dtype} (float32 or bfloat16 each)")
    return H, xd, wd


def _stream(x):
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _forward(wrapper, norm, x, weight, bias, eps):
    params = (("weight", weight),) + ((("bias", bias),) if bias is not None
                                      else ())
    H, xd, wd = _check(wrapper.__name__, x, params, weight)
    x2, w = _dense(x), _dense(weight)
    b = w if bias is None else _dense(bias)
    y = torch.empty_like(x2)
    R = x2.numel() // H if H else 0
    if R:
        r = route(H, x2.element_size(),
                  (x2.data_ptr(), w.data_ptr(), b.data_ptr()))
        lib = _build.load("norms", _SIGNATURES)
        err = lib.norm_fwd(x2.data_ptr(), w.data_ptr(), b.data_ptr(),
                           y.data_ptr(), R, H, eps, norm, xd, wd, ROUTES[r],
                           _stream(x))
        _build.check(err, wrapper.__name__)
        wrapper.launches += 1
        wrapper.route_launches[r] += 1
    return y


def _backward(wrapper, norm, x, weight, g, eps):
    """(dx, dw, db): db is None for RMSNorm."""
    name = wrapper.__name__
    H, xd, wd = _check(name, x, (("weight", weight),), weight)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{name}: the gradient must be like x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    x2, g2, w = _dense(x), _dense(g), _dense(weight)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(w) if norm == _LN else None
    R = x2.numel() // H if H else 0
    if not R:
        for t in (dw, db):
            if t is not None:
                t.zero_()
        return dx, dw, db
    lib = _build.load("norms", _SIGNATURES)
    r = route(H, x2.element_size(),
              (x2.data_ptr(), g2.data_ptr(), w.data_ptr()))
    G = lib.norm_bwd_grid(R, H, norm, xd, wd, ROUTES[r])
    if G <= 0:
        raise RuntimeError(f"{name}: no grid for rows {R} x {H} on the "
                           f"{r} route")
    partial = torch.empty(((2 if norm == _LN else 1) * G * H,),
                          dtype=torch.float32, device=x.device)
    err = lib.norm_bwd(x2.data_ptr(), w.data_ptr(), g2.data_ptr(),
                       dx.data_ptr(), dw.data_ptr(),
                       (dw if db is None else db).data_ptr(),
                       partial.data_ptr(), R, H, eps, norm, xd, wd,
                       ROUTES[r], G, _stream(x))
    _build.check(err, name)
    wrapper.launches += 1
    wrapper.route_launches[r] += 1
    return dx, dw, db


# ---------------- LayerNorm ------------------------------------------------
def layer_norm_ref(x, weight, bias, eps: float = 1e-5):
    """Plain PyTorch version of ``_ln_kernel`` (same order of operations)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_ref(x, weight, g, eps: float = 1e-5):
    """``_ln_bwd_rule`` in plain PyTorch: mean and rstd recomputed from x in
    fp32; returns ``(dx, dw, db)`` with dx in x's dtype and dw, db (fp32
    sums over rows) in the weight's dtype."""
    H = x.shape[-1]
    xf = x.reshape(-1, H).float()
    g2 = g.reshape(-1, H).float()
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    wg = g2 * weight.float()
    dx = (wg - wg.mean(dim=-1, keepdim=True)
          - xhat * (wg * xhat).mean(dim=-1, keepdim=True)) * rstd
    dw = (g2 * xhat).sum(dim=0)
    db = g2.sum(dim=0)
    return (dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype),
            db.to(weight.dtype))


def layer_norm_bwd(x, weight, g, eps: float = 1e-5):
    """``(dx, dw, db)`` of LayerNorm at ``x`` for the output's gradient
    ``g``, as ``layer_norm_bwd_ref`` returns them. CPU tensors run
    ``layer_norm_bwd_ref``; CUDA tensors launch the backward kernel or
    raise."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(x, weight, g, eps)
    dx, dw, db = _backward(layer_norm_bwd, _LN, x, weight, g, eps)
    return dx.view(x.shape), dw, db


class LayerNormFunction(torch.autograd.Function):
    """``fused_layer_norm`` forward, ``layer_norm_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return fused_layer_norm(x, weight, bias, eps)  # grad is off here

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, db, None


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape) with
    ``weight``/``bias`` of shape ``[H]`` (one dtype). CPU tensors run
    ``layer_norm_ref``; CUDA tensors launch the forward kernel or raise.
    When autograd will need a backward, the call goes through
    ``LayerNormFunction``."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps)
    return _forward(fused_layer_norm, _LN, x, weight, bias, eps).view(x.shape)


# ---------------- RMSNorm --------------------------------------------------
def rms_norm_ref(x, weight, eps: float = 1e-6):
    """Plain PyTorch version of ``_rms_kernel`` (same order of operations)."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype)


def rms_norm_bwd_ref(x, weight, g, eps: float = 1e-6):
    """``_rms_bwd_rule`` in plain PyTorch: rstd recomputed from x in fp32;
    returns ``(dx, dw)`` with dx in x's dtype and dw (an fp32 sum over rows)
    in the weight's dtype."""
    H = x.shape[-1]
    xf = x.reshape(-1, H).float()
    g2 = g.reshape(-1, H).float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    wg = g2 * weight.float()
    dx = (wg - xhat * (wg * xhat).mean(dim=-1, keepdim=True)) * rstd
    dw = (g2 * xhat).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype)


def rms_norm_bwd(x, weight, g, eps: float = 1e-6):
    """``(dx, dw)`` of RMSNorm at ``x`` for the output's gradient ``g``, as
    ``rms_norm_bwd_ref`` returns them. CPU tensors run ``rms_norm_bwd_ref``;
    CUDA tensors launch the backward kernel or raise."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, weight, g, eps)
    dx, dw, _ = _backward(rms_norm_bwd, _RMS, x, weight, g, eps)
    return dx.view(x.shape), dw


class RMSNormFunction(torch.autograd.Function):
    """``fused_rms_norm`` forward, ``rms_norm_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return fused_rms_norm(x, weight, eps)  # grad is off here

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None


def fused_rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading shape) with
    ``weight`` of shape ``[H]``. CPU tensors run ``rms_norm_ref``; CUDA
    tensors launch the forward kernel or raise. When autograd will need a
    backward, the call goes through ``RMSNormFunction``."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, eps)
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    return _forward(fused_rms_norm, _RMS, x, weight, None, eps).view(x.shape)


for _w in (fused_layer_norm, layer_norm_bwd, fused_rms_norm, rms_norm_bwd):
    _w.launches = 0
    _w.route_launches = dict.fromkeys(ROUTES, 0)
del _w
