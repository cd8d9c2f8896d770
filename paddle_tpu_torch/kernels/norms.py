"""Fused LayerNorm and RMSNorm forwards, Triton for Hopper.

Replaces ``paddle_tpu/kernels/norms.py`` ``_ln_kernel`` (launched by
``_ln_fwd``, wrapped by ``fused_layer_norm``): row-wise LayerNorm with
affine. Mean and biased variance are taken in fp32, ``rsqrt(var + eps)``
and the affine run in fp32, and the result is cast to x's dtype. And
``_rms_kernel`` (launched by ``_rms_fwd``, wrapped by ``fused_rms_norm``):
``x * rsqrt(mean(x^2) + eps) * w`` with the statistic in fp32.

What bounds both on the H100: bytes. Each row of H values is read once and
written once and does ~8 operations per element, far below the ~295
operations per byte where the tensor cores, not memory, become the limit.
The design keeps the whole row in registers (one program per row, the row
padded to a power of two and masked), so x is read from device memory once
and the statistics never leave the chip; w and b stay in L2 across rows.

The backwards are ``_ln_bwd_rule``'s and ``_rms_bwd_rule``'s arithmetic in
plain PyTorch, as the JAX package computes them outside Pallas:
``LayerNormFunction`` and ``RMSNormFunction`` join each forward kernel to
its backward, and the wrappers go through them only when autograd needs a
backward, so calls under ``no_grad`` reach the kernel with no autograd
overhead.
"""

from __future__ import annotations

import torch

from . import _build

_kernel = None
_rms_kernel = None


def layer_norm_ref(x, weight, bias, eps: float = 1e-5):
    """Plain PyTorch version of ``_ln_kernel`` (same order of operations)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _get_kernel():
    global _kernel
    if _kernel is None:
        _build.triton()
        import triton
        import triton.language as tl

        @triton.jit
        def _ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, H, eps,
                           BLOCK_H: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_H)
            mask = cols < H
            x = tl.load(x_ptr + row * H + cols, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / H
            xc = tl.where(mask, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / H
            rstd = tl.rsqrt(var + eps)
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = xc * rstd * w + b
            tl.store(y_ptr + row * H + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        _kernel = (triton, _ln_fwd_kernel)
    return _kernel


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


class LayerNormFunction(torch.autograd.Function):
    """The LayerNorm kernel (or ``layer_norm_ref`` on the CPU) forward,
    ``layer_norm_bwd_ref`` backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return fused_layer_norm(x, weight, bias, eps)  # grad is off here

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd_ref(x, weight, g, ctx.eps)
        return dx, dw, db, None


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape) with
    ``weight``/``bias`` of shape ``[H]``. CPU tensors run ``layer_norm_ref``;
    CUDA tensors launch the Triton kernel or raise. When autograd will need
    a backward, the call goes through ``LayerNormFunction``."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    H = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (H,):
            raise ValueError(f"fused_layer_norm: {name} must be [{H}] on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_layer_norm: unsupported dtype {x.dtype}")
    triton, kernel = _get_kernel()
    x2 = x.contiguous().view(-1, H)
    y = torch.empty_like(x2)
    R = x2.shape[0]
    if R:
        block = triton.next_power_of_2(H)
        kernel[(R,)](x2, weight.contiguous(), bias.contiguous(), y, H,
                     float(eps), BLOCK_H=block,
                     num_warps=min(max(block // 256, 1), 16))
        fused_layer_norm.launches += 1
    return y.view(x.shape)


fused_layer_norm.launches = 0


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


def _get_rms_kernel():
    global _rms_kernel
    if _rms_kernel is None:
        _build.triton()
        import triton
        import triton.language as tl

        @triton.jit
        def _rms_fwd_kernel(x_ptr, w_ptr, y_ptr, H, eps,
                            BLOCK_H: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_H)
            mask = cols < H
            x = tl.load(x_ptr + row * H + cols, mask=mask,
                        other=0.0).to(tl.float32)
            rstd = tl.rsqrt(tl.sum(x * x, axis=0) / H + eps)
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            tl.store(y_ptr + row * H + cols,
                     (x * rstd * w).to(y_ptr.dtype.element_ty), mask=mask)

        _rms_kernel = (triton, _rms_fwd_kernel)
    return _rms_kernel


class RMSNormFunction(torch.autograd.Function):
    """The RMSNorm kernel (or ``rms_norm_ref`` on the CPU) forward,
    ``rms_norm_bwd_ref`` backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return fused_rms_norm(x, weight, eps)  # grad is off here

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd_ref(x, weight, g, ctx.eps)
        return dx, dw, None


def fused_rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading shape) with
    ``weight`` of shape ``[H]``. CPU tensors run ``rms_norm_ref``; CUDA
    tensors launch the Triton kernel or raise. When autograd will need a
    backward, the call goes through ``RMSNormFunction``."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, eps)
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rms_norm: unsupported device {x.device}")
    H = x.shape[-1]
    if weight.device != x.device or tuple(weight.shape) != (H,):
        raise ValueError(f"fused_rms_norm: weight must be [{H}] on "
                         f"{x.device}, got {tuple(weight.shape)} on "
                         f"{weight.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_rms_norm: unsupported dtype {x.dtype}")
    triton, kernel = _get_rms_kernel()
    x2 = x.contiguous().view(-1, H)
    y = torch.empty_like(x2)
    R = x2.shape[0]
    if R:
        block = triton.next_power_of_2(H)
        kernel[(R,)](x2, weight.contiguous(), y, H, float(eps),
                     BLOCK_H=block, num_warps=min(max(block // 256, 1), 16))
        fused_rms_norm.launches += 1
    return y.view(x.shape)


fused_rms_norm.launches = 0
