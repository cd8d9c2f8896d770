"""Fused LayerNorm forward, Triton for Hopper.

Replaces ``paddle_tpu/kernels/norms.py`` ``_ln_kernel`` (launched by
``_ln_fwd``, wrapped by ``fused_layer_norm``): row-wise LayerNorm with
affine. Mean and biased variance are taken in fp32, ``rsqrt(var + eps)``
and the affine run in fp32, and the result is cast to x's dtype.

What bounds it on the H100: bytes. Each row of H values is read once and
written once and does ~8 operations per element, far below the ~295
operations per byte where the tensor cores, not memory, become the limit.
The design keeps the whole row in registers (one program per row, the row
padded to a power of two and masked), so x is read from device memory once
and the statistics never leave the chip; w and b stay in L2 across rows.
"""

from __future__ import annotations

import torch

from . import _build

_kernel = None


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


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape) with
    ``weight``/``bias`` of shape ``[H]``. CPU tensors run ``layer_norm_ref``;
    CUDA tensors launch the Triton kernel or raise."""
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
