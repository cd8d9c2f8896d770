"""Flash attention forward, CUDA C++ for Hopper (``csrc/flash_fwd.cu``).

Replaces ``paddle_tpu/kernels/flash_attention.py`` ``_fwd_kernel``
(launched by ``_fwd``, entered through ``flash_attention_fwd``). The kernel
source says what bounds it and how it is laid out; this module holds the
plain PyTorch version of the same function, the ``ctypes`` binding and the
wrapper.

Unlike the TPU wrapper there is no block-divisibility requirement: the
kernel masks the ragged sequence edge itself, so every ``S`` is accepted.
The backward kernels (``_dq_kernel`` / ``_dkv_kernel``) belong to the
training slice and are not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # the softmax runs in the exp2 domain

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_fwd": [_P] * 5 + [_I] * 5 + [_LL] * 6
               + [_F, _I, _I, _P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def _check_heads(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash attention wants q [B,S,H,D] and k/v "
                         f"[B,S,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    return B, S, H, D


def flash_attention_ref(q, k, v, causal: bool = False, scale: float = None):
    """Plain PyTorch version of ``_fwd_kernel``: returns ``(o, lse)`` with
    o ``[B, S, H, D]`` in q's dtype and the log2-domain LSE ``[B*H, S]``
    fp32. Scores are fp32 products of the native-dtype operands scaled by
    ``scale*LOG2E``, P is cast to v's dtype before P.V, and a zero row sum
    divides by 1 — the kernel's arithmetic, in one dense pass."""
    B, S, H, D = _check_heads(q, k, v)
    rep = H // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * torch.tensor(scale * LOG2E, dtype=torch.float32)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log2(l)).reshape(B * H, S)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_fwd(q, k, v, causal: bool = False, scale: float = None):
    """``[B, S, H, D]`` flash attention forward; K/V may carry fewer heads
    (GQA, ``H % Hkv == 0``). Returns ``(o, lse)`` as ``flash_attention_ref``
    does. CPU tensors run the plain version; CUDA tensors launch the kernel
    or raise."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    B, S, H, D = _check_heads(q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q, k, v must share a device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd: q/k/v must all be float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {D} not built; "
                         f"the kernel is instantiated for {HEAD_DIMS}")
    # unit feature stride and packed heads; batch/seq strides are free, so
    # column slices of the fused qkv projection need no copy
    q, k, v = (t if t.stride(3) == 1 and t.stride(2) == D else t.contiguous()
               for t in (q, k, v))
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if B * S == 0:
        return o, lse
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    lib = _build.load("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, H, k.shape[2], D, q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), scale * LOG2E, int(causal),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
