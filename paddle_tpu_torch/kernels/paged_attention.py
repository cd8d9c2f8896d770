"""Ragged paged-decode attention, CUDA C++ for Hopper (``csrc/paged_decode.cu``).

Replaces ``paddle_tpu/kernels/paged_attention.py`` ``_decode_kernel``
(launched by ``paged_attention``). The kernel source says what bounds it
and how it is laid out; this module holds the plain PyTorch version of the
same function (gather the live pages into the dense layout, then the
``decode_attend`` oracle), the ``ctypes`` binding and the wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_decode": [_P] * 6 + [_I] * 7 + [_P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _q_scale(D: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) rounded to ``dtype``, as a Python float (exact)."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=dtype))


def prescale_q(q):
    """``q * 1/sqrt(D)`` in q's own dtype: the scale is rounded to q's dtype
    first and the product rounds back to it, as the TPU wrapper does. In
    bf16 that rounding is part of the function. The rounded scale is a
    host number, so a call copies nothing to the card and does not wait
    for it."""
    return q * _q_scale(q.shape[-1], q.dtype)


def paged_gather(pool, page_table):
    """Dense ``[B, H_kv, num_blocks*ps, D]`` view of a ``[P, H_kv, ps, D]``
    page pool under a ``[B, num_blocks]`` table; sentinels clamp to the
    trash page 0, whose bytes the decode mask never admits."""
    g = pool[page_table.long().clamp(min=0)]       # [B, nb, Hkv, ps, D]
    B, nb, Hkv, ps, D = g.shape
    return g.transpose(1, 2).reshape(B, Hkv, nb * ps, D)


def decode_attend(q, k_cache, v_cache, positions):
    """Single-position cached attention, the oracle: q ``[B, H_q, T, D]``
    against dense caches ``[B, H_kv, S_max, D]``, masked to
    ``key_pos <= positions`` (per row ``[B]`` or a scalar). q is pre-scaled
    in its own dtype, scores and softmax are fp32, and the output is cast
    to v's dtype."""
    rep = q.shape[1] // k_cache.shape[1]
    k = k_cache.repeat_interleave(rep, dim=1) if rep > 1 else k_cache
    v = v_cache.repeat_interleave(rep, dim=1) if rep > 1 else v_cache
    s = torch.einsum("bhqd,bhkd->bhqk", prescale_q(q).float(), k.float())
    pos = torch.as_tensor(positions, device=q.device)
    key_pos = torch.arange(k_cache.shape[2], device=q.device)
    if pos.dim() == 0:
        valid = key_pos <= pos
    else:
        valid = key_pos[None, None, None, :] <= pos[:, None, None, None]
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()) \
        .to(v.dtype)


def paged_attention_ref(q, k_pool, v_pool, page_table, positions):
    """Plain PyTorch version of ``_decode_kernel``: the dense view of the
    pools under the table, attended by ``decode_attend``."""
    return decode_attend(q, paged_gather(k_pool, page_table),
                         paged_gather(v_pool, page_table), positions)


def paged_attention(q, k_pool, v_pool, page_table, positions):
    """Ragged paged-decode attention over block-paged KV pools.

    q            ``[B, H_q, 1, D]`` — one query token per slot
    k/v_pool     ``[P, H_kv, page_size, D]`` — this layer's page pools
    page_table   ``[B, num_blocks]`` int32 pool page ids (-1 = unallocated)
    positions    ``[B]`` int32 — each slot's current token index

    Returns ``[B, H_q, 1, D]`` in v's dtype. CPU tensors run
    ``paged_attention_ref``; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    B, Hq, T, D = q.shape
    if T != 1:
        raise ValueError(f"paged_attention decodes one token per slot, "
                         f"got T={T}")
    P, Hkv, ps, Dk = k_pool.shape
    if Dk != D or v_pool.shape != k_pool.shape or Hq % Hkv:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError("paged_attention: q and pools must all be float32 "
                         f"or bfloat16, got {q.dtype}/{k_pool.dtype}/"
                         f"{v_pool.dtype}")
    nb = page_table.shape[1]
    if tuple(page_table.shape) != (B, nb) or page_table.dtype != torch.int32:
        raise ValueError("paged_attention: page_table must be [B, nb] int32")
    pos = torch.as_tensor(positions, device=q.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    if tuple(pos.shape) != (B,) or pos.dtype != torch.int32:
        raise ValueError("paged_attention: positions must be [B] int32")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("positions", pos)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention: the page pools must be contiguous")
    qs = prescale_q(q[:, :, 0, :]).contiguous()
    table = page_table.contiguous()
    pos = pos.contiguous()
    out = torch.empty((B, Hq, D), dtype=v_pool.dtype, device=q.device)
    if B:
        lib = _build.load("paged_decode", _SIGNATURES)
        err = lib.paged_decode(
            qs.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, ps,
            nb, D, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "paged_decode")
        paged_attention.launches += 1
    return out[:, :, None, :]


paged_attention.launches = 0
