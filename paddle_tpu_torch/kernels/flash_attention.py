"""Flash attention, CUDA C++ for Hopper: the forward and the two backward
kernels, each routed by dtype (``FWD_ROUTES``, ``BWD_ROUTES``): bf16 on the
tensor cores (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``: wgmma
fed by TMA), fp32 on the CUDA cores (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), where wgmma would round the operands to TF32.

Replaces ``paddle_tpu/kernels/flash_attention.py`` ``_fwd_kernel``
(launched by ``_fwd``) and ``_dq_kernel`` / ``_dkv_kernel`` (launched by
``_bwd``), entered there through the ``custom_vjp`` of
``flash_attention_fwd``. The kernel sources say what bounds them and how
they are laid out; this module holds the plain PyTorch versions of the same
functions, the ``ctypes`` bindings, the wrappers and the dispatcher op
``paddle_tpu_torch::flash_fwd`` whose autograd formula joins forward and
backward.

Unlike the TPU wrappers there is no block-divisibility requirement: the
kernels mask the ragged sequence edge themselves, so every ``S`` is
accepted. K/V may carry fewer heads than q (GQA) in both directions; the
backward sums each KV head's gradient over its query heads.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # the softmax runs in the exp2 domain

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the C signature of each entry; the wgmma route's library and entries
# carry the suffix ``_sm90`` and the same signatures
_ARGS = {"flash_fwd": [_P] * 5 + [_I] * 5 + [_LL] * 6 + [_F, _I, _P],
         "flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_LL] * 6 + [_F, _F, _I, _P],
         "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_LL] * 6 + [_F, _F, _I, _P]}
_LIBS = {"flash_fwd": ("flash_fwd",),
         "flash_bwd": ("flash_bwd_dq", "flash_bwd_dkv")}
#: each kernel's route by dtype, the keys of its wrapper's ``route_launches``
FWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda_cores"}
BWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda_cores"}
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


def _launch_inputs(name, q, k, v):
    """The checks every kernel of this module makes before a launch.
    Returns ``(B, S, H, D)`` and q, k, v with unit feature stride and
    packed heads; batch and sequence strides are free, so column slices of
    the fused qkv projection need no copy (in bf16, whose TMA reads want
    16-byte multiples, when ``_for_tma`` keeps them)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, S, H, D = _check_heads(q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must share a device")
    if q.dtype not in FWD_ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must all be float32 or bfloat16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not built; the kernel is "
                         f"instantiated for {HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 and t.stride(2) == D else t.contiguous()
               for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = map(_for_tma, (q, k, v))
    return (B, S, H, D), q, k, v


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1))


def _entry(lib, entry, route):
    """The C entry ``entry`` of library ``lib`` on ``route`` (the wgmma
    route's names carry ``_sm90``), bound with every signature of that
    library."""
    sfx = "_sm90" if route == "wgmma" else ""
    sigs = {e + sfx: _ARGS[e] for e in _LIBS[lib]}
    return getattr(_build.load(lib + sfx, sigs), entry + sfx)


def _count(wrapper, route):
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def flash_attention_fwd(q, k, v, causal: bool = False, scale: float = None):
    """``[B, S, H, D]`` flash attention forward; K/V may carry fewer heads
    (GQA, ``H % Hkv == 0``). Returns ``(o, lse)`` as ``flash_attention_ref``
    does. CPU tensors run the plain version; CUDA tensors launch the kernel
    of their dtype's route (``FWD_ROUTES``) or raise."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    (B, S, H, D), q, k, v = _launch_inputs("flash_attention_fwd", q, k, v)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if B * S == 0:
        return o, lse
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    route = FWD_ROUTES[q.dtype]
    fn = _entry("flash_fwd", "flash_fwd", route)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, S, H, k.shape[2], D, *_strides(q, k, v),
             scale * LOG2E, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, fn.__name__)
    _count(flash_attention_fwd, route)
    return o, lse


# ---------------- backward -------------------------------------------------
def _delta(o, do):
    """``rowsum(dO * O)`` in fp32 as ``[B*H, S]``, computed outside the
    kernels as ``_bwd`` computes it."""
    B, S, H, _ = o.shape
    d = (do.float() * o.float()).sum(dim=-1)  # [B, S, H]
    return d.permute(0, 2, 1).reshape(B * H, S)


def _bwd_core_ref(q, k, v, do, lse, delta, causal, scale):
    """dq, dk, dv with the backward kernels' arithmetic in one dense pass:
    P recomputed from the log2-domain LSE, ds and P rounded to the operand
    dtype before their products, fp32 sums, GQA gradients summed over each
    KV head's query heads."""
    B, S, H, D = _check_heads(q, k, v)
    Hkv = k.shape[2]
    rep = H // Hkv
    kx, vx = ((k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))
              if rep > 1 else (k, v))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) \
        * f32(scale * LOG2E)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp2(s - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vx.float())
    ds = (p * (dp - delta.reshape(B, H, S, 1)) * f32(scale)).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    if rep > 1:
        dk = dk.reshape(B, S, Hkv, rep, D).sum(dim=3)
        dv = dv.reshape(B, S, Hkv, rep, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = False,
                            scale: float = None):
    """Plain PyTorch version of ``_dq_kernel`` + ``_dkv_kernel``: from the
    forward's inputs ``q [B,S,H,D]``, ``k``/``v [B,S,Hkv,D]``, its output
    ``o`` and log2-domain ``lse [B*H, S]``, and the upstream gradient
    ``do [B,S,H,D]``, returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return _bwd_core_ref(q, k, v, do, lse, _delta(o, do), causal, scale)


def _for_tma(t):
    """``t`` itself if TMA can read it in place (16-byte aligned base,
    batch and sequence strides that are 16-byte multiples, as the fused qkv
    projection's column slices have), else a contiguous copy."""
    nbytes = t.element_size()
    if t.data_ptr() % 16 == 0 and all(t.stride(i) * nbytes % 16 == 0
                                      for i in (0, 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_launch_inputs(name, q, k, v, do, lse, delta):
    shape, q, k, v = _launch_inputs(name, q, k, v)
    B, S, H, _ = shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: do must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, got {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}")
    for what, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name}: {what} must be [{B * H}, {S}] float32 "
                             f"on {q.device}, got {tuple(t.shape)} {t.dtype}")
    do = do.contiguous()
    if q.dtype == torch.bfloat16:
        do = _for_tma(do)
    return shape, q, k, v, do, lse.contiguous(), delta.contiguous()


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           scale: float = None):
    """dQ ``[B, S, H, D]`` (``_dq_kernel``) from the forward's inputs, the
    upstream gradient ``do``, the log2-domain LSE and ``delta`` (both
    ``[B*H, S]`` fp32). CPU tensors run the plain version; CUDA tensors
    launch the kernel of their dtype's route (``BWD_ROUTES``) or raise."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return _bwd_core_ref(q, k, v, do, lse, delta, causal, scale)[0]
    (B, S, H, D), q, k, v, do, lse, delta = _bwd_launch_inputs(
        "flash_attention_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if B * S:
        route = BWD_ROUTES[q.dtype]
        fn = _entry("flash_bwd", "flash_bwd_dq", route)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H,
                 k.shape[2], D, *_strides(q, k, v), scale, scale * LOG2E,
                 int(causal), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, fn.__name__)
        _count(flash_attention_bwd_dq, route)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            scale: float = None):
    """``(dk, dv)``, each ``[B, S, Hkv, D]`` (``_dkv_kernel``), summed over
    the query heads that share a KV head. Arguments as
    ``flash_attention_bwd_dq``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return _bwd_core_ref(q, k, v, do, lse, delta, causal, scale)[1:]
    (B, S, H, D), q, k, v, do, lse, delta = _bwd_launch_inputs(
        "flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    Hkv = k.shape[2]
    dk = torch.empty((B, S, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, D), dtype=v.dtype, device=q.device)
    if B * S:
        route = BWD_ROUTES[q.dtype]
        fn = _entry("flash_bwd", "flash_bwd_dkv", route)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, S, H, Hkv, D, *_strides(q, k, v), scale,
                 scale * LOG2E, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, fn.__name__)
        _count(flash_attention_bwd_dkv, route)
    return dk, dv


for _w, _routes in ((flash_attention_fwd, FWD_ROUTES),
                   (flash_attention_bwd_dq, BWD_ROUTES),
                   (flash_attention_bwd_dkv, BWD_ROUTES)):
    _w.launches = 0
    _w.route_launches = dict.fromkeys(_routes.values(), 0)
del _w, _routes


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        scale: float = None):
    """``(dq, dk, dv)`` as ``flash_attention_bwd_ref`` returns them: on CUDA
    tensors ``delta`` in plain PyTorch, then the dq and dk/dv kernels; on
    the CPU the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale)
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# The forward is a dispatcher op, ``paddle_tpu_torch::flash_fwd`` returning
# O and the LSE, so that a selective-recompute policy can see it and keep
# both (``distributed/fleet/recompute.py`` ``save_flash``); its autograd
# formula runs the dq and dk/dv kernels from them. On CPU tensors the plain
# versions run in the same places, so the CPU exercises this wiring and
# the backward's arithmetic.
@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal, scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    B, S, H, D = _check_heads(q, k, v)
    return (q.new_empty((B, S, H, D)),
            q.new_empty((B * H, S), dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                     ctx.scale)
    return dq, dk, dv, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q, k, v, causal: bool = False, scale: float = None):
    """``[B, S, H, D]`` attention output through the kernels. Goes through
    the ``paddle_tpu_torch::flash_fwd`` op only when autograd will need a
    backward; otherwise (serving, ``no_grad``) it calls the forward wrapper
    directly."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        return flash_fwd_op(q, k, v, causal, float(scale))[0]
    return flash_attention_fwd(q, k, v, causal, scale)[0]
