"""Fused AdamW update, CUDA C++ for Hopper (``csrc/fused_adamw.cu``).

Replaces ``paddle_tpu/kernels/fused_optim.py`` ``_adamw_kernel`` (launched
by ``fused_adamw_update``): moments, bias correction, decoupled decay and
the new parameter in one pass over memory, with p, g, m and v read at their
native dtypes and cast in registers. One launch updates a list of tensors
of one dtype combination (``fused_adamw_multi``), each with its own
learning rate, decay and step powers, and can write the bf16 copy of an
fp32 master weight in the same pass. The kernel source says what bounds it
and how it is laid out; this module holds the plain PyTorch version, the
``ctypes`` binding and the two wrappers.

Two differences from the TPU side, both deliberate:

* The update happens in place: p, m and v are written where they lie (the
  JAX function returns new arrays). The wrappers return nothing new.
* The JAX optimizer sends only tensors of 65536 elements or more to the
  kernel (``paddle_tpu/optimizer/optimizer.py`` ``_use_fused_kernel``),
  because the TPU kernel pads each tensor to ``(rows, 128)`` lanes. The
  Hopper kernel walks chunks of every tensor of a list with no such cost,
  so ``AdamW`` in this package sends every float32/bfloat16 tensor (not
  ``amsgrad``) through it (``Adam._groups``). The
  JAX non-fused arithmetic (decay, then ``Adam._update``) agrees with the
  kernel's to rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fused_adamw": [_P, _P] + [_I] * 4 + [_F] * 5 + [_P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (param, grad, moments) dtype combinations the optimizer produces: the
# grad is in the param's dtype, or bf16 beside an fp32 master weight
COMBOS = {(p, g, m) for p in _DTYPE_CODE for m in _DTYPE_CODE
          for g in {p, torch.bfloat16}}
#: one tensor of a launch, as ``csrc/fused_adamw.cu`` ``Entry`` lays it out
_ENTRY = np.dtype([("p", np.uint64), ("g", np.uint64), ("m", np.uint64),
                   ("v", np.uint64), ("low", np.uint64), ("n", np.int64),
                   ("lr", np.float32), ("decay", np.float32),
                   ("omb1p", np.float32), ("omb2p", np.float32)])
#: the most entries one launch takes (the kernel parameter's capacity)
MAX_ENTRIES = 448
#: elements a block takes at a time: ``csrc/fused_adamw.cu`` CHUNK, threads
#: (NT) x 8-element vectors (VEC) x vectors a thread holds (UNROLL)
CHUNK = 256 * 8 * 2


def _hyper(lr, beta1, beta2, eps, weight_decay, beta1_pow, beta2_pow):
    """The kernel's fp32 constants, computed as the TPU kernel computes them
    from its fp32 scalars: 1-b1, 1-b2, 1-lr*wd, 1-b1p, 1-b2p. Each of
    ``lr``, ``weight_decay`` and the powers may be an array (one value per
    tensor); fp32 arithmetic on arrays rounds every operation as on
    scalars."""
    f = np.float32
    one = f(1.0)
    lr32 = np.asarray(lr, f)
    return dict(lr=lr32, b1=f(beta1), omb1=one - f(beta1), b2=f(beta2),
                omb2=one - f(beta2), eps=f(eps),
                decay=one - lr32 * np.asarray(weight_decay, f),
                omb1p=one - np.asarray(beta1_pow, f),
                omb2p=one - np.asarray(beta2_pow, f))


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


def _check(param, grad, m, v, low, what):
    """Raise unless the kernel (or, on the CPU, its plain version) takes
    the tensor: grad, m, v and ``low`` of param's shape and device, a dtype
    combination of ``COMBOS``, ``low`` a bf16 copy beside an fp32 param,
    the CPU or a CUDA device, every CUDA tensor contiguous. Called per
    tensor on every step, so it reads each attribute once."""
    shape, dev = param.shape, param.device
    if not (grad.shape == m.shape == v.shape == shape
            and grad.device == m.device == v.device == dev):
        raise ValueError(f"{what}: grad, m and v must be {tuple(shape)} on "
                         f"{dev}, got {[tuple(t.shape) for t in (grad, m, v)]}"
                         f" on {[str(t.device) for t in (grad, m, v)]}")
    if (param.dtype, grad.dtype, m.dtype) not in COMBOS or m.dtype != v.dtype:
        raise ValueError(f"{what}: unsupported dtypes param {param.dtype}, "
                         f"grad {grad.dtype}, m {m.dtype}, v {v.dtype}")
    if low is not None and (param.dtype != torch.float32
                            or low.dtype != torch.bfloat16
                            or low.shape != shape or low.device != dev):
        raise ValueError(f"{what}: the bf16 copy must be a bfloat16 "
                         f"{tuple(shape)} beside a float32 param, got "
                         f"{low.dtype} {tuple(low.shape)} beside "
                         f"{param.dtype}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if not (param.is_contiguous() and grad.is_contiguous()
            and m.is_contiguous() and v.is_contiguous()
            and (low is None or low.is_contiguous())):
        raise ValueError(f"{what}: tensors must be contiguous")


def _per_tensor(x, n):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


def table(entries, hp):
    """The kernel's table for ``entries`` (tuples ``(param, grad, m, v,
    low)``, ``low`` a tensor or None): one ``_ENTRY`` record per tensor
    (its pointers, n and constants from ``hp``, which holds per-entry
    arrays), and each entry's first chunk of ``CHUNK`` elements, then the
    chunks of all (``len(entries) + 1`` int32s). The kernel's chunk ``c``
    of entry ``e`` (``chunk0[e] <= c < chunk0[e + 1]``) is its elements
    from ``(c - chunk0[e]) * CHUNK`` to ``CHUNK`` later or n."""
    tab = np.empty(len(entries), _ENTRY)
    for col, k in (("p", 0), ("g", 1), ("m", 2), ("v", 3)):
        tab[col] = [e[k].data_ptr() for e in entries]
    tab["low"] = [0 if e[4] is None else e[4].data_ptr() for e in entries]
    tab["n"] = [e[0].numel() for e in entries]
    for col in ("lr", "decay", "omb1p", "omb2p"):
        tab[col] = hp[col]
    chunk0 = np.zeros(len(entries) + 1, np.int32)
    chunk0[1:] = np.cumsum(-(-tab["n"] // CHUNK))
    return tab, chunk0


def _launch(entries, hp):
    """One kernel launch over ``entries`` (at most ``MAX_ENTRIES`` tuples
    ``(param, grad, m, v, low)`` of one dtype combination, CUDA, n > 0);
    ``hp`` holds the per-launch constants and per-entry arrays."""
    tab, chunk0 = table(entries, hp)
    p, g, m = entries[0][:3]
    lib = _build.load("fused_adamw", _SIGNATURES)
    err = lib.fused_adamw(
        tab.ctypes.data, chunk0.ctypes.data, len(entries),
        _DTYPE_CODE[p.dtype],
        _DTYPE_CODE[g.dtype], _DTYPE_CODE[m.dtype], float(hp["b1"]),
        float(hp["omb1"]), float(hp["b2"]), float(hp["omb2"]),
        float(hp["eps"]),
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "fused_adamw")


def fused_adamw_multi(params, grads, exp_avgs, exp_avg_sqs, *, lr, beta1,
                      beta2, eps, weight_decay, beta1_pow, beta2_pow,
                      low=None):
    """One AdamW step for every tensor of the lists, in place: ``params``,
    ``exp_avgs`` (m) and ``exp_avg_sqs`` (v) are overwritten. ``lr``,
    ``weight_decay`` and the new powers ``beta*_pow`` are one float for all
    tensors or a list of one per tensor. ``low`` is None or a list holding,
    per tensor, None or the bf16 parameter of an fp32 master ``params[i]``,
    which gets the new value rounded to nearest. CPU tensors run
    ``adamw_ref`` tensor by tensor; CUDA tensors launch the kernel once per
    (param, grad, moments) dtype combination (and per ``MAX_ENTRIES``
    tensors), counted in ``launches``, or raise."""
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == n):
        raise ValueError("fused_adamw_multi: the four lists must be as long "
                         "as each other")
    low = [None] * n if low is None else list(low)
    lrs, wds, b1ps, b2ps = (_per_tensor(x, n) for x in (
        lr, weight_decay, beta1_pow, beta2_pow))
    if not len(low) == len(lrs) == len(wds) == len(b1ps) == len(b2ps) == n:
        raise ValueError("fused_adamw_multi: one low copy, lr, decay and "
                         "pair of powers per tensor")
    groups = {}
    for i, (p, g, m, v, lo) in enumerate(zip(params, grads, exp_avgs,
                                             exp_avg_sqs, low)):
        _check(p, g, m, v, lo, "fused_adamw_multi")
        if p.numel():
            groups.setdefault((p.dtype, g.dtype, m.dtype, p.is_cuda),
                              []).append(i)
    for (*_, on_card), idx in groups.items():
        if not on_card:
            with torch.no_grad():
                for i in idx:
                    p, m, v = params[i], exp_avgs[i], exp_avg_sqs[i]
                    new = adamw_ref(p, grads[i], m, v, lr=lrs[i],
                                    beta1=beta1, beta2=beta2, eps=eps,
                                    weight_decay=wds[i], beta1_pow=b1ps[i],
                                    beta2_pow=b2ps[i])
                    for dst, src in zip((p, m, v, low[i]), new + new[:1]):
                        if dst is not None:
                            dst.copy_(src)
            continue
        for s in range(0, len(idx), MAX_ENTRIES):
            part = idx[s:s + MAX_ENTRIES]
            _launch([(params[i], grads[i], exp_avgs[i], exp_avg_sqs[i],
                      low[i]) for i in part],
                    _hyper([lrs[i] for i in part], beta1, beta2, eps,
                           [wds[i] for i in part], [b1ps[i] for i in part],
                           [b2ps[i] for i in part]))
            fused_adamw_multi.launches += 1


fused_adamw_multi.launches = 0


def fused_adamw_update(param, grad, m, v, *, lr, beta1, beta2, eps,
                       weight_decay, beta1_pow, beta2_pow):
    """One AdamW step for one tensor, in place: ``param``, ``m`` and ``v``
    are overwritten and returned. ``beta*_pow`` are the new powers.
    CPU tensors run ``adamw_ref``; CUDA tensors launch the kernel over a
    one-entry list (counted in ``launches``) or raise."""
    _check(param, grad, m, v, None, "fused_adamw_update")
    hp = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, beta1_pow=beta1_pow,
              beta2_pow=beta2_pow)
    if not param.is_cuda:
        with torch.no_grad():
            for dst, src in zip((param, m, v), adamw_ref(param, grad, m, v,
                                                         **hp)):
                dst.copy_(src)
        return param, m, v
    if param.numel():
        _launch([(param, grad, m, v, None)],
                _hyper([lr], beta1, beta2, eps, [weight_decay], [beta1_pow],
                       [beta2_pow]))
        fused_adamw_update.launches += 1
    return param, m, v


fused_adamw_update.launches = 0
