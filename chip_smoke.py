#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is turned
   off for float32 products and convolutions so fp32 checks are fp32;
2. build: every CUDA source under ``paddle_tpu_torch/kernels/csrc`` is
   compiled with ``nvcc`` for sm_90a (one process per source, in parallel;
   ptxas's registers and spills printed per kernel), the HGMMA instructions
   of the bf16 flash forward's and backward's kernels are counted in their
   SASS (``cuobjdump -sass``; none fails), the norms are launched once, and
   the primitives that ``kernels.primitive`` generates for this script's
   functions are JIT-compiled (Triton);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training slices' shapes (the primitives at the 1.3B's
   hidden-state shapes and at ragged ones), in bf16 and fp32, with the
   stated tolerance (LayerNorm and RMSNorm forward and backward at 1 to
   32768 rows of H 7 to 2050, on both routes, with two backward calls
   bitwise equal; the flash forward and backward also at the
   edges of their 64-row tiles, with GQA 16/1, and on the fused qkv
   projection's column slices, each call on its dtype's route; the forward
   also on a view TMA cannot read, which is copied first; two bf16 calls
   at the training shape bitwise equal); then timed with CUDA events and
   the profiler beside the plain version, a library yardstick the port
   never calls, and the H100 bound (a flash kernel the profiler does not
   see fails the run; others print "not seen");
4. serving slice at full width: GPT-3 1.3B (24 layers, bf16, random
   weights from the seed) behind ``Engine.generate``, 16 greedy requests
   through 8 slots, with each kernel's launch count over that run (every
   flash forward on the bf16 route, wgmma);
5. serving vs plain: at full width and depth 2 in fp32, the same weights
   serve 3 greedy prompts on the card (every flash forward on the fp32
   route, the CUDA cores) and on the CPU (plain versions);
   tokens must match and the last decode logits agree; on the card, flash
   prefill over the generated text agrees with the paged decode step;
6. training slice at full width: GPT-3 1.3B (bf16, full recompute, chunked
   loss) through ``make_sharded_train_step(model, AdamW(...))`` with fp32
   master weights and bf16 moments, batch 16 x 2048; one warm-up step,
   five timed steps and one profiled step, with each kernel's launch
   count over the timed steps (the flash kernels' on the tensor-core
   route; 4L + 1 LayerNorm forwards and 2L + 1 backwards a step) and the
   bf16 flash kernels' and the LayerNorm kernels' device time in the
   profiled step; the loss must be finite and fall;
7. training vs plain: at full width and depth 2 in fp32, the same weights
   take 3 AdamW steps on the card (every flash launch on the CUDA-core
   route) and on the CPU; losses, the first step's gradients and the
   parameters' updates after step 3 agree;
8. training surface at full width: GPT-3 1.3B (bf16) at batch 16 x 2048
   with a LinearWarmup over a CosineAnnealingDecay, a GradScaler and each
   recompute policy (None, save_flash, dots_saveable): one warm-up step,
   then ``run_steps`` over 3 stacked batches, the scheduler stepped between
   calls; step time, tokens/s, MFU, peak memory and flash forwards per
   step for each policy; the loss must be finite and fall, save_flash must
   launch half the flash forwards, every flash launch takes the wgmma
   route, and the rates used follow the schedule;
9. surface vs plain: at full width and depth 2 in fp32, with the
   scheduler, the scaler, save_flash and ``run_steps``: gradients under
   None and save_flash are bitwise equal on the card; a first step with an
   infinite scale is skipped on the card and on the CPU alike, then 3
   steps run; losses, the scaler's automaton and the updates agree;
10. user-facing path at full width: ``nn.RMSNorm`` forward and backward
   (held to the plain versions), ``nn.functional.rms_norm``, ``incubate``
   ``fused_rms_norm`` and the two primitive factories on the 1.3B's
   hidden states at batch 16 x 2048, with each kernel's launch count over
   that run.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``paddle_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# device memory
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

TOL = {  # max |kernel - plain| accepted, by (kernel, dtype)
    ("layer_norm", "float32"): 1e-4,
    # bf16 outputs of |y| < 8 differ by at most one rounding step (2^-5)
    ("layer_norm", "bfloat16"): 3.2e-2,
    ("flash", "float32"): 1e-4,
    ("flash_lse", "float32"): 1e-4,
    # P is rounded to bf16 against the running (tile) max in the kernel and
    # against the row max in the plain version: ~2^-8 relative on O
    ("flash", "bfloat16"): 2e-2,
    ("flash_lse", "bfloat16"): 1e-3,
    ("paged", "float32"): 1e-4,
    ("paged", "bfloat16"): 2e-2,
    ("flash_bwd", "float32"): 1e-4,
    # dq/dk/dv of |d| < 8 round to bf16: one rounding step is 2^-5; ds and
    # P are rounded to bf16 in both versions, so a rounding that flips on
    # an fp32 ulp moves a sum by about that much as well
    ("flash_bwd", "bfloat16"): 3.2e-2,
    ("rms_norm", "float32"): 1e-4,
    # as LayerNorm: bf16 outputs of |y| < 8 within one rounding step
    ("rms_norm", "bfloat16"): 3.2e-2,
}
# the norms' gradients, relative to their largest entry: in bf16 one
# rounding step of that entry (the kernel's fp32 sums run in another order
# than the plain version's, so a value's rounding may flip); in fp32 1e-5
# (dw and db sum up to 32768 rows, dx a row of up to 2050 values)
NORM_GRAD_STEP = {"float32": 1e-5, "bfloat16": 2 ** -7}
# the norm kernels, by symbol (csrc/norms.cu): the warp route's forward and
# backward, and the backward's sum of its per-block partials of dw and db
NORM_SYMBOLS = {"fwd": "norm_fwd_warp_kernel", "bwd": "norm_bwd_warp_kernel",
                "reduce": "norm_bwd_reduce_kernel"}
# the primitives' tolerance, relative to the largest output: one rounding
# step of the output dtype (the kernels' tanh, contractions and summation
# order differ from PyTorch's by ulps of fp32)
PRIMITIVE_STEP = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# the kernels and the path that launches them
SERVING_KERNELS = ("fused_layer_norm", "flash_attention_fwd",
                   "paged_attention")
TRAINING_KERNELS = ("fused_layer_norm", "layer_norm_bwd",
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "fused_adamw_update")
USER_API_KERNELS = ("fused_rms_norm", "rms_norm_bwd", "elementwise_kernel",
                    "row_reduce_kernel")
# the bf16 flash kernels, by symbol: the forward (csrc/flash_fwd_sm90.cu)
# and the backward's two (csrc/flash_bwd_sm90.cu); the fp32 route's
# CUDA-core kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
FWD_SYMBOL = "flash_fwd_sm90_kernel"
BWD_SYMBOLS = {"dq": "flash_bwd_dq_sm90_kernel",
               "dkv": "flash_bwd_dkv_sm90_kernel"}
SM90_LIBS = {"flash_fwd_sm90": (FWD_SYMBOL,),
             "flash_bwd_sm90": tuple(BWD_SYMBOLS.values())}
FP32_FWD_SYMBOL = "flash_fwd_kernel"
FLASH_WRAPPERS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
ALL_KERNELS = ("fused_layer_norm", "layer_norm_bwd", "flash_attention_fwd",
               "paged_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "fused_adamw_update") \
    + USER_API_KERNELS
# the functions this script lifts into primitives
ELEMENTWISE_FNS = {
    "x + a*y": lambda x, y, a: x + a * y,
    "x + a*tanh(y)": lambda x, y, a: x + a * torch.tanh(y),
}
REDUCE_FNS = {
    "row sum": (lambda acc, b: acc + b.sum(-1), 0.0),
    "row max": (lambda acc, b: torch.maximum(acc, b.amax(-1)),
                float("-inf")),
}
ADAMW_HP = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                beta1_pow=0.9 ** 3, beta2_pow=0.999 ** 3)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def timed_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int):
    """Device time of one launch of ``kernel`` (a substring of its name),
    read by ``torch.profiler`` over ``iters`` calls of ``fn``: unlike
    ``timed_ms`` it excludes the host's launch cost. None when the profile
    holds no kernel of that name (a renamed kernel, or one the profiler
    missed), never 0."""
    fn()
    return kernel_ms(profile_kernels(lambda: [fn() for _ in range(iters)]),
                     kernel, iters)


def kernel_ms(kernels, kernel: str, per: int = 1):
    """Device ms of the kernels named ``*kernel*`` in ``kernels`` (as
    ``profile_kernels`` returns them) over ``per``; None if none is there."""
    seen = [t for name, t in kernels if kernel in name]
    return sum(seen) / per * 1e3 if seen else None


def fmt(ms, spec: str) -> str:
    return "not seen" if ms is None else format(ms, spec)


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def sass_counts(lib, opcode: str):
    """{kernel symbol: number of SASS instructions with ``opcode``} of a
    built library, read with ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib} failed: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def check_flash_routes(K, route: str, what: str):
    """Every launch of the three flash wrappers since the counts were last
    reset took ``route`` (``wgmma`` on a bf16 path, ``cuda_cores`` on an
    fp32 one); returns their ``route_launches``."""
    counts = K.launch_counts()
    routes = {w: dict(getattr(K, w).route_launches) for w in FLASH_WRAPPERS}
    check(all(r[route] == sum(r.values()) == counts[w]
              for w, r in routes.items()),
          f"{what}: a flash launch left the {route} route: {routes}")
    return routes


def flash_inputs(randn, B, S, Hq, Hkv, D, dtype, view=None):
    """q [B, S, Hq, D], k and v [B, S, Hkv, D]. ``view``: None for three
    tensors; "fused" for the column slices of one [B, S, (Hq + 2 Hkv) D]
    projection, as models/gpt.py makes them (TMA reads them in place);
    "copied" for slices of a projection 4 elements wider, whose sequence
    stride is not a 16-byte multiple (the bf16 route copies them first)."""
    import importlib

    if view is None:
        return (randn(B, S, Hq, D, dtype=dtype),
                randn(B, S, Hkv, D, dtype=dtype),
                randn(B, S, Hkv, D, dtype=dtype))
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    pad = 4 if view == "copied" else 0
    qkv = randn(B, S, (Hq + 2 * Hkv) * D + pad, dtype=dtype)
    q, k, v = (t.unflatten(-1, (-1, D)) for t in qkv.split(
        [Hq * D, Hkv * D, Hkv * D, pad], dim=-1)[:3])
    kept = [FA._for_tma(t) is t for t in (q, k, v)]
    check(all(kept) if view == "fused" else not any(kept),
          f"{view} views: kept in place for TMA: {kept}")
    return q, k, v


# ---------------------------------------------------------------- phase 3
def kernel_checks(K, gen):
    """Kernel vs plain on the card; returns the JSON rows (launch counts are
    filled in from the slice run)."""
    from paddle_tpu_torch.serving.kv_cache import PAGE_SENTINEL

    dev = torch.device("cuda")
    F = torch.nn.functional
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- flash forward: the serving shapes (prefill B=1, H=16, D=128,
    #    causal; a ragged S, GQA 16/4, D 64) on both routes (bf16 on the
    #    tensor cores, fp32 on the CUDA cores); then, in bf16, the edges of
    #    the 64-row tiles (S 1, 63, 64, 65, 200), GQA 16/1 and D 64, q/k/v
    #    as the fused qkv projection's column slices read in place by TMA,
    #    and slices TMA cannot read, which are copied first. Each call must
    #    add one launch to its dtype's route
    import importlib

    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    FWD = K.flash_attention_fwd
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, 1024, 16, 16, 128, True), (1, 200, 16, 16, 128, True),
             (2, 130, 16, 4, 128, False), (1, 256, 16, 16, 64, True)]
    edges = [(1, 1, 16, 16, 128, True), (1, 63, 16, 16, 128, True),
             (1, 64, 16, 16, 128, False), (2, 65, 16, 16, 128, True),
             (1, 200, 16, 1, 128, True), (2, 65, 16, 4, 64, True),
             (2, 63, 16, 1, 64, False)]
    fused = [(2, 200, 16, 16, 128, True), (2, 130, 16, 4, 128, False),
             (1, 65, 16, 1, 64, True)]
    runs = ([(dt, c, None) for dt in (f32, bf16) for c in cases]
            + [(bf16, c, None) for c in edges]
            + [(bf16, c, "fused") for c in fused]
            + [(bf16, (2, 77, 16, 4, 128, True), "copied")])
    for dtype, (B, S, Hq, Hkv, D, causal), view in runs:
        dn = str(dtype).split(".")[1]
        q, k, v = flash_inputs(randn, B, S, Hq, Hkv, D, dtype, view)
        route = FA.FWD_ROUTES[dtype]
        want_routes = dict(FWD.route_launches)
        want_routes[route] += 1
        o, lse = FWD(q, k, v, causal=causal)
        o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=causal)
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        to, tl = TOL[("flash", dn)], TOL[("flash_lse", dn)]
        print(f"  flash_fwd {str(dtype):15s} B{B} S{S} H{Hq}/{Hkv} D{D} "
              f"causal={causal}{f' {view} views' if view else ''} ({route}): "
              f"O err {eo:.3e} (tol {to:.1e}), LSE err {el:.3e} (tol "
              f"{tl:.1e})", flush=True)
        check(FWD.route_launches == want_routes,
              f"flash_fwd {dtype} did not take its {route} route once: "
              f"{FWD.route_launches}")
        check(eo <= to and el <= tl and o.shape == o_ref.shape
              and o.dtype == o_ref.dtype, f"flash {dtype} S{S} H{Hq}/{Hkv} "
              f"D{D}{f' {view}' if view else ''}: O {eo}, LSE {el}")
    B, S, Hq, D = 1, 1024, 16, 128
    q, k, v = (randn(B, S, Hq, D, dtype=bf16) for _ in range(3))
    ms = timed_ms(lambda: FWD(q, k, v, causal=True), 20)
    plain = timed_ms(lambda: K.flash_attention_ref(q, k, v, causal=True), 20)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    pairs = S * (S + 1) // 2
    ops = 4 * D * pairs * B * Hq
    bms, by = bound(4 * B * S * Hq * D * 2 + B * Hq * S * 4, ops, PEAK_BF16)
    err = max_err(FWD(q, k, v, causal=True)[0],
                  K.flash_attention_ref(q, k, v, causal=True)[0])
    dms = device_ms(lambda: FWD(q, k, v, causal=True), FWD_SYMBOL, 10)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_dms = device_ms(lambda: FWD(q32, k32, v32, causal=True),
                        FP32_FWD_SYMBOL, 10)
    print(f"  flash_fwd bf16 S{S} (wgmma): kernel {ms:.4f} ms (device "
          f"{fmt(dms, '.4f')} ms), plain {plain:.4f} ms, F.sdpa {lib:.4f} "
          f"ms, bound {bms:.5f} ms ({by}); fp32 route (CUDA cores) on the "
          f"same values: device {fmt(f32_dms, '.4f')} ms", flush=True)
    check(dms is not None and f32_dms is not None,
          f"the profiler did not see {FWD_SYMBOL} / {FP32_FWD_SYMBOL}: "
          f"{dms} / {f32_dms}")
    rows["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        routes={"bfloat16": "cuda wgmma", "float32": "cuda fp32 CUDA cores"},
        source="paddle_tpu_torch/kernels/csrc/flash_fwd_sm90.cu",
        float32_source="paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:44",
        shape="bf16 B1 S1024 H16 D128 causal (prefill bucket)",
        max_abs_err=err, ms=ms, device_ms=dms, tflops=ops / dms * 1e-9,
        float32_device_ms=f32_dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib)

    # -- paged decode: the slice's shapes (B 8, H 16/16, D 128, ps 16,
    #    S_max 2048) and the repo's GQA serving config (H 16/4, D 64, S_max
    #    1024); ragged positions, sentinel tails, and one empty slot
    def paged_case(B, Hq, Hkv, D, ps, S_max, dtype, lo, hi):
        nb = S_max // ps
        P = B * nb + 1
        kp = randn(P, Hkv, ps, D, dtype=dtype)
        vp = randn(P, Hkv, ps, D, dtype=dtype)
        pos = torch.randint(lo, hi, (B,), generator=gen, device=dev)
        pos[-1] = 0  # empty slot: all-sentinel row, reads trash page 0
        table = torch.full((B, nb), PAGE_SENTINEL, dtype=torch.int32)
        perm = torch.randperm(P - 1, generator=gen, device=dev).cpu() + 1
        used = 0
        for b in range(B - 1):
            n = int(pos[b]) // ps + 1
            table[b, :n] = perm[used:used + n]
            used += n
        q = randn(B, Hq, 1, D, dtype=dtype)
        return (q, kp, vp, table.to(dev), pos.to(torch.int32))

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, Hq, Hkv, D, S_max in ((8, 16, 16, 128, 2048),
                                     (8, 16, 4, 64, 1024)):
            args = paged_case(B, Hq, Hkv, D, 16, S_max, dtype, 1, S_max - 1)
            out = K.paged_attention(*args)
            ref = K.paged_attention_ref(*args)
            err = max_err(out, ref)
            tol = TOL[("paged", dn)]
            print(f"  paged_decode {str(dtype):15s} B{B} H{Hq}/{Hkv} D{D} "
                  f"S_max {S_max}: max_abs_err {err:.3e} (tol {tol:.1e}), "
                  f"finite={bool(torch.isfinite(out).all())}", flush=True)
            check(err <= tol and bool(torch.isfinite(out).all()),
                  f"paged_decode {dtype} H{Hq}/{Hkv}: {err}")
    # timing at the decode batch the slice run sees: 8 slots with prompts
    # of 128 and 300-700 tokens plus up to 32 generated
    B, Hq, D, ps = 8, 16, 128, 16
    args = paged_case(B, Hq, Hq, D, ps, 2048, torch.bfloat16, 128, 733)
    pos = args[4]
    live_pages = sum(int(p) // ps + 1 for p in pos.tolist())
    tokens = sum(int(p) + 1 for p in pos.tolist())
    ms = timed_ms(lambda: K.paged_attention(*args), 200)
    plain = timed_ms(lambda: K.paged_attention_ref(*args), 20)
    bms, by = bound(live_pages * Hq * ps * D * 2 * 2 + 2 * B * Hq * D * 2
                    + args[3].numel() * 4 + B * 4,
                    4 * D * Hq * tokens, PEAK_BF16)
    err = max_err(K.paged_attention(*args), K.paged_attention_ref(*args))
    dms = device_ms(lambda: K.paged_attention(*args), "paged_decode_kernel",
                    50)
    print(f"  paged_decode bf16 B{B} live pages {live_pages}: kernel "
          f"{ms:.4f} ms (device {fmt(dms, '.4f')} ms), plain {plain:.4f} "
          f"ms, bound {bms:.5f} ms ({by})", flush=True)
    rows["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_decode.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:43",
        shape=f"bf16 B8 H16 D128 ps16 nb128, {live_pages} live pages",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=None)
    return rows


def norm_checks(K, gen, rows):
    """LayerNorm and RMSNorm, forward and backward, vs plain on the card:
    every route and ragged edge, then timed at decode rows [8, 2048] and
    training rows [32768, 2048]; adds the four kernels' rows to ``rows``."""
    dev = torch.device("cuda")
    F = torch.nn.functional
    f32, bf16 = torch.float32, torch.bfloat16
    H = 2048
    norms = {  # forward, backward, plain forward, plain backward, eps
        "layer_norm": (K.fused_layer_norm, K.layer_norm_bwd,
                       K.layer_norm_ref, K.layer_norm_bwd_ref, 1e-5),
        "rms_norm": (K.fused_rms_norm, K.rms_norm_bwd, K.rms_norm_ref,
                     K.rms_norm_bwd_ref, 1e-6)}

    def case(norm, shape, dtype):
        Hc = shape[-1]
        x = (torch.randn(*shape, generator=gen, device=dev) * 2 + 0.5) \
            .to(dtype)
        w = (1 + 0.1 * torch.randn(Hc, generator=gen, device=dev)).to(dtype)
        b = (0.1 * torch.randn(Hc, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        return x, ((w, b) if norm == "layer_norm" else (w,)), dy

    # -- every route and edge: R 1, 3, 8 (decode), 231, 32768 (training)
    #    rows by H 7, 100, 768, 2048, 2050 in both dtypes, and the serving
    #    slice's leading shapes; one forward and one backward launch per
    #    call on the expected route (warp: H a multiple of the 16-byte
    #    vector and at most 2048; else block)
    shapes = [(R, Hc) for R in (1, 3, 8, 231, 32768)
              for Hc in (7, 100, 768, 2048, 2050)] + [
        (8, 1, H), (1, 1024, H), (3, 77, H)]
    for norm, (fwd, bwd, fwd_ref, bwd_ref, eps) in norms.items():
        for dtype in (f32, bf16):
            dn = str(dtype).split(".")[1]
            tol = TOL[(norm, dn)]
            for shape in shapes:
                x, params, dy = case(norm, shape, dtype)
                Hc = shape[-1]
                route = ("warp" if Hc % (16 // x.element_size()) == 0
                         and Hc <= 2048 else "block")
                before = [(w.launches, w.route_launches[route])
                          for w in (fwd, bwd)]
                y = fwd(x, *params, eps)
                grads = bwd(x, params[0], dy, eps)
                check([(w.launches, w.route_launches[route])
                       for w in (fwd, bwd)] == [(n + 1, r + 1)
                                                for n, r in before],
                      f"{norm} {dtype} {shape}: not one launch of each on "
                      f"the {route} route")
                err_y = max_err(y, fwd_ref(x, *params, eps))
                errs = [(max_err(g, r), norm_grad_tol(r)) for g, r in
                        zip(grads, bwd_ref(x, params[0], dy, eps))]
                print(f"  {norm} {dn:8s} x{list(shape)} ({route}): y err "
                      f"{err_y:.2e} (tol {tol:.1e}); dx/dw"
                      f"{'/db' if len(errs) == 3 else ''} err "
                      f"{' '.join(f'{e:.2e}' for e, _ in errs)} (tol "
                      f"{' '.join(f'{t:.2e}' for _, t in errs)})",
                      flush=True)
                check(err_y <= tol and y.shape == x.shape
                      and all(e <= t for e, t in errs),
                      f"{norm} {dtype} {shape} ({route}): y {err_y} (tol "
                      f"{tol}), grads (err, tol) {errs}")

    # -- two backward calls at the training rows equal to the bit (a fixed
    #    grid and no atomics); then the times
    for norm, (fwd, bwd, fwd_ref, bwd_ref, eps) in norms.items():
        x, params, dy = case(norm, (32768, H), bf16)
        same = all(torch.equal(a, b) for a, b in zip(
            bwd(x, params[0], dy, eps), bwd(x, params[0], dy, eps)))
        print(f"  {norm} backward bf16 [32768, {H}]: two calls bitwise "
              f"equal {same}", flush=True)
        check(same, f"the {norm} backward is not deterministic")

    names = {"layer_norm": ("fused_layer_norm", "layer_norm_bwd", ":20",
                            ":78", "F.layer_norm"),
             "rms_norm": ("fused_rms_norm", "rms_norm_bwd", ":29", ":128",
                          "F.rms_norm")}
    for norm, (fwd, bwd, fwd_ref, bwd_ref, eps) in norms.items():
        fname, bname, fline, bline, libname = names[norm]
        ln = norm == "layer_norm"

        def lib_fwd(x, *params):
            return (F.layer_norm(x, (H,), *params, eps) if ln
                    else F.rms_norm(x, (H,), *params, eps))

        t = {}
        for R in (8, 32768):
            x, params, dy = case(norm, (R, H), bf16)
            n_par = len(params)
            ms = timed_ms(lambda: fwd(x, *params, eps), 200)
            plain = timed_ms(lambda: fwd_ref(x, *params, eps), 200)
            lib = timed_ms(lambda: lib_fwd(x, *params), 200)
            dms = device_ms(lambda: fwd(x, *params, eps), NORM_SYMBOLS["fwd"],
                            50)
            err = max_err(fwd(x, *params, eps), fwd_ref(x, *params, eps))
            bms, by = bound(2 * R * H * 2 + n_par * H * 2,
                            (8 if ln else 4) * R * H, PEAK_FP32)
            t[R] = dict(ms=ms, device_ms=dms, plain_ms=plain, library_ms=lib,
                        bound_ms=bms, bound_by=by, max_abs_err=err)
            print(f"  {fname} bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
                  f"{fmt(dms, '.4f')} ms), plain {plain:.4f} ms, {libname} "
                  f"{lib:.4f} ms, bound {bms:.5f} ms ({by})", flush=True)
            check(dms is not None, f"the profiler did not see "
                  f"{NORM_SYMBOLS['fwd']} for {fname}")
        # the backward at the training rows: the kernel pair (rows, then
        # the partial sums of dw/db), the plain version, and the library's
        # backward through autograd (forward + backward - forward)
        R = 32768
        x, params, dy = case(norm, (R, H), bf16)
        ms = timed_ms(lambda: bwd(x, params[0], dy, eps), 50)
        kern = profile_kernels(
            lambda: [bwd(x, params[0], dy, eps) for _ in range(20)])
        dms_rows = kernel_ms(kern, NORM_SYMBOLS["bwd"], 20)
        dms_red = kernel_ms(kern, NORM_SYMBOLS["reduce"], 20)
        check(None not in (dms_rows, dms_red), f"the profiler did not see "
              f"{NORM_SYMBOLS['bwd']} / {NORM_SYMBOLS['reduce']}: {kern[:4]}")
        dms = dms_rows + dms_red
        plain = timed_ms(lambda: bwd_ref(x, params[0], dy, eps), 20)
        xs = [v.clone().requires_grad_() for v in (x, *params)]
        lib_f = timed_ms(lambda: lib_fwd(*xs), 50)
        lib_fb = timed_ms(lambda: torch.autograd.grad(lib_fwd(*xs), xs, dy),
                          50)
        got = bwd(x, params[0], dy, eps)
        err = max(max_err(g, r) for g, r in zip(
            got, bwd_ref(x, params[0], dy, eps)))
        # read x and g, write dx (bf16), read w, write dw (and db)
        bms, by = bound(3 * R * H * 2 + (1 + len(params)) * H * 2,
                        (15 if ln else 11) * R * H, PEAK_FP32)
        print(f"  {bname} bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
              f"{dms:.4f} ms = rows {dms_rows:.4f} + partial sums "
              f"{dms_red:.4f}), plain {plain:.4f} ms, {libname} backward "
              f"{lib_fb - lib_f:.4f} ms (fwd+bwd {lib_fb:.4f} - fwd "
              f"{lib_f:.4f}), bound {bms:.4f} ms ({by})", flush=True)
        del xs, x, params, dy, got
        common = dict(route="cuda",
                      source="paddle_tpu_torch/kernels/csrc/norms.cu")
        dec, tr = t[8], t[32768]
        rows[fname] = dict(
            name=fname, replaces=f"paddle_tpu/kernels/norms.py{fline}",
            shape=f"bf16 x[8, {H}] (decode rows)", **common, **dec,
            train_shape=f"bf16 x[32768, {H}] (training rows, B16 x S2048)",
            **{f"train_{k}": v for k, v in tr.items()})
        rows[bname] = dict(
            name=bname, replaces=f"paddle_tpu/kernels/norms.py{bline}",
            replaces_note="the backward rule, jnp that XLA fuses on the TPU",
            shape=f"bf16 x[32768, {H}], g (training rows)", **common,
            max_abs_err=err, ms=ms, device_ms=dms, rows_device_ms=dms_rows,
            partial_sums_device_ms=dms_red, plain_ms=plain,
            bound_ms=bms, bound_by=by, library_ms=lib_fb - lib_f)
    torch.cuda.empty_cache()


def norm_grad_tol(ref):
    """A norm gradient's tolerance: ``NORM_GRAD_STEP`` of its largest
    entry."""
    step = NORM_GRAD_STEP[str(ref.dtype).split(".")[1]]
    return step * ref.float().abs().max().item()


def train_kernel_checks(K, gen, rows):
    """The training kernels (flash backward, fused AdamW) vs plain on the
    card, then timed at the training slice's shapes; adds their rows to
    ``rows`` and the flash forward's training-shape numbers to its row."""
    import importlib

    # the module, not the package attribute of the same name (a function)
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    _delta = FA._delta

    BWD_WRAPPERS = (K.flash_attention_bwd_dq, K.flash_attention_bwd_dkv)
    dev = torch.device("cuda")
    F = torch.nn.functional

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- flash backward: dq, dk, dv vs flash_attention_bwd_ref, from the
    #    forward kernel's O and LSE; ragged S, GQA 16/4 (dk/dv summed over
    #    each KV head's query heads) and D 64 in both dtypes (bf16 on the
    #    tensor cores, fp32 on the CUDA cores); then, in bf16, the edges of
    #    the 64-row tiles (S 1, 63, 65, 200), GQA 16/1, D 64, and q/k/v as
    #    the column slices of a fused qkv projection, read in place by TMA
    cases = [(1, 1024, 16, 16, 128, True), (1, 200, 16, 16, 128, True),
             (2, 130, 16, 4, 128, False), (1, 256, 16, 16, 64, True)]
    edges = [(1, 1, 16, 16, 128, True), (1, 63, 16, 16, 128, True),
             (2, 65, 16, 4, 128, False), (1, 200, 16, 1, 128, True),
             (2, 65, 16, 16, 64, True), (2, 63, 16, 1, 64, False)]
    fused = [(2, 200, 16, 16, 128, True), (2, 130, 16, 4, 128, False),
             (1, 65, 16, 1, 64, True)]
    bf16 = torch.bfloat16
    runs = ([(dt, c, False) for dt in (torch.float32, bf16) for c in cases]
            + [(bf16, c, False) for c in edges]
            + [(bf16, c, True) for c in fused])
    for dtype, (B, S, Hq, Hkv, D, causal), sliced in runs:
        dn = str(dtype).split(".")[1]
        tol = TOL[("flash_bwd", dn)]
        q, k, v = flash_inputs(randn, B, S, Hq, Hkv, D, dtype,
                               "fused" if sliced else None)
        do = randn(B, S, Hq, D, dtype=dtype)
        o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
        route = FA.BWD_ROUTES[dtype]
        before = [w.route_launches[route] for w in BWD_WRAPPERS]
        got = K.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        errs = [max_err(a, b) for a, b in zip(got, want)]
        mags = [b.float().abs().max().item() for b in want]
        print(f"  flash_bwd {str(dtype):15s} B{B} S{S} H{Hq}/{Hkv} D{D} "
              f"causal={causal}{' fused-qkv views' if sliced else ''} "
              f"({route}): dq/dk/dv err "
              f"{' '.join(f'{e:.3e}' for e in errs)} (tol {tol:.1e}; "
              f"max |d| {' '.join(f'{m:.2f}' for m in mags)})", flush=True)
        check([w.route_launches[route] for w in BWD_WRAPPERS]
              == [n + 1 for n in before],
              f"flash_bwd {dtype} did not take its {route} route once")
        check(all(e <= tol for e in errs) and all(
            g.shape == w.shape and g.dtype == w.dtype
            for g, w in zip(got, want)),
            f"flash_bwd {dtype} S{S} H{Hq}/{Hkv} D{D}: {errs}")

    # the training slice's shape, bf16 B16 S2048 H16 D128 causal: forward
    # (O and LSE), dq and dk/dv against their plain versions, which hold
    # [B, H, S, S] fp32 scores, so they run one batch row at a time. The
    # backward's plain version starts from the forward kernel's O and LSE,
    # which are held to theirs first
    B, S, Hq, D = 16, 2048, 16, 128
    q, k, v, do = (randn(B, S, Hq, D, dtype=bf16) for _ in range(4))
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    o2, lse2 = K.flash_attention_fwd(q, k, v, causal=True)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    print(f"  flash_fwd bf16 B{B} S{S} H{Hq} D{D} causal: two calls bitwise "
          f"equal {same}", flush=True)
    check(same, "the bf16 flash forward is not deterministic")
    del o2, lse2
    delta = _delta(o, do)

    def bwd():
        return (K.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
                *K.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))

    dq, dk, dv = bwd()
    same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), bwd()))
    print(f"  flash_bwd bf16 B{B} S{S} H{Hq} D{D} causal: two calls bitwise "
          f"equal {same}", flush=True)
    check(same, "the bf16 flash backward is not deterministic")
    err = dict(o=0.0, lse=0.0, dq=0.0, dkv=0.0)
    for b in range(B):
        r, rh = slice(b, b + 1), slice(b * Hq, (b + 1) * Hq)
        o_ref, lse_ref = K.flash_attention_ref(q[r], k[r], v[r], causal=True)
        ref = K.flash_attention_bwd_ref(q[r], k[r], v[r], o[r], lse[rh],
                                        do[r], causal=True)
        err["o"] = max(err["o"], max_err(o[r], o_ref))
        err["lse"] = max(err["lse"], max_err(lse[rh], lse_ref))
        err["dq"] = max(err["dq"], max_err(dq[r], ref[0]))
        err["dkv"] = max(err["dkv"], max_err(dk[r], ref[1]),
                         max_err(dv[r], ref[2]))
    del o_ref, lse_ref, ref
    tol_o, tol_l = TOL[("flash", "bfloat16")], TOL[("flash_lse", "bfloat16")]
    tol_b = TOL[("flash_bwd", "bfloat16")]
    print(f"  flash bf16 B{B} S{S} H{Hq} D{D} causal (training shape), plain "
          f"one batch row at a time: O err {err['o']:.3e} (tol {tol_o:.1e}), "
          f"LSE err {err['lse']:.3e} (tol {tol_l:.1e}), dq err "
          f"{err['dq']:.3e}, dk/dv err {err['dkv']:.3e} (tol {tol_b:.1e})",
          flush=True)
    check(err["o"] <= tol_o and err["lse"] <= tol_l and err["dq"] <= tol_b
          and err["dkv"] <= tol_b, f"flash at the training shape: {err}")
    err_dq, err_dkv = err["dq"], err["dkv"]
    fwd_ms = timed_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True), 20)
    fwd_dms = device_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True),
                        FWD_SYMBOL, 10)
    fwd_plain = timed_ms(lambda: K.flash_attention_ref(q, k, v, causal=True),
                         3)
    torch.cuda.empty_cache()
    ms_dq = timed_ms(lambda: K.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                      True), 20)
    ms_dkv = timed_ms(lambda: K.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                        delta, True), 20)
    dms_dq = device_ms(lambda: K.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, True), BWD_SYMBOLS["dq"], 10)
    dms_dkv = device_ms(lambda: K.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, True), BWD_SYMBOLS["dkv"], 10)
    check(None not in (fwd_dms, dms_dq, dms_dkv),
          f"the profiler did not see {FWD_SYMBOL} / {BWD_SYMBOLS['dq']} / "
          f"{BWD_SYMBOLS['dkv']}: {fwd_dms} / {dms_dq} / {dms_dkv}")
    plain = timed_ms(lambda: K.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                       causal=True), 3)
    # the fp32 route (CUDA cores) on the same values, for the route table
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    f32_fwd = device_ms(lambda: K.flash_attention_fwd(
        q32, k32, v32, causal=True), FP32_FWD_SYMBOL, 2)
    f32_dq = device_ms(lambda: K.flash_attention_bwd_dq(
        q32, k32, v32, do32, lse, delta, True), "flash_bwd_dq_kernel", 2)
    f32_dkv = device_ms(lambda: K.flash_attention_bwd_dkv(
        q32, k32, v32, do32, lse, delta, True), "flash_bwd_dkv_kernel", 2)
    del q32, k32, v32, do32
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_f = timed_ms(sdpa_fwd, 10)
    lib_fb = timed_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt),
                                                  dot), 10)
    lib = lib_fb - lib_f
    pairs = S * (S + 1) // 2
    io = B * S * Hq * D * 2  # one bf16 [B, S, H, D] tensor
    stats = 2 * B * Hq * S * 4  # lse and delta
    ops_dq, ops_dkv = 6 * D * pairs * B * Hq, 8 * D * pairs * B * Hq
    b_dq, by_dq = bound(5 * io + stats, ops_dq, PEAK_BF16)
    b_dkv, by_dkv = bound(6 * io + stats, ops_dkv, PEAK_BF16)
    ops_fwd = 4 * D * pairs * B * Hq
    b_fwd, by_fwd = bound(4 * io + stats // 2, ops_fwd, PEAK_BF16)
    tf_fwd = ops_fwd / fwd_dms * 1e-9
    tf_dq, tf_dkv = ops_dq / dms_dq * 1e-9, ops_dkv / dms_dkv * 1e-9
    print(f"  flash bf16 B{B} S{S} H{Hq} D{D} causal (training shape): fwd "
          f"kernel (wgmma) {fwd_ms:.3f} ms (device {fwd_dms:.3f} ms = "
          f"{tf_fwd:.1f} TFLOP/s, bound {b_fwd:.4f} ms {by_fwd}), plain fwd "
          f"{fwd_plain:.3f} ms, F.sdpa fwd {lib_f:.3f} ms; fp32 route (CUDA "
          f"cores) on the same values: fwd device {fmt(f32_fwd, '.3f')} ms",
          flush=True)
    print(f"  flash backward, bf16 route (wgmma): dq kernel {ms_dq:.3f} ms "
          f"(device {dms_dq:.3f} ms = {tf_dq:.1f} TFLOP/s, bound {b_dq:.4f} "
          f"ms {by_dq}), dk/dv kernel {ms_dkv:.3f} ms (device {dms_dkv:.3f} "
          f"ms = {tf_dkv:.1f} TFLOP/s, bound {b_dkv:.4f} ms {by_dkv}); fp32 "
          f"route (CUDA cores) on the same values: dq device "
          f"{fmt(f32_dq, '.3f')} ms, dk/dv device {fmt(f32_dkv, '.3f')} ms; "
          f"plain backward (dq+dk+dv) {plain:.3f} ms; F.sdpa backward "
          f"{lib:.3f} ms (fwd+bwd {lib_fb:.3f} - fwd {lib_f:.3f})",
          flush=True)
    common = dict(route="cuda",
                  routes={"bfloat16": "cuda wgmma",
                          "float32": "cuda fp32 CUDA cores"},
                  source="paddle_tpu_torch/kernels/csrc/flash_bwd_sm90.cu",
                  float32_source="paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
                  shape=f"bf16 B{B} S{S} H{Hq} D{D} causal (training)",
                  plain_ms=plain, library_ms=lib)
    rows["flash_attention_bwd_dq"] = dict(
        name="flash_attention_bwd_dq",
        replaces="paddle_tpu/kernels/flash_attention.py:145",
        max_abs_err=err_dq, ms=ms_dq, device_ms=dms_dq, tflops=tf_dq,
        float32_device_ms=f32_dq, bound_ms=b_dq, bound_by=by_dq, **common)
    rows["flash_attention_bwd_dkv"] = dict(
        name="flash_attention_bwd_dkv",
        replaces="paddle_tpu/kernels/flash_attention.py:182",
        max_abs_err=err_dkv, ms=ms_dkv, device_ms=dms_dkv, tflops=tf_dkv,
        float32_device_ms=f32_dkv, bound_ms=b_dkv, bound_by=by_dkv,
        **common)
    rows["flash_attention_fwd"].update(
        train_shape=common["shape"], train_max_abs_err=err["o"],
        train_lse_max_abs_err=err["lse"], train_ms=fwd_ms,
        train_device_ms=fwd_dms, train_tflops=tf_fwd,
        train_float32_device_ms=f32_fwd, train_plain_ms=fwd_plain,
        train_bound_ms=b_fwd, train_bound_by=by_fwd, train_library_ms=lib_f)
    del q, k, v, do, o, lse, delta, dq, dk, dv, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # -- fused AdamW: the optimizer's three dtype combinations (param,
    #    grad, moments) at a tail-only size, an odd size past one vector
    #    chunk, fc1's 2048 x 8192 and the word embedding's 50304 x 2048 (the
    #    train step's largest tensor); the kernel repeats the plain
    #    version's roundings op by op, so they agree to the bit
    f32, bf16 = torch.float32, torch.bfloat16
    combos = ((f32, f32, f32), (f32, bf16, bf16), (bf16, bf16, bf16))

    def adamw_inputs(n, pd, gd, md):
        return (randn(n, dtype=f32).to(pd), randn(n, dtype=f32).to(gd),
                (0.1 * randn(n, dtype=f32)).to(md),
                (0.1 * randn(n, dtype=f32)).abs().to(md))

    for n in (33, 65553, 2048 * 8192, 50304 * 2048):
        for pd, gd, md in combos:
            p, g, m, v = adamw_inputs(n, pd, gd, md)
            want = K.adamw_ref(p, g, m, v, **ADAMW_HP)
            got = (p.clone(), m.clone(), v.clone())
            K.fused_adamw_update(got[0], g, got[1], got[2], **ADAMW_HP)
            errs = [max_err(a, b) for a, b in zip(got, want)]
            print(f"  fused_adamw n={n} p {pd} g {gd} m/v {md}: p/m/v err "
                  f"{' '.join(f'{e:.1e}' for e in errs)} (tol 0)", flush=True)
            check(all(e == 0 for e in errs), f"adamw n={n} {pd}/{gd}/{md}: "
                  f"{errs}")
    n = 2048 * 8192
    p, g, m, v = adamw_inputs(n, f32, bf16, bf16)

    def ours():
        K.fused_adamw_update(p, g, m, v, **ADAMW_HP)

    ms = timed_ms(ours, 50)
    dms = device_ms(ours, "fused_adamw_kernel", 20)
    plain = timed_ms(lambda: K.adamw_ref(p, g, m, v, **ADAMW_HP), 20)
    err = max(max_err(a, b) for a, b in zip(
        K.adamw_ref(p, g, m, v, **ADAMW_HP),
        K.fused_adamw_update(p.clone(), g, m.clone(), v.clone(), **ADAMW_HP)))
    bms, by = bound(18 * n, 15 * n, PEAK_FP32)
    # the library's fused AdamW takes one dtype for all four tensors: time
    # both it and the kernel on fp32 p/g/m/v (32 B per element)
    p32, g32, m32, v32 = adamw_inputs(n, f32, f32, f32)
    step_t = torch.tensor(3.0, device=dev)
    lib = timed_ms(lambda: torch._fused_adamw_(
        [p32], [g32], [m32], [v32], [], [step_t], lr=ADAMW_HP["lr"],
        beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False), 50)
    ms32 = timed_ms(lambda: K.fused_adamw_update(p32, g32, m32, v32,
                                                 **ADAMW_HP), 50)
    print(f"  fused_adamw fp32 master + bf16 g/m/v, n={n}: kernel {ms:.4f} ms "
          f"(device {fmt(dms, '.4f')} ms), plain {plain:.4f} ms, bound "
          f"{bms:.4f} ms ({by}); all fp32: kernel {ms32:.4f} ms, "
          f"torch._fused_adamw_ {lib:.4f} ms", flush=True)
    rows["fused_adamw_update"] = dict(
        name="fused_adamw_update", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_adamw.cu",
        replaces="paddle_tpu/kernels/fused_optim.py:24",
        shape=f"n {n} (fc1), p fp32 master, g/m/v bf16",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib,
        library_note=f"torch._fused_adamw_ on fp32 p/g/m/v; the kernel on "
                     f"the same fp32 tensors took {ms32:.4f} ms")


def primitive_err(got, want):
    """(max |got - want|, the tolerance for the output's dtype)."""
    scale = max(1.0, want.float().abs().max().item())
    return max_err(got, want), PRIMITIVE_STEP[want.dtype] * scale


def primitive_checks(P, ops, gen, rows):
    """The two primitive factories vs plain on the card, then timed at the
    1.3B's hidden-state shapes; adds their rows to ``rows``."""
    dev = torch.device("cuda")
    H = 2048

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- the elementwise primitive: both functions at the hidden states'
    #    shape in bf16 and at ragged shapes in both dtypes
    cases = [((16, 2048, H), torch.bfloat16)] + [
        (s, d) for s in ((130,), (3, 5, 7))
        for d in (torch.float32, torch.bfloat16)]
    for name, fn in ELEMENTWISE_FNS.items():
        for shape, dtype in cases:
            args = [randn(*shape, dtype=dtype) for _ in range(3)]
            err, tol = primitive_err(ops[name](*args),
                                     P.elementwise_ref(fn, *args))
            print(f"  elementwise {name:14s} {str(dtype):15s} {list(shape)}: "
                  f"max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
            check(err <= tol, f"elementwise {name} {dtype} {shape}: {err}")
    x, y, a = (randn(16, 2048, H, dtype=torch.bfloat16) for _ in range(3))
    n = x.numel()
    axpy, fn = ops["x + a*y"], ELEMENTWISE_FNS["x + a*y"]
    ms = timed_ms(lambda: axpy(x, y, a), 50)
    dms = device_ms(lambda: axpy(x, y, a), "primitive_elementwise", 20)
    plain = timed_ms(lambda: P.elementwise_ref(fn, x, y, a), 10)
    lib = timed_ms(lambda: torch.addcmul(x, a, y), 50)
    tanh_ms = timed_ms(lambda: ops["x + a*tanh(y)"](x, y, a), 50)
    bms, by = bound(4 * n * 2, 2 * n, PEAK_FP32)
    err, _ = primitive_err(axpy(x, y, a), P.elementwise_ref(fn, x, y, a))
    print(f"  elementwise x + a*y bf16 [16, 2048, {H}]: kernel {ms:.4f} ms "
          f"(device {fmt(dms, '.4f')} ms), plain {plain:.4f} ms, "
          f"torch.addcmul {lib:.4f} ms, bound {bms:.4f} ms ({by}); "
          f"x + a*tanh(y) kernel {tanh_ms:.4f} ms", flush=True)
    rows["elementwise_kernel"] = dict(
        name="elementwise_kernel", route="triton",
        source="paddle_tpu_torch/kernels/primitive.py",
        replaces="paddle_tpu/kernels/primitive.py:62",
        shape=f"x + a*y, three bf16 operands [16, 2048, {H}]",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, tanh_ms=tanh_ms)
    del x, y, a

    # -- the row reduction: sum and max over the hidden states' rows in
    #    bf16, and ragged rows (C = 1280: blocks of 256; C = 33: of 1)
    cases = [((16 * 2048, H), torch.bfloat16)] + [
        (s, d) for s in ((8, 1280), (5, 33))
        for d in (torch.float32, torch.bfloat16)]
    for name, (fn, init) in REDUCE_FNS.items():
        for shape, dtype in cases:
            x = randn(*shape, dtype=dtype)
            got, want = ops[name](x), P.row_reduce_ref(fn, init, x)
            err, tol = primitive_err(got, want)
            tol = 0.0 if name == "row max" else tol  # a max does not round
            print(f"  row_reduce {name:8s} {str(dtype):15s} {list(shape)}: "
                  f"max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
            check(err <= tol and got.shape == want.shape,
                  f"row_reduce {name} {dtype} {shape}: {err}")
    x = randn(16 * 2048, H, dtype=torch.bfloat16)
    R = x.shape[0]
    row_sum, (fn, init) = ops["row sum"], REDUCE_FNS["row sum"]
    ms = timed_ms(lambda: row_sum(x), 100)
    dms = device_ms(lambda: row_sum(x), "primitive_row_reduce", 50)
    plain = timed_ms(lambda: P.row_reduce_ref(fn, init, x), 20)
    lib = timed_ms(lambda: torch.sum(x, dim=-1), 100)
    max_ms = timed_ms(lambda: ops["row max"](x), 100)
    max_lib = timed_ms(lambda: torch.amax(x, dim=-1), 100)
    bms, by = bound(R * H * 2 + R * 2, R * H, PEAK_FP32)
    err, _ = primitive_err(row_sum(x), P.row_reduce_ref(fn, init, x))
    print(f"  row_reduce row sum bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
          f"{fmt(dms, '.4f')} ms), plain {plain:.4f} ms, torch.sum "
          f"{lib:.4f} ms, bound {bms:.4f} ms ({by}); row max kernel "
          f"{max_ms:.4f} ms, torch.amax {max_lib:.4f} ms", flush=True)
    rows["row_reduce_kernel"] = dict(
        name="row_reduce_kernel", route="triton",
        source="paddle_tpu_torch/kernels/primitive.py",
        replaces="paddle_tpu/kernels/primitive.py:100",
        shape=f"row sum, bf16 x[{R}, {H}]", max_abs_err=err, ms=ms,
        device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, max_ms=max_ms, max_library_ms=max_lib)
    del x
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4b
def profile_kernels(fn):
    """Run ``fn`` under ``torch.profiler``; returns [(kernel name, device
    seconds)] summed by name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total * 1e-6)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return sorted(kernels, key=lambda kv: -kv[1])


def device_busy(fn, top: int = 6):
    """(device busy seconds, the ``top`` kernels by device time) of ``fn``.
    Busy is the sum of kernel times on the one stream the port uses."""
    kernels = profile_kernels(fn)
    return sum(t for _, t in kernels), kernels[:top]


def where_time_goes(model, eng, prompts, SamplingParams):
    """Host-clock time of 8 decode steps with all 8 slots live, and of one
    1024-token prefill, beside the device busy time the profiler reads
    for the same work; the difference is the device's idle share."""
    for p in prompts[1::2][:8]:
        eng.add_request(p, SamplingParams(max_new_tokens=30))
    eng.step()  # admit all 8 + one decode step
    steps = 8

    def decode():
        for _ in range(steps):
            eng.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    busy, top = device_busy(decode)
    busy /= steps
    print(f"[4b] decode step (8 live slots): {wall * 1e3:.2f} ms host clock, "
          f"device busy {busy * 1e3:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}", flush=True)
    for name, t in top:
        print(f"     {t / steps * 1e3:8.3f} ms/step  {name[:90]}", flush=True)
    while eng.has_unfinished:
        eng.step()
    ids = torch.tensor((prompts[1] * 4)[:1024], device="cuda")[None]

    def prefill():
        model.prefill_with_cache(ids, lengths=torch.tensor([1024],
                                                           device="cuda"))

    with torch.no_grad():
        prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy, top = device_busy(prefill)
    print(f"[4b] prefill T=1024: {wall * 1e3:.2f} ms host clock, device busy "
          f"{busy * 1e3:.2f} ms, idle share {1 - busy / wall:.3f}", flush=True)
    for name, t in top:
        print(f"     {t * 1e3:8.3f} ms  {name[:90]}", flush=True)


# ---------------------------------------------------------------- phase 5
def decode_logits(model, prompt, gen_tokens, device):
    """Prefill ``prompt`` into a one-slot paged cache, then feed all but the
    last generated token through ``decode_step``; returns the logits that
    predicted the last generated token."""
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache

    cfg = model.cfg
    cache = PagedKVCache(cfg.num_layers, 1, cfg.num_kv_heads, 2048,
                         cfg.head_dim, model.dtype, page_size=16,
                         device=device)
    cache.assign_pages(0, list(range(1, cache.num_blocks + 1)))
    n = len(prompt)
    T = 1 << max(3, (n - 1).bit_length())
    ids = torch.zeros((1, T), dtype=torch.long)
    ids[0, :n] = torch.tensor(prompt)
    logits, kvs = model.prefill_with_cache(
        ids.to(device), lengths=torch.tensor([n], device=device))
    cache.write_prefill(kvs, cache.page_table[0], T)
    for i, tok in enumerate(gen_tokens[:-1]):
        logits, _ = model.decode_step(
            torch.tensor([tok], device=device), cache.layer_caches(),
            torch.tensor([n + i], dtype=torch.int32, device=device))
    return logits[0]


# ---------------------------------------------------------------- phase 6
def train_slice(K, seed: int, rows):
    """GPT-3 1.3B train steps at full width (bench_gpt_dp's configuration
    at its batch of 16); fills the training kernels' launch counts into
    ``rows``."""
    import math

    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                    recompute_interval=1, loss_chunk=128)
    B, S, timed = 16, 2048, 5
    t_phase = t0 = time.perf_counter()
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, moment_dtype="bfloat16")
    step = make_sharded_train_step(model, opt)
    n = sum(p.numel() for p in model.parameters())
    n_tensors = sum(1 for _ in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    y = torch.roll(x, -1, dims=1)
    torch.cuda.synchronize()
    print(f"[6] GPT-3 1.3B train step ({n / 1e9:.3f} B params in {n_tensors} "
          f"tensors, bf16, fp32 master weights, bf16 moments, recompute every "
          f"block, loss_chunk {cfg.loss_chunk}), batch {B} x {S}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(x, y)]
    torch.cuda.synchronize()
    print(f"    warm-up step {time.perf_counter() - t0:.2f} s", flush=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step(x, y))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    counts = K.launch_counts()
    routes = check_flash_routes(K, "wgmma", "[6]")
    peak = torch.cuda.max_memory_allocated()
    kernels = profile_kernels(lambda: losses.append(step(x, y)))
    busy, top = sum(t for _, t in kernels), kernels[:10]
    flash_ms = {k: kernel_ms(kernels, sym) for k, sym in
                (("fwd", FWD_SYMBOL), *BWD_SYMBOLS.items())}
    norm_ms = {k: kernel_ms(kernels, sym) for k, sym in NORM_SYMBOLS.items()}
    losses = [float(v) for v in losses]
    tokens = B * S
    # bench.py's FLOP count (bench_gpt_dp): 6N + 12*L*H*S per token; it
    # leaves out the recomputed forward
    flops = (6 * n + 12 * cfg.num_layers * cfg.hidden_size * S) * tokens
    print(f"    losses {' '.join(f'{v:.4f}' for v in losses)} (ln V = "
          f"{math.log(cfg.vocab_size):.4f})", flush=True)
    print(f"    step {step_s * 1e3:.1f} ms host clock over {timed} steps = "
          f"{tokens / step_s:.1f} tokens/s; MFU {flops / step_s / PEAK_BF16:.4f}"
          f" ({flops:.4e} FLOP/step, recompute not counted, vs 989 TFLOP/s); "
          f"max memory allocated {peak / 2**30:.2f} GiB", flush=True)
    print(f"    profiled step: device busy {busy * 1e3:.1f} ms, idle share "
          f"{1 - busy / step_s:.4f} (against the timed steps' mean)",
          flush=True)
    for name, t in top:
        print(f"     {t * 1e3:9.3f} ms  {name[:90]}", flush=True)
    print(f"    kernel launches over the {timed} timed steps: {counts}; "
          f"flash kernels by route: {routes}", flush=True)
    print(f"    profiled step: {FWD_SYMBOL} {fmt(flash_ms['fwd'], '.3f')} ms, "
          f"{BWD_SYMBOLS['dq']} {fmt(flash_ms['dq'], '.3f')} ms, "
          f"{BWD_SYMBOLS['dkv']} {fmt(flash_ms['dkv'], '.3f')} ms of device "
          f"time", flush=True)
    L = cfg.num_layers
    print(f"    profiled step: LayerNorm {NORM_SYMBOLS['fwd']} "
          f"{fmt(norm_ms['fwd'], '.3f')} ms ({counts['fused_layer_norm'] / timed:g}"
          f" launches per step), backward {NORM_SYMBOLS['bwd']} "
          f"{fmt(norm_ms['bwd'], '.3f')} ms + {NORM_SYMBOLS['reduce']} "
          f"{fmt(norm_ms['reduce'], '.3f')} ms "
          f"({counts['layer_norm_bwd'] / timed:g} launches per step) of "
          f"device time", flush=True)
    check(None not in flash_ms.values(), f"the profiled step shows no "
          f"{FWD_SYMBOL} or {' or '.join(BWD_SYMBOLS.values())}: {flash_ms}")
    check(None not in norm_ms.values(), f"the profiled step shows no "
          f"{' or '.join(NORM_SYMBOLS.values())}: {norm_ms}")
    # LayerNorm: two per block, replayed by the recompute, and the final
    # one; one backward each for the 2L + 1 of the loss's graph
    check(counts["fused_layer_norm"] == (4 * L + 1) * timed
          and counts["layer_norm_bwd"] == (2 * L + 1) * timed,
          f"LayerNorm launches per step differ from 4L + 1 forwards and "
          f"2L + 1 backwards: {counts}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"first loss {losses[0]} is not within 0.5 of ln V")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(counts[k] > 0 for k in TRAINING_KERNELS),
          f"a kernel of the training path was never launched: {counts}")
    check(counts["flash_attention_fwd"] == 2 * L * timed
          and counts["flash_attention_bwd_dq"] == L * timed
          and counts["flash_attention_bwd_dkv"] == L * timed
          and counts["fused_adamw_update"] == n_tensors * timed,
          f"launches per step differ from 2L flash forwards (recompute), L "
          f"dq and dk/dv, one AdamW per parameter tensor: {counts}")
    for name in TRAINING_KERNELS:  # LayerNorm and flash fwd serve as well
        key = "launches_train" if "launches" in rows[name] else "launches"
        rows[name][key] = counts[name]
    print(f"    phase 6 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, opt, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def train_vs_plain(K, seed: int):
    """Full width, depth 2, fp32: 3 AdamW steps on the card (kernels) and
    on the CPU (plain versions) from the same weights and batches."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0,
                    use_recompute=True, loss_chunk=64)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    lr = 1e-3
    steps = {}
    for side, dev, m in (("card", "cuda", gpu), ("cpu", "cpu", cpu)):
        m.train()
        steps[side] = make_sharded_train_step(
            m, AdamW(learning_rate=lr, parameters=m.named_parameters()),
            device=dev)
    rng = torch.Generator().manual_seed(seed + 2)
    K.reset_launch_counts()
    for i in range(3):
        x = torch.randint(0, cfg.vocab_size, (2, 128), generator=rng)
        y = torch.roll(x, -1, dims=1)
        lg = float(steps["card"](x, y))
        lc = float(steps["cpu"](x, y))
        # fp32 CE near ln V: GEMM summation orders differ (cuBLAS / CPU)
        print(f"[7] step {i + 1}: loss card {lg:.6f} CPU {lc:.6f} (|diff| "
              f"{abs(lg - lc):.2e}, tol 1e-4)", flush=True)
        check(abs(lg - lc) <= 1e-4, f"step {i + 1} losses differ: {lg} {lc}")
        if i == 0:
            # the autograd repair: every parameter has a gradient on the
            # card, and it agrees with the CPU's to 1e-3 of its largest
            # entry (fp32 summation order through two blocks and the head)
            missing = [k for k, p in gpu.named_parameters() if p.grad is None]
            check(not missing, f"parameters without a gradient on the card: "
                  f"{missing}")
            worst = max((max_err(p.grad.cpu(), q.grad)
                         / max(q.grad.abs().max().item(), 1e-30), k)
                        for (k, p), q in zip(gpu.named_parameters(),
                                             cpu.parameters()))
            print(f"    step 1 gradients: every parameter has one on the "
                  f"card; worst max|diff| / max|grad| {worst[0]:.2e} "
                  f"({worst[1]}, tol 1e-3)", flush=True)
            check(worst[0] <= 1e-3, f"gradients differ: {worst}")
    counts = K.launch_counts()
    check(all(counts[k] > 0 for k in TRAINING_KERNELS),
          f"kernels not used on the card: {counts}")
    check_flash_routes(K, "cuda_cores", "[7]")
    print(f"    after step 3 (3 steps of lr {lr} move a parameter up to "
          f"~{3 * lr:.0e}); launches {counts}, every flash launch on the "
          f"fp32 route", flush=True)
    compare_updates(cfg, p0, gpu, cpu, 3, lr)
    print(f"    phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)


def compare_updates(cfg, p0, card, cpu, steps, lr):
    """||update on the card - update on the CPU|| / ||update on the CPU||
    over the model and per tensor, with the K third of each qkv bias set
    apart (its true gradient is zero; Adam moves its rounding noise by up
    to lr a step, so it is held to 2 * steps * lr); checks 1e-2 each."""
    k_part = slice(cfg.num_heads * cfg.head_dim,
                   (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim)
    num = den = 0.0
    worst, k_bias = (0.0, ""), 0.0
    for (k, p), q in zip(card.named_parameters(), cpu.parameters()):
        dg, dc = p.detach().cpu() - p0[k], q.detach() - p0[k]
        if k.endswith("attn.qkv.bias"):
            k_bias = max(k_bias, max_err(dg[k_part], dc[k_part]))
            dg[k_part] = dc[k_part] = 0
        d2, c2 = (dg - dc).square().sum().item(), dc.square().sum().item()
        num, den = num + d2, den + c2
        worst = max(worst, ((d2 / max(c2, 1e-30)) ** 0.5, k))
    total = (num / den) ** 0.5
    print(f"    updates, the K third of the qkv biases set apart: {total:.2e} "
          f"over the model, worst tensor {worst[0]:.2e} ({worst[1]}) (tol "
          f"1e-2 each); the K third {k_bias:.2e} (tol {2 * steps * lr:.0e})",
          flush=True)
    check(total <= 1e-2 and worst[0] <= 1e-2 and k_bias <= 2 * steps * lr,
          f"parameter updates differ: {total}, {worst}, K bias {k_bias}")


# ---------------------------------------------------------------- phase 8
def warmup_cosine(sched_mod, base_lr, warmup, start_lr):
    return sched_mod.LinearWarmup(
        sched_mod.CosineAnnealingDecay(base_lr, 1000), warmup, start_lr,
        base_lr)


def train_surface(K, seed):
    """GPT-3 1.3B (bf16, batch 16 x 2048) through the training surface:
    scheduler, loss scaler and run_steps, under each recompute policy."""
    import math

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_mod

    B, S, KS = 16, 2048, 3
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randint(0, GPT3_1p3B["vocab_size"], (B, S), generator=g,
                      device="cuda")
    y = torch.roll(x, -1, dims=1)
    xs, ys = x.expand(KS, B, S), y.expand(KS, B, S)
    # LinearWarmup(CosineAnnealingDecay(1e-4, 1000), 2, 0.0, 1e-4): epochs
    # 0 and 1 of the warm-up, (end - start) * e / warmup + start
    want_lrs = [(1e-4 - 0.0) * e / 2 + 0.0 for e in (0, 1)]
    results = {}
    for policy in (None, "save_flash", "dots_saveable"):
        t0 = time.perf_counter()
        cfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                        recompute_policy=policy, loss_chunk=128)
        model = GPTForCausalLM(
            cfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(seed))
        model.train()
        sched = warmup_cosine(sched_mod, 1e-4, 2, 0.0)
        opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                    multi_precision=True, moment_dtype="bfloat16")
        scaler = GradScaler(init_loss_scaling=2.0 ** 15)
        step = make_sharded_train_step(model, opt, scaler=scaler)
        n = sum(p.numel() for p in model.parameters())
        lrs = [opt.get_lr()]
        losses = [float(step(x, y))]
        sched.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        lrs.append(opt.get_lr())
        t1 = time.perf_counter()
        out = step.run_steps(xs, ys)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / KS
        counts = K.launch_counts()
        sched.step()
        peak = torch.cuda.max_memory_allocated()
        losses += [float(v) for v in out]
        tokens = B * S
        flops = (6 * n + 12 * cfg.num_layers * cfg.hidden_size * S) * tokens
        fwd = counts["flash_attention_fwd"] / KS
        results[policy] = (step_s, peak, fwd, losses)
        print(f"[8] policy {policy}: losses {' '.join(f'{v:.4f}' for v in losses)}"
              f"; rates used {lrs} (schedule {want_lrs}); loss scale "
              f"{step.loss_scaling():g}", flush=True)
        print(f"    run_steps({KS}): {step_s * 1e3:.1f} ms/step = "
              f"{tokens / step_s:.1f} tokens/s, MFU "
              f"{flops / step_s / PEAK_BF16:.4f}; max memory allocated "
              f"{peak / 2**30:.2f} GiB; per step: flash fwd {fwd:g}, dq "
              f"{counts['flash_attention_bwd_dq'] / KS:g}, dk/dv "
              f"{counts['flash_attention_bwd_dkv'] / KS:g}, AdamW "
              f"{counts['fused_adamw_update'] / KS:g}, LayerNorm "
              f"{counts['fused_layer_norm'] / KS:g}; policy took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        L = cfg.num_layers
        check(all(math.isfinite(v) for v in losses), f"non-finite loss "
              f"under {policy}: {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall under "
              f"{policy}: {losses}")
        check(lrs == want_lrs, f"rates {lrs} differ from the schedule "
              f"{want_lrs}")
        check(all(counts[k] > 0 for k in TRAINING_KERNELS),
              f"a kernel of the training path was never launched: {counts}")
        check(fwd == (L if policy == "save_flash" else 2 * L),
              f"flash forwards per step under {policy}: {fwd}")
        check_flash_routes(K, "wgmma", f"[8] {policy}")
        del model, opt, step, sched, scaler, out
        torch.cuda.empty_cache()
    base = results[None][3]
    for policy, (_, _, _, losses) in results.items():
        print(f"    {policy}: losses - those of None "
              f"{max(abs(a - b) for a, b in zip(losses, base)):.2e}",
              flush=True)


# ---------------------------------------------------------------- phase 9
def surface_vs_plain(K, seed):
    """Full width, depth 2, fp32, save_flash, scheduler, scaler and
    run_steps on the card and on the CPU from the same weights."""
    import math

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_mod

    t0 = time.perf_counter()
    cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0,
                    use_recompute=True, recompute_policy="save_flash",
                    loss_chunk=64)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(seed + 3)

    def batch(*lead):
        x = torch.randint(0, cfg.vocab_size, (*lead, 2, 128), generator=rng)
        return x, torch.roll(x, -1, dims=-1)

    # the kernels are deterministic: keeping O and LSE (save_flash) instead
    # of replaying the forward kernel gives the same gradients to the bit
    x, y = batch()
    grads, fwd = {}, {}
    for policy in (None, "save_flash"):
        gpu.cfg.recompute_policy = policy
        gpu.zero_grad(set_to_none=True)
        K.reset_launch_counts()
        gpu.forward_with_loss(x.cuda(), y.cuda()).backward()
        fwd[policy] = K.launch_counts()["flash_attention_fwd"]
        grads[policy] = {k: p.grad.clone() for k, p in gpu.named_parameters()}
    gpu.cfg.recompute_policy = "save_flash"
    gpu.zero_grad(set_to_none=True)
    same = all(torch.equal(grads[None][k], grads["save_flash"][k])
               for k in grads[None])
    print(f"[9] gradients under None and save_flash on the card: bitwise "
          f"equal {same}; flash forwards {fwd[None]} and "
          f"{fwd['save_flash']}", flush=True)
    check(same and fwd[None] == 2 * fwd["save_flash"] == 4,
          f"save_flash changed the gradients or the forwards: {fwd}")
    del grads
    p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    lr = 1e-3
    sides = {}
    for side, dev, m in (("card", "cuda", gpu), ("cpu", "cpu", cpu)):
        m.train()
        sched = warmup_cosine(sched_mod, lr, 2, 1e-4)
        # no finite fp32 scale overflows these fp32 gradients (the largest
        # is ~0.02 of the scale), so the first step's scale is infinite
        scaler = GradScaler(init_loss_scaling=float("inf"),
                            incr_every_n_steps=2)
        # epsilon 1e-6: Adam moves an entry whose gradient is at rounding
        # level by a full lr in the direction of that rounding; in a
        # 2048-entry tensor one such sign flip differs by ~1.5% in L2
        opt = AdamW(learning_rate=sched, epsilon=1e-6,
                    parameters=m.named_parameters())
        sides[side] = (make_sharded_train_step(m, opt, scaler=scaler,
                                               device=dev), sched, scaler)
    x, y = batch()
    K.reset_launch_counts()
    losses = {s: float(st(x, y)) for s, (st, _, _) in sides.items()}
    auto = {s: (sc._scale, sc._good_steps, sc._bad_steps)
            for s, (_, _, sc) in sides.items()}
    kept = {s: all(torch.equal(p.detach().cpu(), p0[k])
                   for k, p in m.named_parameters())
            for s, m in (("card", gpu), ("cpu", cpu))}
    moments = all(not s["moment1"].any() and s["beta1_pow"] == 1
                  for st, _, _ in sides.values()
                  for s in st.optimizer.state.values())
    print(f"    step 1 (scale inf): losses {losses}; parameters bitwise "
          f"unchanged {kept}; AdamW state untouched {moments}; automaton "
          f"(scale, good, bad) {auto}", flush=True)
    check(not any(math.isfinite(v) for v in losses.values())
          and all(kept.values())
          and moments and auto["card"] == auto["cpu"],
          "the overflowing step was not skipped alike on both sides")
    xs, ys = batch(3)
    out, lrs = {}, {}
    for s, (st, sched, sc) in sides.items():
        sc.set_init_loss_scaling(2.0 ** 15)
        sched.step()
        lrs[s] = st.optimizer.get_lr()
        out[s] = [float(v) for v in st.run_steps(xs, ys)]
    auto = {s: (sc._scale, sc._good_steps, sc._bad_steps)
            for s, (_, _, sc) in sides.items()}
    counts = K.launch_counts()
    diff = max(abs(a - b) for a, b in zip(out["card"], out["cpu"]))
    print(f"    run_steps(3) at lr {lrs}: losses card {out['card']}, CPU "
          f"{out['cpu']} (max |diff| {diff:.2e}, tol 1e-4); automaton "
          f"{auto}; launches {counts}", flush=True)
    check(diff <= 1e-4 and all(math.isfinite(v) for v in out["card"]),
          f"losses differ: {out}")
    check(auto["card"] == auto["cpu"] == (2.0 ** 16, 1, 0),
          f"the scaler's automaton differs: {auto}")
    check(lrs["card"] == lrs["cpu"], f"rates differ: {lrs}")
    check(all(counts[k] > 0 for k in TRAINING_KERNELS),
          f"kernels not used on the card: {counts}")
    check_flash_routes(K, "cuda_cores", "[9]")
    compare_updates(cfg, p0, gpu, cpu, 3, lr)
    print(f"    phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu, gpu, sides
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 10
def user_api_path(K, ops, rows):
    """RMSNorm and the primitives through the user-facing API on the 1.3B's
    hidden states at the training batch; fills their launch counts."""
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.nn import RMSNorm
    from paddle_tpu_torch.nn import functional as PF

    g = torch.Generator(device="cuda").manual_seed(10)
    H = 2048
    h = torch.randn(16, 2048, H, generator=g, device="cuda") \
        .to(torch.bfloat16).requires_grad_()
    dy = torch.randn(16, 2048, H, generator=g, device="cuda") \
        .to(torch.bfloat16)
    bias = torch.zeros(H, device="cuda", dtype=torch.bfloat16)
    alpha = torch.full_like(dy, 0.5)
    norm = RMSNorm(H, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(H, generator=g,
                                                device="cuda"))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    y = norm(h)
    y.backward(dy)
    with torch.no_grad():
        y2 = PF.rms_norm(h, norm.weight)
        y3 = fused_rms_norm(h, norm.weight, bias, begin_norm_axis=-1)
        r = ops["x + a*y"](h.detach(), y.detach(), alpha)
        t = ops["x + a*tanh(y)"](h.detach(), y.detach(), alpha)
        s, mx = ops["row sum"](r), ops["row max"](t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    finite = all(bool(torch.isfinite(v).all()) for v in
                 (y, h.grad, norm.weight.grad, r, t, s, mx))
    print(f"[10] nn.RMSNorm fwd+bwd, F.rms_norm, incubate fused_rms_norm, "
          f"x + a*y, x + a*tanh(y), row sum and row max over bf16 "
          f"[16, 2048, {H}] in {wall * 1e3:.1f} ms: finite {finite}; "
          f"launches {counts}", flush=True)
    check(finite and s.shape == mx.shape == (16, 2048),
          "the user-facing path's outputs are not finite or misshapen")
    check(torch.equal(y2, y.detach()) and torch.equal(y3, y.detach()),
          "the RMSNorm entry points disagree")
    # nn.RMSNorm's forward and backward (the kernels, through
    # RMSNormFunction) against the plain versions from the same values
    w = norm.weight.detach()
    err_y = max_err(y, K.rms_norm_ref(h.detach(), w))
    dx, dw = K.rms_norm_bwd_ref(h.detach(), w, dy)
    errs = [(max_err(got, want), norm_grad_tol(want))
            for got, want in ((h.grad, dx), (norm.weight.grad, dw))]
    print(f"     nn.RMSNorm vs plain: forward err {err_y:.3e} (tol "
          f"{TOL[('rms_norm', 'bfloat16')]:.1e}), backward dx err "
          f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), dw err {errs[1][0]:.3e} "
          f"(tol {errs[1][1]:.3e})", flush=True)
    check(err_y <= TOL[("rms_norm", "bfloat16")]
          and all(e <= tol for e, tol in errs),
          f"nn.RMSNorm on the card: {err_y} {errs}")
    del dx, dw
    check(all(counts[k] > 0 for k in USER_API_KERNELS),
          f"a kernel of the user-facing path was never launched: {counts}")
    for name in USER_API_KERNELS:
        rows[name]["launches"] = counts[name]
    del h, dy, alpha, y, y2, y3, r, t
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the "
              "card only", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "paddle_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no paddle_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    t_start = time.perf_counter()

    # ---- 1. device
    smi = nvidia_smi_line()
    print(f"[1] device: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("    TF32 off for float32 matmul and cuDNN", flush=True)

    # ---- 2. build
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build

    secs = _build.build_all()
    print(f"[2] nvcc built {_build.sources()} in {secs:.1f} s "
          f"into {_build.BUILD}", flush=True)
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                print(f"    {name}: {m.group(1)}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"    {name}:   {line.strip()}", flush=True)
    # the bf16 flash kernels' products run on the tensor cores: HGMMA in
    # their SASS
    for lib, symbols in SM90_LIBS.items():
        hgmma = sass_counts(_build.BUILD / f"lib{lib}.so", "HGMMA")
        for sym in symbols:
            found = {fn: n for fn, n in hgmma.items() if sym in fn}
            print(f"    HGMMA instructions in {sym}: {found}", flush=True)
            check(found and all(n > 0 for n in found.values()),
                  f"no HGMMA in {sym}: {found}")
    t0 = time.perf_counter()
    x = torch.randn(4, 2048, device="cuda")
    K.fused_layer_norm(x, torch.ones(2048, device="cuda"),
                       torch.zeros(2048, device="cuda"))
    K.fused_rms_norm(x, torch.ones(2048, device="cuda"))
    torch.cuda.synchronize()
    print(f"    CUDA LayerNorm and RMSNorm first launches "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    P = K.primitive
    ops = {name: P.elementwise_kernel(fn)
           for name, fn in ELEMENTWISE_FNS.items()}
    ops.update({name: P.row_reduce_kernel(fn, init)
                for name, (fn, init) in REDUCE_FNS.items()})
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for name in ELEMENTWISE_FNS:
            ops[name](xd, xd, xd)
        for name in REDUCE_FNS:
            ops[name](xd)
    torch.cuda.synchronize()
    print(f"    Triton primitives {sorted(ops)} (fp32, bf16) JIT + first "
          f"launch {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernels vs plain
    print("[3] kernels vs plain on the card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = kernel_checks(K, gen)
    norm_checks(K, gen, rows)
    train_kernel_checks(K, gen, rows)
    primitive_checks(P, ops, gen, rows)

    # ---- 4. slice at full width
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    cfg = GPTConfig(**GPT3_1p3B)
    t0 = time.perf_counter()
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    nparams = sum(p.numel() for p in model.parameters())
    eng_cfg = EngineConfig(max_batch_size=8, max_seq_len=2048)
    eng = Engine(model, eng_cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"[4] GPT-3 1.3B ({nparams / 1e9:.3f} B params, bf16, "
          f"{cfg.num_layers} layers) + engine (B {eng_cfg.max_batch_size}, "
          f"S_max {eng_cfg.max_seq_len}, page {eng.cache.page_size}, KV "
          f"{eng.cache.nbytes / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(args.seed)
    eng.generate([torch.randint(0, cfg.vocab_size, (64,), generator=rng)
                  .tolist()], SamplingParams(max_new_tokens=4))  # warm-up
    lengths = [128 if i % 2 == 0 else
               int(torch.randint(300, 701, (1,), generator=rng))
               for i in range(16)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lengths]
    sp = SamplingParams(max_new_tokens=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, sp) for p in prompts]
    while eng.has_unfinished:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    outs = [r.output_ids for r in reqs]
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(r.first_token_time - r.arrival_time for r in reqs)
    tpot = sorted((r.finish_time - r.first_token_time)
                  / (r.num_generated - 1) for r in reqs)
    print(f"    served {len(reqs)} requests (prompt lengths {lengths}), "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s",
          flush=True)
    print(f"    TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, TPOT p50 "
          f"{tpot[len(tpot) // 2] * 1e3:.2f} ms, max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    kernel launches in the run: {counts}", flush=True)
    check(all(len(o) == 32 for o in outs), "a request did not generate 32 "
          "tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "token id out of range")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"a kernel of the path was never launched: {counts}")
    routes = check_flash_routes(K, "wgmma", "[4]")
    print(f"    flash forward by route: {routes['flash_attention_fwd']}",
          flush=True)
    for name in SERVING_KERNELS:
        rows[name]["launches"] = counts[name]
    rows["flash_attention_fwd"]["route_launches"] = \
        routes["flash_attention_fwd"]
    where_time_goes(model, eng, prompts, SamplingParams)
    del model, eng
    torch.cuda.empty_cache()

    # ---- 5. slice vs plain, fp32, depth 2
    cfg2 = GPTConfig(**{**GPT3_1p3B, "num_layers": 2})
    t0 = time.perf_counter()
    cpu_model = GPTForCausalLM(
        cfg2, device="cpu", dtype=torch.float32,
        generator=torch.Generator().manual_seed(args.seed))
    gpu_model = GPTForCausalLM(cfg2, device="cuda", dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompts = [torch.randint(0, cfg2.vocab_size, (n,), generator=rng).tolist()
               for n in (17, 100, 45)]
    sp = SamplingParams(max_new_tokens=8)
    small = dict(max_batch_size=2, max_seq_len=2048)
    K.reset_launch_counts()
    out_gpu = Engine(gpu_model, EngineConfig(**small),
                     device="cuda").generate(prompts, sp)
    counts = K.launch_counts()
    out_cpu = Engine(cpu_model, EngineConfig(**small),
                     device="cpu").generate(prompts, sp)
    print(f"[5] depth-2 fp32 full width: card {out_gpu}", flush=True)
    print(f"    plain on the CPU            {out_cpu}", flush=True)
    check(out_gpu == out_cpu, "greedy tokens differ between the kernels on "
          "the card and the plain versions on the CPU")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"kernels not used: {counts}")
    routes = check_flash_routes(K, "cuda_cores", "[5]")
    print(f"    flash forward by route on the card: "
          f"{routes['flash_attention_fwd']}", flush=True)
    with torch.no_grad():
        lg = decode_logits(gpu_model, prompts[1], out_gpu[1], "cuda")
        lc = decode_logits(cpu_model, prompts[1], out_cpu[1], "cpu")
        err = max_err(lg.cpu(), lc)
        print(f"    last decode logits card vs CPU: max_abs_err {err:.3e} "
              f"(tol 1e-3)", flush=True)
        check(err <= 1e-3, f"decode logits differ: {err}")
        full = prompts[1] + out_gpu[1][:-1]
        n = len(full)
        T = 1 << max(3, (n - 1).bit_length())
        ids = torch.zeros((1, T), dtype=torch.long)
        ids[0, :n] = torch.tensor(full)
        lp, _ = gpu_model.prefill_with_cache(
            ids.cuda(), lengths=torch.tensor([n], device="cuda"))
        err = max_err(lp[0], lg)
        print(f"    flash prefill vs paged decode logits on the card: "
              f"max_abs_err {err:.3e} (tol 1e-3); argmax "
              f"{int(lp[0].argmax())} vs generated {out_gpu[1][-1]}",
              flush=True)
        check(err <= 1e-3 and int(lp[0].argmax()) == out_gpu[1][-1],
              f"prefill/decode disagree: {err}")
    print(f"    phase 5 took {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu_model, gpu_model
    torch.cuda.empty_cache()

    # ---- 6. training slice at full width; 7. training vs plain
    train_slice(K, args.seed, rows)
    train_vs_plain(K, args.seed)

    # ---- 8. training surface at full width; 9. surface vs plain;
    #      10. RMSNorm and the primitives through the user-facing API
    t0 = time.perf_counter()
    train_surface(K, args.seed)
    print(f"    phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    surface_vs_plain(K, args.seed)
    user_api_path(K, ops, rows)

    # ---- results
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [rows[k] for k in ALL_KERNELS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
