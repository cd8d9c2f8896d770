#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is turned
   off for float32 products and convolutions so fp32 checks are fp32;
2. build: every CUDA source under ``paddle_tpu_torch/kernels/csrc`` is
   compiled with ``nvcc`` for sm_90a (one process per source, in parallel),
   and the Triton LayerNorm is JIT-compiled;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving slice's shapes, in bf16 and fp32, with the stated
   tolerance; then timed with CUDA events beside the plain version, a
   library yardstick the port never calls, and the H100 bound;
4. slice at full width: GPT-3 1.3B (24 layers, bf16, random weights from
   the seed) behind ``Engine.generate``, 16 greedy requests through 8
   slots, with each kernel's launch count over that run;
5. slice vs plain: at full width and depth 2 in fp32, the same weights
   serve 3 greedy prompts on the card and on the CPU (plain versions);
   tokens must match and the last decode logits agree; on the card, flash
   prefill over the generated text agrees with the paged decode step.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``paddle_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
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
}


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


def device_ms(fn, kernel: str, iters: int) -> float:
    """Device time of one launch of ``kernel`` (a substring of its name),
    read by ``torch.profiler`` over ``iters`` calls of ``fn``: unlike
    ``timed_ms`` it excludes the host's launch cost."""
    fn()
    kernels = profile_kernels(lambda: [fn() for _ in range(iters)])
    return sum(t for name, t in kernels if kernel in name) / iters * 1e3


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


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

    # -- LayerNorm: decode rows (B_max = 8) and a prefill bucket, H = 2048
    H = 2048
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((8, 1, H), (1, 1024, H), (3, 77, H)):
            x = randn(*shape, dtype=dtype)
            w = (1 + 0.1 * randn(H, dtype=torch.float32)).to(dtype)
            b = (0.1 * randn(H, dtype=torch.float32)).to(dtype)
            err = max_err(K.fused_layer_norm(x, w, b, 1e-5),
                          K.layer_norm_ref(x, w, b, 1e-5))
            tol = TOL[("layer_norm", str(dtype).split(".")[1])]
            print(f"  layer_norm {str(dtype):15s} x{list(shape)} "
                  f"max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
            check(err <= tol, f"layer_norm {dtype} {shape}: {err} > {tol}")
    timings = {}
    for R in (8, 1024):
        x = randn(R, H, dtype=torch.bfloat16)
        w = randn(H, dtype=torch.bfloat16)
        b = randn(H, dtype=torch.bfloat16)
        ms = timed_ms(lambda: K.fused_layer_norm(x, w, b), 200)
        plain = timed_ms(lambda: K.layer_norm_ref(x, w, b), 200)
        lib = timed_ms(lambda: F.layer_norm(x, (H,), w, b, 1e-5), 200)
        bms, by = bound(2 * R * H * 2 + 2 * H * 2, 8 * R * H, PEAK_FP32)
        err = max_err(K.fused_layer_norm(x, w, b), K.layer_norm_ref(x, w, b))
        dms = device_ms(lambda: K.fused_layer_norm(x, w, b), "_ln_fwd_kernel",
                        50)
        timings[R] = (ms, plain, lib, bms, by, err, dms)
        print(f"  layer_norm bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
              f"{dms:.4f} ms), plain {plain:.4f} ms, F.layer_norm {lib:.4f} "
              f"ms, bound {bms:.5f} ms ({by})", flush=True)
    ms, plain, lib, bms, by, err, dms = timings[8]
    rows["fused_layer_norm"] = dict(
        name="fused_layer_norm", route="triton",
        source="paddle_tpu_torch/kernels/norms.py",
        replaces="paddle_tpu/kernels/norms.py:20",
        shape="bf16 x[8, 2048] (decode rows)", max_abs_err=err, ms=ms,
        device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib)

    # -- flash forward: prefill B=1, H=16, D=128, causal; plus a ragged S
    #    and GQA for correctness
    cases = [(1, 1024, 16, 16, 128, True), (1, 200, 16, 16, 128, True),
             (2, 130, 16, 4, 128, False), (1, 256, 16, 16, 64, True)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, S, Hq, Hkv, D, causal in cases:
            q = randn(B, S, Hq, D, dtype=dtype)
            k = randn(B, S, Hkv, D, dtype=dtype)
            v = randn(B, S, Hkv, D, dtype=dtype)
            o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=causal)
            eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
            to, tl = TOL[("flash", dn)], TOL[("flash_lse", dn)]
            print(f"  flash_fwd {str(dtype):15s} B{B} S{S} H{Hq}/{Hkv} D{D} "
                  f"causal={causal}: O err {eo:.3e} (tol {to:.1e}), LSE err "
                  f"{el:.3e} (tol {tl:.1e})", flush=True)
            check(eo <= to and el <= tl, f"flash {dtype} S{S}: O {eo}, "
                  f"LSE {el}")
    B, S, Hq, D = 1, 1024, 16, 128
    q, k, v = (randn(B, S, Hq, D, dtype=torch.bfloat16) for _ in range(3))
    ms = timed_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True), 20)
    plain = timed_ms(lambda: K.flash_attention_ref(q, k, v, causal=True), 20)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    pairs = S * (S + 1) // 2
    bms, by = bound(4 * B * S * Hq * D * 2 + B * Hq * S * 4,
                    4 * D * pairs * B * Hq, PEAK_BF16)
    err = max_err(K.flash_attention_fwd(q, k, v, causal=True)[0],
                  K.flash_attention_ref(q, k, v, causal=True)[0])
    dms = device_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True),
                    "flash_fwd_kernel", 10)
    print(f"  flash_fwd bf16 S{S}: kernel {ms:.4f} ms (device {dms:.4f} ms), "
          f"plain {plain:.4f} ms, F.sdpa {lib:.4f} ms, bound {bms:.5f} ms "
          f"({by})", flush=True)
    rows["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:44",
        shape="bf16 B1 S1024 H16 D128 causal (prefill bucket)",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
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
          f"{ms:.4f} ms (device {dms:.4f} ms), plain {plain:.4f} ms, bound "
          f"{bms:.5f} ms ({by})", flush=True)
    rows["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_decode.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:43",
        shape=f"bf16 B8 H16 D128 ps16 nb128, {live_pages} live pages",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=None)
    return rows


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
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}", flush=True)
    t0 = time.perf_counter()
    x = torch.randn(4, 2048, device="cuda")
    K.fused_layer_norm(x, torch.ones(2048, device="cuda"),
                       torch.zeros(2048, device="cuda"))
    torch.cuda.synchronize()
    print(f"    Triton LayerNorm JIT + first launch {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 3. kernels vs plain
    print("[3] kernels vs plain on the card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = kernel_checks(K, gen)

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
    check(all(c > 0 for c in counts.values()),
          f"a kernel of the path was never launched: {counts}")
    for name, row in rows.items():
        row["launches"] = counts[name]
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
    check(all(c > 0 for c in counts.values()), f"kernels not used: {counts}")
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

    # ---- 6/7. results
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [rows[k] for k in
                                  ("fused_layer_norm", "flash_attention_fwd",
                                   "paged_attention")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
