"""Each Hopper kernel of the port against its plain PyTorch version on the
card, and the serving engine on the card against the CPU.

Every case is marked ``gpu`` and skips without a CUDA card (decided inside
the ``cuda`` fixture, so every process collects the same tests). This file
imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because ``tests/conftest.py`` sets JAX up).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as K

# bf16: outputs round to bf16 (2^-8 relative); the flash kernel also
# rounds P against its running tile max where the plain version uses the
# row max
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _flash_inputs(cuda, dtype, B, S, Hkv, D, fused=False, pad=0, seed=1):
    """q, k, v, do with 16 query heads; ``fused``: q/k/v are the column
    slices of one [B, S, (16 + 2 Hkv) D + pad] projection, as models/gpt.py
    makes them with ``pad`` 0."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if fused:
        qkv = torch.randn(B, S, (16 + 2 * Hkv) * D + pad, generator=g,
                          device=cuda).to(dtype)
        q, k, v = (t.unflatten(-1, (-1, D)) for t in qkv.split(
            [16 * D, Hkv * D, Hkv * D, pad], dim=-1)[:3])
    else:
        q = torch.randn(B, S, 16, D, generator=g, device=cuda).to(dtype)
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
                for _ in range(2))
    do = torch.randn(B, S, 16, D, generator=g, device=cuda).to(dtype)
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 77, 2048), (5, 100)])
def test_layer_norm_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    H = shape[-1]
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(H, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(H, generator=g, device=cuda)).to(dtype)
    before = K.fused_layer_norm.launches
    got = K.fused_layer_norm(x, w, b)
    assert K.fused_layer_norm.launches == before + 1
    assert got.shape == x.shape
    # |y| < 8: bf16 may differ by one rounding step (2^-5)
    tol = 1e-4 if dtype == torch.float32 else 3.2e-2
    assert got.dtype == dtype and _err(got, K.layer_norm_ref(x, w, b)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hkv,D,causal", [(200, 16, 128, True),
                                            (130, 4, 128, False),
                                            (64, 8, 64, True),
                                            (1, 16, 128, True),
                                            (63, 16, 128, True),
                                            (64, 16, 128, False),
                                            (65, 4, 128, True),
                                            (200, 1, 128, True),
                                            (65, 16, 64, True),
                                            (63, 1, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, S, Hkv, D, causal):
    """O and LSE against ``flash_attention_ref`` at the edges of the
    kernels' 64-row tiles, with GQA and at both head dims; one launch on
    the dtype's route (bf16: tensor cores, fp32: CUDA cores)."""
    from paddle_tpu_torch.kernels.flash_attention import FWD_ROUTES

    q, k, v, _ = _flash_inputs(cuda, dtype, 2, S, Hkv, D, seed=0)
    w = K.flash_attention_fwd
    n, routes = w.launches, dict(w.route_launches)
    routes[FWD_ROUTES[dtype]] += 1
    o, lse = w(q, k, v, causal=causal)
    assert (w.launches, w.route_launches) == (n + 1, routes)
    o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hkv,D,causal", [(200, 16, 128, True),
                                            (130, 4, 128, False),
                                            (65, 1, 64, True)])
def test_flash_fwd_reads_fused_qkv_views(cuda, dtype, S, Hkv, D, causal):
    """q/k/v as strided column slices of the fused qkv projection: the bf16
    route's tensor maps read them in place, and both routes match the plain
    version on them (tolerances as above)."""
    from paddle_tpu_torch.kernels.flash_attention import _for_tma

    q, k, v, _ = _flash_inputs(cuda, dtype, 2, S, Hkv, D, fused=True)
    assert not q.is_contiguous() and all(_for_tma(t) is t for t in (q, k, v))
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=causal)
    assert _err(o, o_ref) <= TOL[dtype] and _err(lse, lse_ref) <= 1e-3


@pytest.mark.gpu
def test_flash_fwd_copies_views_tma_cannot_read(cuda):
    """Slices of a projection 4 elements wider: their sequence stride is
    not a 16-byte multiple, so the bf16 route copies them before the TMA
    reads them, and still matches the plain version."""
    from paddle_tpu_torch.kernels.flash_attention import _for_tma

    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 2, 77, 4, 128,
                               fused=True, pad=4, seed=2)
    assert not any(_for_tma(t) is t for t in (q, k, v))
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=True)
    assert _err(o, o_ref) <= TOL[torch.bfloat16]
    assert _err(lse, lse_ref) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv", [16, 4])
def test_flash_fwd_bf16_is_deterministic(cuda, Hkv):
    """No split over keys and no atomics: two bf16 forwards give the same O
    and LSE to the bit."""
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 2, 1024, Hkv, 128)
    first = K.flash_attention_fwd(q, k, v, causal=True)
    second = K.flash_attention_fwd(q, k, v, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4])
def test_paged_kernel_matches_plain(cuda, dtype, rep):
    """Ragged live pages, sentinel tails and an empty slot."""
    rng = np.random.default_rng(0)
    B, Hkv, ps, nb, D = 3, 2, 16, 4, 64
    P = B * nb + 1
    kp = torch.from_numpy(rng.standard_normal((P, Hkv, ps, D))).to(dtype)
    vp = torch.from_numpy(rng.standard_normal((P, Hkv, ps, D))).to(dtype)
    table = torch.full((B, nb), -1, dtype=torch.int32)
    table[0, :3] = torch.tensor([4, 1, 7])
    table[1, :1] = torch.tensor([2])
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, 1, D))).to(dtype)
    pos = torch.tensor([40, 9, 0], dtype=torch.int32)
    args = [t.to(cuda) for t in (q, kp, vp, table, pos)]
    before = K.paged_attention.launches
    got = K.paged_attention(*args)
    assert K.paged_attention.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _err(got, K.paged_attention_ref(*args)) <= TOL[dtype]


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    """The same fp32 weights serve greedy requests on the card (kernels)
    and on the CPU (plain versions): identical tokens, every kernel used."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    cfg = GPTConfig(vocab_size=128, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=64)
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    gpu = GPTForCausalLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [[5, 17, 3], list(range(1, 21)), [9, 2, 11, 4, 8]]
    sp = SamplingParams(max_new_tokens=6)
    K.reset_launch_counts()
    got = Engine(gpu, EngineConfig(max_batch_size=2, max_seq_len=64),
                 device=cuda).generate(prompts, sp)
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("fused_layer_norm",
                                       "flash_attention_fwd",
                                       "paged_attention"))
    want = Engine(cpu, EngineConfig(max_batch_size=2, max_seq_len=64),
                  device="cpu").generate(prompts, sp)
    assert got == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hkv,D,causal", [(200, 16, 128, True),
                                            (130, 4, 128, False),
                                            (64, 8, 64, True),
                                            (1, 16, 128, True),
                                            (63, 16, 128, True),
                                            (65, 4, 128, False),
                                            (200, 1, 128, True),
                                            (65, 16, 64, True)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, S, Hkv, D, causal):
    """dq (one launch) and dk/dv (one launch, GQA summed over the group)
    against ``flash_attention_bwd_ref`` from the forward kernel's O and
    LSE, at the edges of the kernels' 64-row tiles; bf16 takes the
    tensor-core route, fp32 the CUDA-core route. bf16: outputs of |d| < 8
    differ by at most one rounding step (2^-5)."""
    from paddle_tpu_torch.kernels.flash_attention import BWD_ROUTES

    q, k, v, do = _flash_inputs(cuda, dtype, 2, S, Hkv, D)
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    wrappers = (K.flash_attention_bwd_dq, K.flash_attention_bwd_dkv)
    before = [(w.launches, dict(w.route_launches)) for w in wrappers]
    got = K.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for w, (n, routes) in zip(wrappers, before):
        routes[BWD_ROUTES[dtype]] += 1
        assert (w.launches, w.route_launches) == (n + 1, routes)
    want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 3.2e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _err(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hkv,D,causal", [(200, 16, 128, True),
                                            (130, 4, 128, False),
                                            (65, 1, 64, True)])
def test_flash_bwd_reads_fused_qkv_views(cuda, dtype, S, Hkv, D, causal):
    """q/k/v as strided column slices of the fused qkv projection: the bf16
    route's tensor maps read them in place (no copy), and both routes match
    the plain version on them (tolerances as above)."""
    from paddle_tpu_torch.kernels.flash_attention import _for_tma

    q, k, v, do = _flash_inputs(cuda, dtype, 2, S, Hkv, D, fused=True)
    assert not q.is_contiguous() and all(_for_tma(t) is t for t in (q, k, v))
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    got = K.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 3.2e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and _err(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv", [16, 4])
def test_flash_bwd_bf16_is_deterministic(cuda, Hkv):
    """No atomics and GQA summed in registers: two bf16 calls give the same
    dq, dk and dv to the bit."""
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, 2, 1024, Hkv, 128)
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    first = K.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = K.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [33, 65553])
@pytest.mark.parametrize("dtypes", [
    (torch.float32,) * 3, (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16,) * 3], ids=["fp32", "master+bf16", "bf16"])
def test_adamw_kernel_matches_plain_bitwise(cuda, n, dtypes):
    """The kernel rounds each operation as the plain version does, so p, m
    and v agree to the bit."""
    pd, gd, md = dtypes
    g = torch.Generator(device=cuda).manual_seed(2)
    p, gr, m, v = (torch.randn(n, generator=g, device=cuda) for _ in range(4))
    p, gr, m, v = p.to(pd), gr.to(gd), (0.1 * m).to(md), (0.1 * v).abs().to(md)
    hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              beta1_pow=0.9 ** 2, beta2_pow=0.999 ** 2)
    want = K.adamw_ref(p, gr, m, v, **hp)
    before = K.fused_adamw_update.launches
    got = K.fused_adamw_update(p, gr, m, v, **hp)
    assert K.fused_adamw_update.launches == before + 1
    assert all(a is b for a, b in zip(got, (p, m, v)))  # in place
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _small_gpt(device, dtype=torch.float32):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=64,
                    use_recompute=True, loss_chunk=16)
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return m.to(device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_parameter_gets_a_gradient_on_card(cuda, dtype):
    """The autograd repair: a backward through the kernels reaches every
    parameter, through the flash and LayerNorm Functions. In fp32 each
    gradient agrees with the CPU's (plain versions) to 1e-4 of its largest
    entry (summation order)."""
    rng = torch.Generator().manual_seed(3)
    x = torch.randint(0, 128, (2, 64), generator=rng)
    y = torch.roll(x, -1, dims=1)
    gpu = _small_gpt(cuda, dtype)
    K.reset_launch_counts()
    gpu.forward_with_loss(x.to(cuda), y.to(cuda)).backward()
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in (
        "fused_layer_norm", "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"))
    grads = {k: p.grad for k, p in gpu.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
    if dtype == torch.float32:
        cpu = _small_gpt("cpu")
        cpu.forward_with_loss(x, y).backward()
        for k, p in cpu.named_parameters():
            assert _err(grads[k].cpu(), p.grad) <= 1e-4 * p.grad.abs().max()


@pytest.mark.gpu
def test_save_flash_gradients_equal_none_in_bf16(cuda):
    """At depth 2 in bf16 the kernels are deterministic: keeping each
    block's O and LSE (``save_flash``) instead of replaying the forward
    kernel gives the same gradients to the bit, with half the forwards, all
    on the tensor-core route."""
    rng = torch.Generator().manual_seed(5)
    x = torch.randint(0, 128, (2, 64), generator=rng).to(cuda)
    y = torch.roll(x, -1, dims=1)
    gpu = _small_gpt(cuda, torch.bfloat16)
    grads, fwd = {}, {}
    for policy in (None, "save_flash"):
        gpu.cfg.recompute_policy = policy
        gpu.zero_grad(set_to_none=True)
        K.reset_launch_counts()
        gpu.forward_with_loss(x, y).backward()
        fwd[policy] = dict(K.flash_attention_fwd.route_launches)
        grads[policy] = {k: p.grad.clone() for k, p in gpu.named_parameters()}
    assert fwd == {None: {"wgmma": 4, "cuda_cores": 0},
                   "save_flash": {"wgmma": 2, "cuda_cores": 0}}
    assert all(torch.equal(grads[None][k], grads["save_flash"][k])
               for k in grads[None])


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """Two AdamW steps (clip, accumulation 2, recompute) on the card and on
    the CPU from the same fp32 weights: losses to 1e-5, and the updates in
    L2, to 1e-2 over the model and per tensor. The K third of each qkv
    bias is set apart: its true gradient is zero (softmax is
    shift-invariant along a row), so both sides step rounding noise, and
    Adam moves such an entry by up to lr per step in whichever direction
    the noise points; it is held to that bound, 2 * 2 * lr."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    models = {"card": _small_gpt(cuda), "cpu": _small_gpt("cpu")}
    p0 = {k: p.detach().clone() for k, p in models["cpu"].named_parameters()}
    steps = {side: make_sharded_train_step(
        m, AdamW(learning_rate=1e-3, parameters=m.named_parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0)),
        accumulate_steps=2, device=m.device) for side, m in models.items()}
    rng = torch.Generator().manual_seed(4)
    K.reset_launch_counts()
    for _ in range(2):
        x = torch.randint(0, 128, (4, 64), generator=rng)
        y = torch.roll(x, -1, dims=1)
        assert abs(float(steps["card"](x, y)) - float(steps["cpu"](x, y))) \
            <= 1e-5
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in (
        "fused_layer_norm", "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "fused_adamw_update"))
    cpu_params = dict(models["cpu"].named_parameters())
    cfg = models["cpu"].cfg
    k_part = slice(cfg.num_heads * cfg.head_dim,
                   (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim)
    num = den = 0.0
    for k, p in models["card"].named_parameters():
        dg, dc = p.detach().cpu() - p0[k], cpu_params[k].detach() - p0[k]
        if k.endswith("attn.qkv.bias"):
            assert _err(dg[k_part], dc[k_part]) <= 2 * 2 * 1e-3, k
            dg[k_part] = dc[k_part] = 0
        assert (dg - dc).norm() <= 1e-2 * dc.norm(), k
        num, den = num + (dg - dc).square().sum(), den + dc.square().sum()
    assert num <= 1e-4 * den


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 77, 2048), (5, 100)])
def test_rms_norm_kernel_matches_plain(cuda, dtype, shape):
    """Forward: one launch, within one bf16 rounding step (|y| < 8: 2^-5)
    of ``rms_norm_ref``. Backward through ``nn.RMSNorm``: one launch of the
    backward kernel, dx and dw within ``_grad_tol`` of ``rms_norm_bwd_ref``
    from the same x."""
    from paddle_tpu_torch.nn import RMSNorm

    g = torch.Generator(device=cuda).manual_seed(5)
    H = shape[-1]
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(H, generator=g, device=cuda)).to(dtype)
    before = K.fused_rms_norm.launches
    got = K.fused_rms_norm(x, w)
    assert K.fused_rms_norm.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 3.2e-2
    assert got.dtype == dtype and _err(got, K.rms_norm_ref(x, w)) <= tol
    layer = RMSNorm(H, device=cuda, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(w)
    xg = x.clone().requires_grad_()
    dy = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    before = K.rms_norm_bwd.launches
    layer(xg).backward(dy)
    assert K.rms_norm_bwd.launches == before + 1
    dx, dw = K.rms_norm_bwd_ref(x, w, dy)
    assert xg.grad.dtype == dx.dtype and _err(xg.grad, dx) <= _grad_tol(dx)
    assert _err(layer.weight.grad, dw) <= _grad_tol(dw)


def _grad_tol(ref):
    """A norm gradient's tolerance, relative to its largest entry: in bf16
    one rounding step of that entry (2^-7: the kernel's fp32 sums run in
    another order than the plain version's, so a value's rounding may
    flip); in fp32 1e-5 of it (dw and db sum up to 32768 rows, dx a row of
    up to 2050 values, in another order)."""
    step = 2 ** -7 if ref.dtype == torch.bfloat16 else 1e-5
    return step * ref.float().abs().max().item()


# forward, backward, their plain versions, eps
NORMS = {"layer_norm": (K.fused_layer_norm, K.layer_norm_bwd, K.layer_norm_ref,
                        K.layer_norm_bwd_ref, 1e-5),
         "rms_norm": (K.fused_rms_norm, K.rms_norm_bwd, K.rms_norm_ref,
                      K.rms_norm_bwd_ref, 1e-6)}


def _norm_case(cuda, norm, R, H, x_dtype, w_dtype=None, seed=0):
    """x [R, H] (the rows of the model's hidden states), the weight (and
    bias) near one, the output's gradient, and the parameters' tuple the
    forward takes."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w_dtype = w_dtype or x_dtype
    x = (torch.randn(R, H, generator=g, device=cuda) * 2 + 0.5).to(x_dtype)
    w = (1 + 0.1 * torch.randn(H, generator=g, device=cuda)).to(w_dtype)
    b = (0.1 * torch.randn(H, generator=g, device=cuda)).to(w_dtype)
    dy = torch.randn(R, H, generator=g, device=cuda).to(x_dtype)
    return x, ((w, b) if norm == "layer_norm" else (w,)), dy


def _check_norm(norm, x, params, dy, want_route, x_grad=True):
    """One forward and one backward launch, each on ``want_route``, through
    the autograd Function; the output within the forward's ``TOL`` (bf16:
    one rounding step of |y| < 8) and each gradient within ``_grad_tol`` of
    the plain versions. ``x_grad=False`` passes x itself (not a copy, which
    would be aligned anew), so only the parameters' gradients are read."""
    fwd, bwd, fwd_ref, bwd_ref, eps = NORMS[norm]
    xs = [x.clone().requires_grad_() if x_grad else x] + [
        t.clone().requires_grad_() for t in params]
    counts = [(w.launches, w.route_launches[want_route]) for w in (fwd, bwd)]
    y = fwd(*xs, eps)
    y.backward(dy)
    assert [(w.launches, w.route_launches[want_route]) for w in (fwd, bwd)] \
        == [(n + 1, r + 1) for n, r in counts]
    tol = 1e-4 if x.dtype == torch.float32 else 3.2e-2
    assert y.dtype == x.dtype and _err(y, fwd_ref(x, *params, eps)) <= tol
    for t, want in zip(xs, bwd_ref(x, params[0], dy, eps)):
        if not t.requires_grad:
            continue
        got = t.grad
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _err(got, want) <= _grad_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 3, 8, 231, 32768])
@pytest.mark.parametrize("H", [7, 100, 768, 2048, 2050])
def test_norm_kernels_match_plain(cuda, norm, dtype, R, H):
    """Forward and backward of both norms against their plain versions on
    both routes: the warp route where H is a multiple of the 16-byte vector
    and at most 2048, the block route elsewhere (H 7 and 2050, and bf16 at
    H 100), at one row, decode's 8 and the training slice's 32768."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    route = "warp" if H % vec == 0 and H <= 2048 else "block"
    _check_norm(norm, *_norm_case(cuda, norm, R, H, dtype), route)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_norm_kernels_take_mixed_dtypes(cuda, norm, x_dtype, w_dtype):
    """x in one dtype and the weight in the other (a user's fp32 RMSNorm on
    bf16 states): y and dx in x's dtype, dw (and db) in the weight's."""
    _check_norm(norm, *_norm_case(cuda, norm, 231, 2048, x_dtype, w_dtype),
                "warp")


@pytest.mark.gpu
@pytest.mark.parametrize("norm", sorted(NORMS))
def test_norm_unaligned_rows_take_the_block_route(cuda, norm):
    """Rows that start 2 bytes past a 16-byte boundary cannot be read in
    vectors: the same values take the block route, forward and backward
    (dx is read from the backward's own call)."""
    x, params, dy = _norm_case(cuda, norm, 8, 2048, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xo = buf[1:].view_as(x)
    xo.copy_(x)
    assert xo.is_contiguous() and xo.data_ptr() % 16
    _check_norm(norm, xo, params, dy, "block", x_grad=False)
    _, bwd, _, bwd_ref, eps = NORMS[norm]
    before = bwd.route_launches["block"]
    dx = bwd(xo, params[0], dy, eps)[0]
    assert bwd.route_launches["block"] == before + 1
    want = bwd_ref(x, params[0], dy, eps)[0]
    assert _err(dx, want) <= _grad_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("R,H", [(32768, 2048), (231, 2050)])
def test_norm_bwd_is_deterministic(cuda, norm, R, H):
    """A fixed grid, fixed rows per block and no atomics: two backward
    calls give dx, dw (and db) equal to the bit, on both routes."""
    bwd = NORMS[norm][1]
    x, params, dy = _norm_case(cuda, norm, R, H, torch.bfloat16)
    first, second = (bwd(x, params[0], dy) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_norm_wrappers_refuse_what_no_kernel_takes(cuda):
    """float16 rows, a weight of another length or device, a bias in
    another dtype than the weight, a gradient unlike x: each raises."""
    x = torch.zeros(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="unsupported dtypes"):
        K.fused_rms_norm(x.half(), w)
    with pytest.raises(ValueError, match="weight must be"):
        K.fused_layer_norm(x, w[:32], w[:32])
    with pytest.raises(ValueError, match="weight must be"):
        K.fused_rms_norm(x, w.cpu())
    with pytest.raises(ValueError, match="bias is"):
        K.fused_layer_norm(x, w, w.bfloat16())
    with pytest.raises(ValueError, match="gradient must be like x"):
        K.layer_norm_bwd(x, w, x.bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(130,), (3, 5, 7), (64, 1000)], ids=str)
def test_elementwise_primitive_matches_plain(cuda, dtype, shape):
    """``x + a * tanh(y)``: one launch, to one rounding step of the output
    dtype (the kernel's tanh and contractions differ from PyTorch's by an
    ulp of fp32)."""
    from paddle_tpu_torch.kernels import primitive as P

    op = P.elementwise_kernel(lambda x, y, a: x + a * torch.tanh(y))
    g = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn(*shape, generator=g, device=cuda).to(dtype)
          for _ in range(3)]
    before = P.elementwise_kernel.launches
    got = op(*xs)
    assert P.elementwise_kernel.launches == before + 1
    want = P.elementwise_ref(lambda x, y, a: x + a * torch.tanh(y), *xs)
    step = 2 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert got.dtype == dtype and got.shape == xs[0].shape
    assert _err(got, want) <= step * max(1.0, want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1280), (5, 33), (3, 4, 2048)], ids=str)
def test_row_reduce_primitive_matches_plain(cuda, dtype, shape):
    """Row sums to fp32 summation order (then one rounding step of the
    output dtype) and row maxima exactly, against ``row_reduce_ref``, which
    walks the same column blocks."""
    from paddle_tpu_torch.kernels import primitive as P

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    fns = {"sum": (lambda acc, b: acc + b.sum(-1), 0.0),
           "max": (lambda acc, b: torch.maximum(acc, b.amax(-1)),
                   float("-inf"))}
    for name, (fn, init) in fns.items():
        before = P.row_reduce_kernel.launches
        got = P.row_reduce_kernel(fn, init)(x)
        assert P.row_reduce_kernel.launches == before + 1
        want = P.row_reduce_ref(fn, init, x)
        assert got.dtype == dtype and got.shape == want.shape
        if name == "max":
            assert torch.equal(got, want)
        else:
            step = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
            assert _err(got, want) <= step * max(
                1.0, want.float().abs().max().item())


@pytest.mark.gpu
def test_scaled_step_skips_on_card(cuda):
    """A train step whose scaled gradients are non-finite (an infinite
    scale) skips its update on the card: parameters and AdamW's state stay
    bitwise as they were, the kernels of the backward still ran, and the
    next step, at a finite scale, trains."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.optimizer import AdamW

    model = _small_gpt(cuda)
    scaler = GradScaler(init_loss_scaling=float("inf"))
    step = make_sharded_train_step(model, AdamW(
        learning_rate=1e-3, parameters=model.named_parameters()),
        scaler=scaler, device=cuda)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    m0 = {k: s["moment1"].clone() for k, s in step.optimizer.state.items()}
    rng = torch.Generator().manual_seed(8)
    x = torch.randint(0, 128, (2, 64), generator=rng)
    y = torch.roll(x, -1, dims=1)
    K.reset_launch_counts()
    loss = step(x, y)
    assert not torch.isfinite(loss)
    assert K.launch_counts()["flash_attention_bwd_dq"] > 0
    assert K.launch_counts()["fused_adamw_update"] == 0
    for k, p in model.named_parameters():
        assert torch.equal(p, p0[k]), k
        assert torch.equal(step.optimizer.state[k]["moment1"], m0[k]), k
    assert scaler._bad_steps == 0 and scaler._good_steps == 0
    scaler.set_init_loss_scaling(2.0 ** 10)
    assert torch.isfinite(step(x, y))
    assert not all(torch.equal(p, p0[k]) for k, p in model.named_parameters())
