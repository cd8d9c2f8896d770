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
    # |y| < 8: bf16 may differ by one rounding step (2^-5)
    tol = 1e-4 if dtype == torch.float32 else 3.2e-2
    assert got.dtype == dtype and _err(got, K.layer_norm_ref(x, w, b)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hkv,D,causal", [(200, 16, 128, True),
                                            (130, 4, 128, False),
                                            (64, 8, 64, True)])
def test_flash_kernel_matches_plain(cuda, dtype, S, Hkv, D, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, S, 16, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, S, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, S, Hkv, D, generator=g, device=cuda).to(dtype)
    before = K.flash_attention_fwd.launches
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    assert K.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=causal)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= 1e-3


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
                                            (64, 8, 64, True)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, S, Hkv, D, causal):
    """dq (one launch) and dk/dv (one launch, GQA summed over the group)
    against ``flash_attention_bwd_ref`` from the forward kernel's O and
    LSE. bf16: outputs of |d| < 8 differ by at most one rounding step
    (2^-5)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(2, S, 16, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, S, Hkv, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    before = (K.flash_attention_bwd_dq.launches,
              K.flash_attention_bwd_dkv.launches)
    got = K.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert (K.flash_attention_bwd_dq.launches,
            K.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 3.2e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _err(a, b) <= tol


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
