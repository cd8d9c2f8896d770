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
    assert all(n > 0 for n in K.launch_counts().values())
    want = Engine(cpu, EngineConfig(max_batch_size=2, max_seq_len=64),
                  device="cpu").generate(prompts, sp)
    assert got == want
