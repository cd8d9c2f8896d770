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


def _paged_case(cuda, dtype, Hkv, rep, D, ps, nb, positions, seed=0):
    """q, pools of B * nb + 1 pages, a table and positions: slot b's live
    pages are distinct random pool pages and the rest of its row is -1; a
    slot at position 0 has an all-sentinel row (an empty slot)."""
    rng = np.random.default_rng(seed)
    B = len(positions)
    P = B * nb + 1
    kp, vp = (torch.from_numpy(rng.standard_normal((P, Hkv, ps, D)))
              .to(dtype).to(cuda) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, 1, D))) \
        .to(dtype).to(cuda)
    return (q, kp, vp) + _paged_table(cuda, rng, P, ps, nb, positions)


def _paged_table(cuda, rng, P, ps, nb, positions):
    perm = rng.permutation(P - 1) + 1
    table = np.full((len(positions), nb), -1, np.int32)
    used = 0
    for b, p in enumerate(positions):
        n = min(p // ps + 1, nb) if p else 0
        table[b, :n] = perm[used:used + n]
        used += n
    return (torch.from_numpy(table).to(cuda),
            torch.tensor(positions, dtype=torch.int32, device=cuda))


def _paged_module():
    import importlib

    return importlib.import_module("paddle_tpu_torch.kernels.paged_attention")


def _paged_plan(cuda, args):
    """The wrapper's launch plan for these inputs."""
    q, kp, vp, table, _ = args
    _, Hq, _, D = q.shape
    _, Hkv, ps, _ = kp.shape
    return _paged_module().plan(Hq, Hkv, ps, table.shape[1], D,
                                q.element_size(),
                                (kp.data_ptr(), vp.data_ptr()))


def _check_paged(args, route):
    """One launch on ``route``, within ``TOL`` of the plain version."""
    before = (K.paged_attention.launches,
              K.paged_attention.route_launches[route])
    got = K.paged_attention(*args)
    assert (K.paged_attention.launches,
            K.paged_attention.route_launches[route]) == \
        (before[0] + 1, before[1] + 1)
    want = K.paged_attention_ref(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert _err(got, want) <= TOL[got.dtype]
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_kernel_at_split_edges(cuda, dtype, rep, D, ps):
    """Positions on either side of the second split's first token
    (PPS * ps - 1, PPS * ps, PPS * ps + 1, with the splits of the serving
    path: 64 tokens), one live page, a slot that fills its whole table and
    an empty slot, on the vector route."""
    nb = 384 // ps
    edge = _paged_module().SPLIT_TOKENS
    positions = [0, edge - 1, edge, edge + 1, ps - 1, nb * ps - 1]
    args = _paged_case(cuda, dtype, 2, rep, D, ps, nb, positions)
    plan = _paged_plan(cuda, args)
    assert plan.route == "vector" and plan.pages_per_split * ps == edge
    _check_paged(args, "vector")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,rep,route", [
    (torch.bfloat16, 20, 4, "scalar"), (torch.float32, 18, 1, "scalar"),
    (torch.bfloat16, 80, 2, "vector"), (torch.float32, 256, 4, "vector"),
    (torch.bfloat16, 256, 8, "vector"), (torch.bfloat16, 320, 2, "scalar"),
    (torch.float32, 64, 12, "vector"), (torch.bfloat16, 128, 3, "vector")])
def test_paged_kernel_other_widths(cuda, dtype, D, rep, route):
    """Heads off the vector route (bf16 D 20, fp32 D 18, D > 256), a
    vector row of 10 chunks (bf16 D 80), two chunks a lane (fp32 D 256),
    and rep 12 (two head tiles) and 3 (a partly empty tile)."""
    args = _paged_case(cuda, dtype, 2, rep, D, 16, 12,
                       [0, 5, 16, 100, 191, 47])
    assert _paged_plan(cuda, args).route == route
    _check_paged(args, route)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_unaligned_pools_take_the_scalar_route(cuda, dtype):
    """Pools that start 4 bytes past a 16-byte boundary cannot be read in
    16-byte copies: the same values take the scalar route."""
    args = _paged_case(cuda, dtype, 2, 4, 128, 16, 8, [0, 17, 127, 64])
    moved = []
    for pool in args[1:3]:
        buf = torch.empty(pool.numel() + 2, dtype=dtype, device=cuda)
        view = buf[4 // pool.element_size():][:pool.numel()].view_as(pool)
        view.copy_(pool)
        assert view.is_contiguous() and view.data_ptr() % 16
        moved.append(view)
    got = _check_paged((args[0], *moved, *args[3:]), "scalar")
    assert _err(got, K.paged_attention(*args)) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 33])
def test_paged_kernel_batch_sizes(cuda, dtype, B):
    """One slot at the last token of a 128-page table (the long-context
    decode), and 33 slots at random positions with an empty one."""
    nb, ps = (128, 16) if B == 1 else (32, 16)
    rng = np.random.default_rng(B)
    positions = [nb * ps - 1] if B == 1 else \
        [0] + rng.integers(1, nb * ps, B - 1).tolist()
    _check_paged(_paged_case(cuda, dtype, 4, 2, 128, ps, nb, positions),
                 "vector")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_deterministic(cuda, dtype):
    """Splits merged in a fixed order, no atomics: two calls agree to the
    bit, and with the plain version."""
    args = _paged_case(cuda, dtype, 4, 4, 128, 16, 64,
                       [1023, 700, 0, 333, 64, 1000, 129, 511])
    assert _paged_plan(cuda, args).n_splits > 1
    first = _check_paged(args, "vector")
    assert torch.equal(first, K.paged_attention(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """The launch shape depends on static shapes only and the wrapper reads
    nothing on the host: a captured call, replayed after q, the positions
    and the table are rewritten in place, equals the eager call on the new
    values."""
    nb, ps = 64, 16
    args = _paged_case(cuda, dtype, 4, 2, 128, ps, nb,
                       [0, 17, 1023, 300, 64, 5])
    q, kp, vp, table, pos = args
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        K.paged_attention(*args)  # builds and loads before the capture
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.paged_attention(*args)
    rng = np.random.default_rng(7)
    new_table, new_pos = _paged_table(cuda, rng, kp.shape[0], ps, nb,
                                      [900, 0, 15, 16, 1023, 511])
    table.copy_(new_table)
    pos.copy_(new_pos)
    q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)))
            .to(dtype))
    graph.replay()
    torch.cuda.synchronize(cuda)
    want = K.paged_attention(*args)
    assert torch.equal(out, want)
    assert _err(out, K.paged_attention_ref(*args)) <= TOL[dtype]


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


# the (param, grad, moments) dtype combinations the fused AdamW takes
ADAMW_COMBOS = [(pd, gd, md) for pd in (torch.float32, torch.bfloat16)
                for gd in (torch.float32, torch.bfloat16)
                for md in (torch.float32, torch.bfloat16)
                if gd == pd or gd == torch.bfloat16]


def _adamw_leaf(gen, shape, pd, gd, md):
    p, g, m, v = (torch.randn(shape, generator=gen, device=gen.device)
                  for _ in range(4))
    return [p.to(pd), g.to(gd), (0.1 * m).to(md), (0.1 * v).abs().to(md)]


@pytest.mark.gpu
def test_adamw_multi_launch_matches_plain_bitwise(cuda):
    """One ``fused_adamw_multi`` call over the six dtype combinations, each
    at sizes 0, 33, 65553 and 2048 x 8192 and as dim-0 slice views of a
    leaf (rows 2:4 of [4, 2048], 16-byte aligned; row 1 of [3, 5], not),
    with per-tensor learning rates, decays and step powers and a bf16 copy
    beside every other fp32 param: one launch per combination, every
    output (the copies too) bitwise ``adamw_ref``, the leaves' other rows
    untouched."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    entries, leaves, aligned = [], [], set()
    for combo in ADAMW_COMBOS:
        for n in (0, 33, 65553, (2048, 8192)):
            entries.append(_adamw_leaf(gen, n, *combo))
        for shape, part in (((4, 2048), slice(2, 4)), ((3, 5), slice(1, 2))):
            leaf = _adamw_leaf(gen, shape, *combo)
            leaves.append((leaf, [t.clone() for t in leaf], part))
            entries.append([t[part] for t in leaf])
            aligned.add(all(t.data_ptr() % 16 == 0 for t in entries[-1]))
    assert aligned == {True, False}
    lows = [p.to(torch.bfloat16) if p.dtype == torch.float32 and i % 2
            else None for i, (p, *_) in enumerate(entries)]
    hp = [dict(lr=1e-3 * (1 + i % 3), weight_decay=0.01 * (i % 2),
               beta1_pow=0.9 ** (1 + i % 4), beta2_pow=0.999 ** (1 + i % 4))
          for i in range(len(entries))]
    want = [K.adamw_ref(*e, beta1=0.9, beta2=0.999, eps=1e-8, **h)
            for e, h in zip(entries, hp)]
    before = K.fused_adamw_multi.launches
    K.fused_adamw_multi(*zip(*entries), beta1=0.9, beta2=0.999, eps=1e-8,
                        low=lows, **{k: [h[k] for h in hp] for k in hp[0]})
    assert K.fused_adamw_multi.launches == before + len(ADAMW_COMBOS)
    for (p, _, m, v), low, w in zip(entries, lows, want):
        for a, b in zip((p, m, v), w):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if low is not None:
            assert torch.equal(low, w[0].to(torch.bfloat16))
    for leaf, whole, part in leaves:
        for a, b in zip(leaf, whole):
            assert torch.equal(a[:part.start], b[:part.start])
            assert torch.equal(a[part.stop:], b[part.stop:])


@pytest.mark.gpu
@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_grouped_optimizer_step_equals_the_per_tensor_path(cuda, moments):
    """AdamW's grouped ``apply_gradients`` on the card (bf16 parameters
    with fp32 masters, an ``lr_ratio`` and an ``apply_decay_param_fun``)
    against the same steps tensor by tensor through ``fused_adamw_update``
    and a ``copy_`` of each master: parameters, masters, moments and step
    powers bitwise equal after 3 steps, one launch a step, no copy."""
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator(device=cuda).manual_seed(6)
    shapes = [(256, 768), (768,), (33,), (5, 7)]
    params = [torch.randn(sh, generator=gen, device=cuda).to(torch.bfloat16)
              for sh in shapes]
    grads = [[torch.randn(sh, generator=gen, device=cuda).to(torch.bfloat16)
              for sh in shapes] for _ in range(3)]
    named = {f"w{i}": p.clone() for i, p in enumerate(params)}
    opt = AdamW(learning_rate=1e-3, parameters=named, multi_precision=True,
                moment_dtype=moments, lr_ratio=lambda n: 0.5 if n == "w1"
                else 1.0, apply_decay_param_fun=lambda n: n != "w2")
    masters = [p.float() for p in params]
    mdt = torch.bfloat16 if moments else torch.float32
    mom = [[torch.zeros(sh, dtype=mdt, device=cuda) for sh in shapes]
           for _ in range(2)]
    K.reset_launch_counts()
    copies0 = opt.master_copies
    b1p = b2p = np.float32(1)
    for gs in grads:
        for p, g in zip(named.values(), gs):
            p.grad = g
        opt.step()
        b1p, b2p = b1p * np.float32(0.9), b2p * np.float32(0.999)
        for i, g in enumerate(gs):
            K.fused_adamw_update(
                masters[i], g, mom[0][i], mom[1][i],
                lr=1e-3 * (0.5 if i == 1 else 1.0), beta1=0.9, beta2=0.999,
                eps=1e-8, weight_decay=0.0 if i == 2 else 0.01,
                beta1_pow=b1p, beta2_pow=b2p)
            params[i].copy_(masters[i])
    assert K.fused_adamw_multi.launches == 3 and opt.master_copies == copies0
    for i, (name, p) in enumerate(named.items()):
        s = opt.state[name]
        assert torch.equal(p, params[i]) and torch.equal(
            s["master_weight"], masters[i])
        assert torch.equal(s["moment1"], mom[0][i])
        assert torch.equal(s["moment2"], mom[1][i])
        assert (s["beta1_pow"], s["beta2_pow"]) == (b1p, b2p)


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
        "flash_attention_bwd_dkv", "fused_adamw_multi"))
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
    assert K.launch_counts()["fused_adamw_multi"] == 0
    assert K.launch_counts()["fused_adamw_update"] == 0
    for k, p in model.named_parameters():
        assert torch.equal(p, p0[k]), k
        assert torch.equal(step.optimizer.state[k]["moment1"], m0[k]), k
    assert scaler._bad_steps == 0 and scaler._good_steps == 0
    scaler.set_init_loss_scaling(2.0 ** 10)
    assert torch.isfinite(step(x, y))
    assert not all(torch.equal(p, p0[k]) for k, p in model.named_parameters())


# ---------------- the serving engine's captured steps -----------------------
def _serving_gpt(device, dtype=torch.float32, seed=0):
    """A small GQA GPT whose weights (std 0.2) make greedy tokens vary."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=64,
                    initializer_range=0.2)
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    return m.to(device=device, dtype=dtype)


def _shared_prefix_prompts(seed):
    """Five prompts: a 16-token shared prefix and distinct suffixes, two of
    them a repeated 4-token phrase, one prompt without the prefix."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 128, 16).tolist()
    phrase = rng.integers(1, 128, 4).tolist()
    return [pre + rng.integers(1, 128, 5).tolist(), pre + phrase * 3,
            rng.integers(1, 128, 11).tolist(),
            pre + rng.integers(1, 128, 9).tolist(),
            pre + phrase * 2 + rng.integers(1, 128, 2).tolist()]


def _engine(model, device, **opts):
    from paddle_tpu_torch.serving import Engine, EngineConfig

    return Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64,
                                      page_size=8, **opts), device=device,
                  generator=torch.Generator(device=device).manual_seed(5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("program", ["decode", "verify"])
def test_step_graph_replay_equals_the_eager_step(cuda, dtype, program):
    """Mid-run, a replay of the engine's captured step and its eager
    function on the same buffers: identical tokens, logits within TOL
    (another GEMM algorithm under capture would change the summation
    order only)."""
    from paddle_tpu_torch.serving import SamplingParams

    opts = dict(speculative=3) if program == "verify" else {}
    eng = _engine(_serving_gpt(cuda, dtype), cuda, **opts)
    for p in _shared_prefix_prompts(1)[:2]:
        eng.add_request(p, SamplingParams(max_new_tokens=40))
    for _ in range(3):
        eng.step()
    step = eng.steps[program]
    assert step.captures == 1
    step.replay()
    g_tok, g_logits = (t.clone() for t in step.outputs)
    e_tok, e_logits = step.fn()
    assert torch.equal(g_tok, e_tok)
    assert _err(g_logits, e_logits) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(prefix_cache=True),
                                  dict(prefix_cache=True, speculative=3)])
def test_one_capture_per_program_and_tokens_match_cpu(cuda, opts):
    """Admissions, prefix splices, finishes, a forced copy-on-write and a
    second generate: each program is captured once for the engine's
    lifetime, the per-token kernels run inside it, and the greedy tokens
    equal those of the CPU engine (plain versions) on the same weights."""
    from paddle_tpu_torch.serving import SamplingParams

    prompts = _shared_prefix_prompts(2)
    sp = SamplingParams(max_new_tokens=12)
    program = "verify" if "speculative" in opts else "decode"
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = _engine(_serving_gpt(dev), dev, **opts)
        K.reset_launch_counts()
        first = eng.generate(prompts[:3], sp)
        req = eng.add_request(prompts[3], SamplingParams(max_new_tokens=20))
        eng.step()
        assert req.prefix_hit_blocks == 2
        shared = int(eng.cache.page_table[req.slot, 0])
        assert eng._ensure_writable(req.slot, 0, owner="cow-test")
        assert int(eng.cache.page_table[req.slot, 0]) != shared
        while eng.has_unfinished:
            eng.step()
        outs[dev.type] = (first, req.output_ids,
                          eng.generate(prompts[3:], sp))
        if dev.type == "cuda":
            assert program in eng.steps and not (
                set(eng.steps) - {program} - _bucket_programs(eng))
            assert all(st.captures == 1 for st in eng.steps.values())
            counts = K.launch_counts()
            assert counts["fused_layer_norm"] > 0
            assert counts["flash_attention_fwd"] > 0
            if program == "decode":
                assert counts["paged_attention"] > 0
        eng.prefix_cache.clear()
        assert eng.page_alloc.num_free == eng.page_alloc.num_allocatable
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.gpu
def test_sampled_draws_repeat_across_engines_not_across_replays(cuda):
    """Two engines on the same seed draw the same sampled tokens through
    their graphs; consecutive replays of one graph on fixed buffers draw
    new numbers from the registered generator."""
    from paddle_tpu_torch.serving import SamplingParams

    prompts = _shared_prefix_prompts(3)[:3]
    sps = [SamplingParams(max_new_tokens=10, do_sample=True,
                          temperature=1.5, top_k=k) for k in (0, 20, 0)]
    model = _serving_gpt(cuda)
    runs = [_engine(model, cuda).generate(prompts, sps) for _ in range(2)]
    assert runs[0] == runs[1]
    eng = _engine(model, cuda)
    eng.generate(prompts[:1], sps[:1])
    step = eng.steps["decode"]
    step.buffers.greedy.fill_(False)
    step.buffers.temps.fill_(100.0)  # near uniform over 128 tokens
    draws = []
    for _ in range(8):
        step.replay()
        draws.append(tuple(step.outputs[0].tolist()))
    assert len(set(draws)) > 4


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [{}, dict(speculative=2)])
def test_load_weights_after_capture_serves_the_new_weights(cuda, opts):
    """``load_weights`` copies into the parameters the captured graph
    reads: the engine then serves what a fresh engine on the new weights
    serves, with no second capture."""
    from paddle_tpu_torch.serving import SamplingParams

    prompts = _shared_prefix_prompts(4)[:3]
    sp = SamplingParams(max_new_tokens=8)
    eng = _engine(_serving_gpt(cuda, seed=0), cuda, **opts)
    before = eng.generate(prompts, sp)
    new = _serving_gpt(cuda, seed=1)
    want = _engine(new, cuda, **opts).generate(prompts, sp)
    assert want != before
    eng.load_weights(new.state_dict())
    assert eng.generate(prompts, sp) == want
    assert all(s.captures == 1 for s in eng.steps.values())


# ---------------- per-bucket prefill and extend, the dense layout ----------
def _bucket_programs(eng):
    return {f"{kind}:{T}" for kind in ("prefill", "extend")
            for T in eng.config.prefill_buckets}


def _pools(eng):
    """Copies of the K/V buffers; paged, without the trash page 0, where
    writes past a slot's pages collide in no set order."""
    first = 1 if eng.page_alloc is not None else 0
    return eng.cache.k[:, first:].clone(), eng.cache.v[:, first:].clone()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_prefill_and_extend_graphs_equal_the_eager_call(cuda, dtype, layout):
    """After a run, each bucket program's replay and its eager function on
    the same buffers: the logits and the whole written K/V bitwise
    equal."""
    from paddle_tpu_torch.serving import SamplingParams

    opts = dict(prefix_cache=True) if layout == "paged" \
        else dict(kv_layout="dense")
    eng = _engine(_serving_gpt(cuda, dtype), cuda, **opts)
    eng.generate(_shared_prefix_prompts(6), SamplingParams(max_new_tokens=4))
    names = [n for n in eng.steps if ":" in n]
    assert any(n.startswith("prefill") for n in names)
    assert any(n.startswith("extend") for n in names) == (layout == "paged")
    for name in names:
        step = eng.steps[name]
        step.replay()
        g_logits, g_pools = step.outputs[0].clone(), _pools(eng)
        e_logits = step.fn()[0]
        torch.cuda.synchronize()
        assert torch.equal(g_logits, e_logits), name
        assert all(torch.equal(a, b) for a, b in zip(g_pools, _pools(eng))), \
            name


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [{}, dict(prefix_cache=True),
                                  dict(kv_layout="dense")])
def test_one_capture_per_bucket_and_tokens_match_cpu(cuda, opts):
    """Two generates over prompts of three buckets: every program is
    captured once for the engine's lifetime and replayed after, nothing
    runs eagerly on the card, and the greedy tokens equal the CPU
    engine's on the same weights."""
    from paddle_tpu_torch.serving import SamplingParams

    prompts = _shared_prefix_prompts(7)
    sp = SamplingParams(max_new_tokens=6)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = _engine(_serving_gpt(dev), dev, **opts)
        outs[dev.type] = [eng.generate(prompts, sp) for _ in range(2)]
        if dev.type == "cuda":
            buckets = {n for n in eng.steps if ":" in n}
            assert buckets and buckets <= _bucket_programs(eng)
            assert all(st.captures == 1 for st in eng.steps.values())
            # with the prefix cache the second pass hits: extends instead
            assert all(st.replays >= 1 + (not opts.get("prefix_cache"))
                       for n, st in eng.steps.items() if n in buckets)
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_captures_leave_live_slots_unchanged(cuda, dtype):
    """Dense layout: a prefill captured for a new slot while another slot
    is live leaves every other row's K/V bitwise unchanged; the decode
    step captured with two live slots leaves each row's positions before
    its own write, and every idle row but position 0, unchanged."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    eng = Engine(_serving_gpt(cuda, dtype), EngineConfig(
        max_batch_size=3, max_seq_len=64, kv_layout="dense"), device=cuda)
    prompts = _shared_prefix_prompts(8)
    eng.add_request(prompts[2], SamplingParams(max_new_tokens=8))  # 11: T 16
    eng._admit()
    before = _pools(eng)
    eng.add_request(prompts[1], SamplingParams(max_new_tokens=8))  # 28: T 32
    eng._admit()
    assert {n: s.captures for n, s in eng.steps.items()} \
        == {"prefill:16": 1, "prefill:32": 1}
    after = _pools(eng)
    for a, b in zip(before, after):
        assert torch.equal(a[:, 0], b[:, 0]) and torch.equal(a[:, 2], b[:, 2])
    pos = eng._positions.copy()
    eng._decode()  # captures the decode step, then replays it
    assert eng.steps["decode"].captures == 1
    for a, b in zip(after, _pools(eng)):
        for slot in (0, 1):
            p = int(pos[slot])
            assert torch.equal(a[:, slot, :, :p], b[:, slot, :, :p])
            assert torch.equal(a[:, slot, :, p + 1:], b[:, slot, :, p + 1:])
        assert torch.equal(a[:, 2, :, 1:], b[:, 2, :, 1:])


@pytest.mark.gpu
def test_generate_captures_once_per_key_and_matches_cpu(cuda):
    """``generate`` on the card: the ids equal the CPU's (fp32); a second
    call with the same key replays without a new capture, whatever its
    eos and sampling settings; another key releases the first key's
    programs and captures its own."""
    model, cpu = _serving_gpt(cuda), _serving_gpt(torch.device("cpu"))
    ids = torch.tensor(_shared_prefix_prompts(9)[0][:12]).repeat(3, 1)
    ids[1:, 0] = torch.tensor([5, 7])
    got = model.generate(ids.to(cuda), max_new_tokens=10)
    assert torch.equal(got.cpu(), cpu.generate(ids, max_new_tokens=10))
    state = model._generate_state
    assert (state.prefill.captures, state.decode.captures) == (1, 1)
    again = model.generate(ids.to(cuda), max_new_tokens=10)
    assert torch.equal(again, got) and model._generate_state is state
    assert (state.prefill.captures, state.decode.captures) == (1, 1)
    assert (state.prefill.replays, state.decode.replays) == (2, 18)
    eos = int(got[0, 14])
    want = cpu.generate(ids, max_new_tokens=10, eos_token_id=eos)
    assert torch.equal(model.generate(ids.to(cuda), max_new_tokens=10,
                                      eos_token_id=eos).cpu(), want)
    assert model._generate_state is state  # eos is not part of the key
    model.generate(ids.to(cuda), max_new_tokens=10, do_sample=True, top_k=5)
    assert model._generate_state is state  # nor are the sampling settings
    assert torch.equal(model.generate(ids.to(cuda), max_new_tokens=10), got)
    assert (state.prefill.captures, state.decode.captures) == (1, 1)
    model.generate(ids[:2].to(cuda), max_new_tokens=4)
    assert model._generate_state is not state
    assert model._generate_state.prefill.captures == 1


@pytest.mark.gpu
def test_sampled_generate_draws_the_same_whether_captured_or_replayed(cuda):
    """The capture gives the warm-up's draws back to the generator: a first
    call (which captures) and a second (which replays) on the same seed
    return the same ids, and the caller's generator advances."""
    model = _serving_gpt(cuda)
    ids = torch.tensor(_shared_prefix_prompts(10)[2]).repeat(2, 1).to(cuda)
    kw = dict(max_new_tokens=12, do_sample=True, temperature=1.5, top_k=20)
    runs = []
    for _ in range(2):
        g = torch.Generator(device=cuda).manual_seed(3)
        state = g.get_state()
        runs.append(model.generate(ids, generator=g, **kw))
        assert not torch.equal(g.get_state(), state)
    assert model._generate_state.decode.captures == 1
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0][0], runs[0][1])  # rows draw apart



@pytest.mark.gpu
def test_a_failed_capture_raises(cuda):
    """A program that reads the card on the host cannot be captured: the
    capture raises, nothing runs it eagerly in its place, and the draws of
    its warm-up run are given back to its generator all the same."""
    from paddle_tpu_torch.serving.graphs import Buffers, CapturedStep

    gen = torch.Generator(device=cuda).manual_seed(2)
    before = gen.get_state()
    bufs = Buffers(x=torch.ones(4, device=cuda))
    step = CapturedStep(
        lambda: (torch.rand(4, device=cuda, generator=gen)
                 * float(bufs.x.sum()),), bufs, cuda, gen)
    with pytest.raises(RuntimeError):
        step.run()
    assert step.captures == 0 and step.outputs is None
    assert torch.equal(gen.get_state(), before)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_programs_share_one_pool_and_each_prefill_is_sampled_first(cuda,
                                                                  layout):
    """The engine captures its programs into one memory pool, where a
    replay may overwrite another program's outputs. Two requests of two
    buckets admitted in one step (two prefill replays back to back): each
    first token is the argmax of its own bucket's eager call on the
    request's inputs, so each prefill's logits were sampled before the
    next replay."""
    from paddle_tpu_torch.serving import SamplingParams

    opts = {} if layout == "paged" else dict(kv_layout="dense")
    eng = _engine(_serving_gpt(cuda), cuda, **opts)
    prompts = _shared_prefix_prompts(11)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=4))
            for p in (prompts[2], prompts[1])]  # 11 tokens: T 16; 28: T 32
    eng._admit()
    assert set(eng.steps) == {"prefill:16", "prefill:32"}
    assert eng._graph_pool is not None
    assert {st.pool for st in eng.steps.values()} == {eng._graph_pool}
    for req in reqs:
        n = len(req.prompt_ids)
        T = eng._bucket(n)
        ids = np.zeros((1, T), np.int64)
        ids[0, :n] = req.prompt_ids
        step = eng.steps[f"prefill:{T}"]
        step.buffers.write(ids=ids, length=np.array([n]),
                           row=eng._slot_row(req.slot))
        assert req.output_ids[0] == int(step.fn()[0].argmax(dim=-1)[0])


# ---------------- checkpoint and data on the card --------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_side_stream_copies_equal_a_blocking_copy(cuda, depth):
    """Pinned host buffers copied on a side stream, the consumer's stream
    waiting on each copy's event: every batch equals a blocking copy of the
    same host batch, also while the consumer's stream is busy and the
    pinned ring is reused many times over."""
    from paddle_tpu_torch.io import DevicePrefetcher

    rng = np.random.default_rng(depth)
    host = [{"tokens": rng.integers(0, 50304, (16, 2048)).astype(np.int32),
             "pos": rng.integers(0, 2048, (16, 2048)).astype(np.int32),
             "scale": np.float32(i)} for i in range(12)]
    big = torch.randn(4096, 4096, device=cuda)
    seen = 0
    for i, batch in enumerate(DevicePrefetcher(host, depth=depth,
                                               device=cuda)):
        big = big @ big.T / 4096.0  # keep the consumer's stream busy
        want = {k: torch.from_numpy(v).to(cuda)
                for k, v in host[i].items() if k != "scale"}
        assert batch["tokens"].device.type == "cuda"
        assert torch.equal(batch["tokens"] + 0, want["tokens"])
        assert torch.equal(batch["pos"] + 0, want["pos"])
        assert batch["scale"] == host[i]["scale"]
        seen += 1
    assert seen == len(host)


@pytest.mark.gpu
def test_restored_state_on_the_card_equals_the_saved_one(cuda, tmp_path):
    """A bf16 model with fp32 masters and bf16 moments on the card: its
    train step's state, saved and restored into a step built from other
    weights, equals the saved one bit for bit on the card."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    def build(seed):
        # head_dim 64: a width the card's flash kernels are built for
        cfg = GPTConfig(**{**GPT_TINY, "hidden_size": 128, "num_heads": 2})
        m = GPTForCausalLM(cfg, device=cuda,
                           dtype=torch.bfloat16,
                           generator=torch.Generator(cuda).manual_seed(seed))
        opt = AdamW(learning_rate=1e-3, parameters=m.named_parameters(),
                    multi_precision=True, moment_dtype="bfloat16")
        return make_sharded_train_step(m, opt, device=cuda)

    a = build(0)
    x = torch.randint(0, 128, (2, 64), device=cuda)
    for _ in range(2):
        a(x, torch.roll(x, -1, 1))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, a.state_for_checkpoint().to_tree())
    b = build(1)
    b.restore_from_checkpoint(mgr.restore())
    for name, p in a.params.items():
        assert torch.equal(p, b.params[name]), name
    for name, slots in a.optimizer.state.items():
        for k, v in slots.items():
            w = b.optimizer.state[name][k]
            if isinstance(v, torch.Tensor):
                assert w.device.type == "cuda" and w.dtype == v.dtype
                assert torch.equal(v, w), (name, k)
            else:
                assert v.tobytes() == w.tobytes(), (name, k)
    mgr.close()


# ---------------- GPT-MoE (one device) -------------------------------------
def _moe_gpt(device, dtype=torch.float32, seed=0, **over):
    """A small GPT-MoE (4 experts in block 1, std 0.2 weights) built on
    the CPU and moved, so the card and the CPU hold the same weights."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**{**dict(vocab_size=128, hidden_size=256, num_layers=2,
                              num_heads=4, num_kv_heads=2, max_seq_len=64,
                              initializer_range=0.2, moe_num_experts=4),
                       **over})
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    return m.to(device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_train_step_gives_every_parameter_a_gradient(cuda, dtype):
    """A MoE train step on the card (recompute on: the dense block through
    it, the MoE block outside) reaches every parameter, the gate and the
    stacked experts included; the loss is finite, and in fp32 it agrees
    with the CPU's to 1e-4."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.optimizer import AdamW

    rng = torch.Generator().manual_seed(4)
    x = torch.randint(0, 128, (2, 64), generator=rng)
    y = torch.roll(x, -1, dims=1)
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        m = _moe_gpt(dev, dtype if dev.type == "cuda" else torch.float32,
                     use_recompute=True)
        m.train()
        step = make_sharded_train_step(
            m, AdamW(learning_rate=1e-3, parameters=m.named_parameters()),
            device=dev)
        losses[dev.type] = float(step(x, y))
        missing = [k for k, p in m.named_parameters()
                   if p.grad is None or not torch.isfinite(p.grad).all()
                   or not p.grad.abs().max() > 0]
        assert not missing, (dev, missing)
        if dtype == torch.bfloat16:
            break
    if dtype == torch.float32:
        assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4, losses


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_decode_graph_equals_the_eager_step(cuda, dtype):
    """Mid-run, a replay of a MoE engine's captured decode step and its
    eager function on the same buffers: tokens, logits and every written
    page bitwise equal (the route reads nothing on the host, so it
    captures whole)."""
    from paddle_tpu_torch.serving import SamplingParams

    eng = _engine(_moe_gpt(cuda, dtype), cuda)
    for p in _shared_prefix_prompts(1)[:2]:
        eng.add_request(p, SamplingParams(max_new_tokens=40))
    for _ in range(3):
        eng.step()
    step = eng.steps["decode"]
    assert step.captures == 1
    step.replay()
    g_tok, g_logits = (t.clone() for t in step.outputs)
    g_pools = _pools(eng)
    e_tok, e_logits = step.fn()
    torch.cuda.synchronize()
    assert torch.equal(g_tok, e_tok)
    assert torch.equal(g_logits, e_logits)
    assert all(torch.equal(a, b) for a, b in zip(g_pools, _pools(eng)))


@pytest.mark.gpu
def test_moe_route_at_config5_makes_no_tec_tensor(cuda):
    """``moe_route`` at BASELINE config 5's T 8192, E 8, C 1280, d 1024 in
    bf16 (experts a scale, so the route alone is measured): forward and
    backward make no tensor of T * E * C elements, and their peak memory
    above the inputs stays under one fp32 [T, E, C] tensor (335 MB), where
    the dense routing holds two; the gradients are finite and the route
    deterministic."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import \
        moe_route

    T, E, d = 8192, 8, 1024
    C = max(1, int(1.25 * T / E))
    tec = T * E * C
    g = torch.Generator(device=cuda).manual_seed(0)
    x0 = torch.randn(T, d, generator=g, device=cuda).to(torch.bfloat16)
    w0 = (0.05 * torch.randn(d, E, generator=g, device=cuda)).to(
        torch.bfloat16)

    class Sizes(TorchDispatchMode):
        numels = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.numels.append(o.numel())
            return out

    def run(record=False):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mode = Sizes() if record else None
        if mode:
            mode.__enter__()
        out, aux = moe_route(x, w, "gshard", C, lambda e: e * 2)
        (out.float().square().sum() + aux).backward()
        if mode:
            mode.__exit__(None, None, None)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base, out.detach(),
                x.grad, w.grad, mode)

    peak, out, gx, gw, _ = run()
    assert peak < 4 * tec, (peak, 4 * tec)
    assert torch.isfinite(gx).all() and torch.isfinite(gw).all()
    _, out2, gx2, gw2, mode = run(record=True)
    assert tec not in mode.numels
    assert torch.equal(out, out2) and torch.equal(gx, gx2) \
        and torch.equal(gw, gw2)


@pytest.mark.gpu
def test_nccl_world_of_one_step_equals_the_no_mesh_step(cuda, tmp_path,
                                                        monkeypatch):
    """Data parallelism on the card at world size 1: ``fleet.init`` with a
    file-store master forms an NCCL group of one rank, and the step over
    its dp mesh all-reduces every gradient bucket, the loss and the
    scaler's flag through it. Two bf16 steps (a scaler, clip, fp32 master
    weights) equal the step without a mesh bit for bit: losses and every
    parameter."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    for var in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "MASTER_ADDR",
                "PADDLE_DISTRI_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PADDLE_MASTER", f"file://{tmp_path / 'store'}")
    rng = torch.Generator().manual_seed(5)
    x = torch.randint(0, 128, (2, 4, 64), generator=rng)
    y = torch.roll(x, -1, dims=2)
    runs = []
    dist.destroy_process_group()
    try:
        for use_mesh in (False, True):
            model = _small_gpt(cuda, torch.bfloat16)
            opt = AdamW(learning_rate=1e-3, multi_precision=True,
                        parameters=model.named_parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0))
            kw = dict(scaler=amp.GradScaler(init_loss_scaling=2.0 ** 10),
                      device=cuda)
            if use_mesh:
                fleet.init(is_collective=True)
                assert dist.get_backend() == "NCCL"
                kw["mesh"] = fleet.get_hybrid_communicate_group().get_mesh()
            step = fleet.make_sharded_train_step(model, opt, **kw)
            losses = [step(x[k], y[k]) for k in range(2)]
            runs.append((losses, {k: p.detach().clone()
                                  for k, p in model.named_parameters()}))
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


@pytest.mark.gpu
def test_mp_layers_over_an_nccl_group_of_one_rank(cuda, tmp_path,
                                                  monkeypatch):
    """The tensor-parallel layers on the card, over ``fleet.init``'s mp
    group of one rank (NCCL, file-store master): equal to the plain
    layers on the same weights bit for bit, forward and gradients, and
    their outputs carry a ``grad_fn``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

    for var in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "MASTER_ADDR",
                "PADDLE_DISTRI_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PADDLE_MASTER", f"file://{tmp_path / 'store'}")
    dist.destroy_process_group()
    try:
        fleet.init(is_collective=True)
        g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
        assert dist.get_backend() == "NCCL" and g.nranks == 1 \
            and g.process_group is not None
        gen = torch.Generator(device=cuda).manual_seed(3)
        x = torch.randn(2, 5, 16, device=cuda, generator=gen)
        ids = torch.randint(0, 32, (2, 5), device=cuda, generator=gen)
        layers = [ColumnParallelLinear(16, 24, mp_group=g, device=cuda),
                  RowParallelLinear(16, 8, mp_group=g, device=cuda),
                  VocabParallelEmbedding(32, 16, mp_group=g, device=cuda)]
        for layer, inp in zip(layers, (x, x, ids)):
            with torch.no_grad():
                for p in layer.parameters():
                    p.normal_(generator=gen)
            out = layer(inp)
            assert out.grad_fn is not None, type(layer).__name__
            w = layer.weight.detach().clone().requires_grad_()
            if isinstance(layer, VocabParallelEmbedding):
                want = torch.nn.functional.embedding(inp, w)
            else:
                b = layer.bias.detach().clone().requires_grad_()
                want = inp @ w + b
            assert torch.equal(out, want), type(layer).__name__
            out.square().sum().backward()
            want.square().sum().backward()
            assert torch.equal(layer.weight.grad, w.grad)
    finally:
        dist.destroy_process_group()


def _exchange_rank(rank, store, out_dir):
    """One of two ranks, each on its own card over NCCL: the count-routed
    exchange with the counts given and with them exchanged (None)."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed.collective import group_of
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        global_gather, global_scatter)

    torch.cuda.set_device(rank)
    tdist.init_process_group("nccl", init_method=f"file://{store}",
                             world_size=2, rank=rank)
    try:
        g = group_of([0, 1])
        counts = torch.tensor([[3, 0, 2, 5], [1, 4, 0, 2]])
        lc = counts[rank]
        gc = counts.reshape(2, 2, 2)[:, rank].reshape(-1)
        x = (torch.arange(int(lc.sum()) * 8, dtype=torch.float32)
             .view(-1, 8) + 1000 * rank).cuda()
        given = global_scatter(x, lc, gc, group=g)
        counted = global_scatter(x, lc.cuda(), None, group=g)
        back = global_gather(counted, lc, None, group=g)
        torch.cuda.synchronize()
        torch.save({"x": x.cpu(), "given": given.cpu(),
                    "counted": counted.cpu(), "back": back.cpu(),
                    "backend": tdist.get_backend()},
                   f"{out_dir}/out.{rank}.pt")
    finally:
        tdist.destroy_process_group()


@pytest.mark.gpu
def test_global_scatter_and_gather_over_nccl_across_two_cards(cuda,
                                                              tmp_path):
    """``global_scatter``/``global_gather`` between two ranks on two cards
    over NCCL: the counts, given or exchanged on the card, route each
    rank's chunks to their expert's rank, ordered local-expert major then
    source rank, and the gather returns every row to its source bit for
    bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    import torch.multiprocessing as mp

    mp.spawn(_exchange_rank, args=(str(tmp_path / "store"), str(tmp_path)),
              nprocs=2, join=True)
    outs = [torch.load(tmp_path / f"out.{r}.pt") for r in range(2)]
    counts = [[3, 0, 2, 5], [1, 4, 0, 2]]
    chunks = []  # chunks[s][i]: source s's rows for global expert i
    for s, out in enumerate(outs):
        starts = np.cumsum([0] + counts[s])
        chunks.append([out["x"][starts[i]:starts[i + 1]] for i in range(4)])
    for d, out in enumerate(outs):
        want = torch.cat([chunks[s][2 * d + e] for e in range(2)
                          for s in range(2)])
        assert out["backend"] == "nccl"
        assert torch.equal(out["given"], want), d
        assert torch.equal(out["counted"], want), d
        assert torch.equal(out["back"], out["x"]), d


def _reshard_cases(dev):
    """A global array per dtype and the moves a world of one rank takes
    (its meshes each of one rank): identity, a dimension split over a
    size-one axis, a segmented layout to a plain one, and a move the
    planner cannot express (the gather-and-slice path)."""
    from paddle_tpu_torch.distributed import DeviceMesh, NamedSharding
    from paddle_tpu_torch.distributed import PartitionSpec as P

    one = DeviceMesh([0], ("x",))
    g = torch.Generator(device=dev).manual_seed(4)
    arrays = {torch.float32: torch.randn(8, 12, generator=g, device=dev),
              torch.bfloat16: torch.randn(8, 12, generator=g,
                                          device=dev).to(torch.bfloat16),
              torch.int64: torch.randint(-2 ** 40, 2 ** 40, (8, 12),
                                         generator=g, device=dev)}
    moves = [(NamedSharding(one, P("x", None)),
              NamedSharding(DeviceMesh([0], ("y",)), P(None, "y"))),
             (NamedSharding(one, P(None, "x"), segments={1: (4, 4, 4)}),
              NamedSharding(one, P("x", None))),
             (NamedSharding(one, P(None, "x"), segments={1: (6, 3, 3)}),
              NamedSharding(one, P(None, "x"), segments={1: (4, 4, 4)}))]
    return arrays, moves


@pytest.mark.gpu
def test_reshard_over_one_nccl_rank(cuda, tmp_path, monkeypatch):
    """The resharding executor on CUDA blocks over an NCCL world of one
    rank: every move's block on the card, bitwise the global array's
    slice; the segments' mismatch taken by the counted gather-and-slice
    path; a checkpoint restored onto a sharded placement of two ranks
    (this rank's block, read from its byte ranges) and live from
    ``ShardedTensor`` blocks on the card, each bitwise the file's."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint import arrays as ck_arrays
    from paddle_tpu_torch.distributed import DeviceMesh, NamedSharding
    from paddle_tpu_torch.distributed import PartitionSpec as P
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import resharding as rs

    for var in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "MASTER_ADDR",
                "PADDLE_DISTRI_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PADDLE_MASTER", f"file://{tmp_path / 'store'}")
    dist.destroy_process_group()
    try:
        fleet.init(is_collective=True)
        assert dist.get_backend() == "NCCL"
        arrays, moves = _reshard_cases(cuda)
        for dtype, x in arrays.items():
            for src, dst in moves:
                rs.reset_stats()
                got = rs.reshard(rs.ShardedTensor(x.clone(), src), dst)
                assert got.block.is_cuda and got.block.dtype == dtype
                assert torch.equal(got.block, x), (dtype, src, dst)
                assert rs.stats()["assembled"] == int(
                    src.segments != dst.segments
                    and bool(dst.segments)), (src, dst)
        x = arrays[torch.bfloat16]
        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.save(1, {"w": x, "v": arrays[torch.int64]})
        mgr.wait_until_finished()
        two = DeviceMesh([0, 1], ("dp",))
        ck_arrays.reset_read_stats()
        split = NamedSharding(two, P(None, "dp"))
        tree = mgr.restore(shardings={"w": split, "v": None})
        # validated: each file the blocks overlap read whole
        assert ck_arrays.read_stats()["bytes"] == 8 * 12 * 2 + 8 * 12 * 8
        assert tree["w"].sharding == split
        assert torch.equal(tree["w"].block.cuda(), x[:, :6])
        ck_arrays.reset_read_stats()
        mgr.validate_on_restore = False  # the block's byte ranges alone
        tree = mgr.restore(shardings={"w": split, "v": None})
        assert ck_arrays.read_stats()["bytes"] == 8 * 6 * 2 + 8 * 12 * 8
        assert torch.equal(tree["w"].block.cuda(), x[:, :6])
        one = NamedSharding(DeviceMesh([0], ("dp",)), P("dp", None))
        live = mgr.restore(shardings={"w": one}, live_state={
            "w": rs.ShardedTensor(x, one)})
        # a mesh of one rank places the array whole: a plain tensor
        assert live["w"].is_cuda and torch.equal(live["w"], x)
        assert ck_arrays.read_stats()["live"] == 1
        mgr.close()
    finally:
        dist.destroy_process_group()


def _reshard_rank(rank, store, out_dir):
    """One of two ranks, each on its own card over NCCL: moves between
    two-rank layouts (all_to_all, a device-order permutation's
    send/recv, the segmented qkv layout), each block against the global
    array's slice."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import DeviceMesh, NamedSharding
    from paddle_tpu_torch.distributed import PartitionSpec as P
    from paddle_tpu_torch.distributed import resharding as rs

    torch.cuda.set_device(rank)
    tdist.init_process_group("nccl", init_method=f"file://{store}",
                             world_size=2, rank=rank)
    try:
        dev = torch.device("cuda", rank)
        x = torch.arange(8 * 16, dtype=torch.float32, device=dev).view(8, 16)
        mesh = DeviceMesh([0, 1], ("x",))
        back = DeviceMesh([1, 0], ("y",))
        moves = [(NamedSharding(mesh, P("x", None)),
                  NamedSharding(mesh, P(None, "x"))),
                 (NamedSharding(mesh, P("x", None)),
                  NamedSharding(back, P("y", None))),
                 (NamedSharding(mesh, P(None, "x"), segments={1: (8, 4, 4)}),
                  NamedSharding(mesh, P("x", None)))]
        out = []
        for src, dst in moves:
            mine = rs.block_of(x.__getitem__, x.shape, src, rank)
            got = rs.reshard(rs.ShardedTensor(mine, src), dst)
            pos = [int(r) for r in dst.mesh.devices.reshape(-1)].index(rank)
            want = rs.block_of(x.__getitem__, x.shape, dst, pos)
            out.append(bool(torch.equal(got.block, want)))
        torch.cuda.synchronize()
        tdist.barrier()
        torch.save({"equal": out, "backend": tdist.get_backend()},
                   f"{out_dir}/out.{rank}.pt")
    finally:
        tdist.destroy_process_group()


@pytest.mark.gpu
def test_reshard_over_nccl_across_two_cards(cuda, tmp_path):
    """The resharding executor between two ranks on two cards over NCCL:
    every block bitwise the global array's slice."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    import torch.multiprocessing as mp

    mp.spawn(_reshard_rank, args=(str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    for r in range(2):
        out = torch.load(tmp_path / f"out.{r}.pt")
        assert out["backend"] == "nccl" and all(out["equal"]), (r, out)


def _tiny_serving_model(dev, seed=0):
    """The tiny GPT at hidden 256 (4 query heads of D 64, which the flash
    kernel is built for; 2 K/V heads) on ``dev`` with weights of std 0.2
    drawn on the CPU from ``seed``, and those weights by name."""
    from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**{**GPT_TINY, "hidden_size": 256, "num_kv_heads": 2})
    g = torch.Generator().manual_seed(seed)
    model = GPTForCausalLM(cfg, device=dev)
    weights = {k: (0.2 * torch.randn(v.shape, generator=g)
                   if v.dim() >= 2 else v.detach().cpu())
               for k, v in model.state_dict().items()}
    return model, weights


SPLIT_PROMPTS = [[5, 17, 3], [9, 2, 11, 4], list(range(1, 30)), [7] * 12]


@pytest.mark.gpu
def test_split_engine_load_weights_over_one_nccl_rank(cuda, tmp_path,
                                                      monkeypatch):
    """``Engine.load_weights(shardings=)`` over an NCCL world of one rank
    (``fleet.init`` at mp 1): whole arrays, and ``ShardedTensor`` blocks
    placed otherwise (moved by the resharding executor on the card), land
    in the CUDA parameters bitwise; the engine's programs are captured
    (no gloo group), once each, and serve the tokens of an engine built
    without a process group."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import DeviceMesh, NamedSharding
    from paddle_tpu_torch.distributed import PartitionSpec as P
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import resharding as rs
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    ref, weights = _tiny_serving_model(cuda)
    sp = SamplingParams(max_new_tokens=6)
    ref_eng = Engine(ref, EngineConfig(max_batch_size=2, max_seq_len=64))
    ref_eng.load_weights(weights)
    want = ref_eng.generate(SPLIT_PROMPTS, sp)
    for var in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "MASTER_ADDR",
                "PADDLE_DISTRI_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PADDLE_MASTER", f"file://{tmp_path / 'store'}")
    dist.destroy_process_group()
    try:
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"mp_degree": 1}
        fleet.init(is_collective=True, strategy=st)
        assert dist.get_backend() == "NCCL"
        model, _ = _tiny_serving_model(cuda, seed=1)
        eng = Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64))
        assert eng.captured
        own = eng.shardings()
        eng.load_weights({k: v.numpy() for k, v in weights.items()},
                         shardings=own)
        assert all(torch.equal(p.cpu(), weights[k])
                   for k, p in model.state_dict().items())
        one = DeviceMesh([0], ("x",))
        placed = {k: rs.ShardedTensor(v.to(cuda) + 0, NamedSharding(
            one, P("x") if v.dim() else P())) for k, v in weights.items()}
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        rs.reset_stats()
        eng.load_weights(placed)
        assert rs.stats()["plans"] == len(
            [v for v in weights.values() if v.dim()])
        assert all(torch.equal(p.cpu(), weights[k])
                   for k, p in model.state_dict().items())
        assert eng.generate(SPLIT_PROMPTS, sp) == want
        assert all(s.captures == 1 and s.eager_steps == 0
                   for s in eng.steps.values())
    finally:
        dist.destroy_process_group()


def _split_serve_rank(rank, store, out_dir, weights):
    """One of two ranks, each on its own card over NCCL: the tiny GPT at
    mp 2 served by the paged engine, its programs captured."""
    import os

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    os.environ.update(PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM="2",
                      PADDLE_MASTER=f"file://{store}")
    torch.cuda.set_device(rank)
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    try:
        model, _ = _tiny_serving_model(torch.device("cuda", rank), seed=1)
        eng = Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64))
        eng.load_weights(weights)
        got = eng.generate(SPLIT_PROMPTS, SamplingParams(max_new_tokens=6))
        torch.cuda.synchronize()
        torch.save({"tokens": got, "captured": eng.captured,
                    "captures": [s.captures for s in eng.steps.values()],
                    "kv_heads": eng.cache.num_kv_heads},
                   f"{out_dir}/out.{rank}.pt")
        torch.distributed.barrier()
    finally:
        from paddle_tpu_torch import distributed as dist

        dist.destroy_process_group()


@pytest.mark.gpu
def test_split_engine_over_nccl_across_two_cards(cuda, tmp_path):
    """The tiny GPT at mp 2 over NCCL, one rank a card: the paged engine's
    programs are captured with their collectives, each rank's cache holds
    its K/V head, and both ranks serve one process's tokens."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    import torch.multiprocessing as mp

    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    ref, weights = _tiny_serving_model(cuda)
    eng = Engine(ref, EngineConfig(max_batch_size=2, max_seq_len=64))
    eng.load_weights(weights)
    want = eng.generate(SPLIT_PROMPTS, SamplingParams(max_new_tokens=6))
    mp.spawn(_split_serve_rank, args=(str(tmp_path / "store"), str(tmp_path),
                                      weights), nprocs=2, join=True)
    for r in range(2):
        out = torch.load(tmp_path / f"out.{r}.pt")
        assert out["captured"] and set(out["captures"]) == {1}, out
        assert out["kv_heads"] == 1
        assert out["tokens"] == want, (r, out["tokens"], want)


def _pp_rank(rank, store, out_dir, weights, x, y):
    """One of two ranks, each on its own card over NCCL: the tiny GPT
    (hidden 256, D 64) at pp 2 through the pipelined train step, 2 steps
    of 2 microbatches."""
    import os

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    os.environ.update(PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM="2",
                      PADDLE_MASTER=f"file://{store}")
    torch.cuda.set_device(rank)
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    try:
        dev = torch.device("cuda", rank)
        model, opt = _pp_model(dev, weights)
        step = fleet.make_sharded_train_step(model, opt, accumulate_steps=2)
        losses = [step(x[k], y[k]).item() for k in range(2)]
        torch.save({"losses": losses, "backend": dist.get_backend(
            fleet.get_hybrid_communicate_group().get_pipe_parallel_group()),
            "params": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()}},
                   f"{out_dir}/out.{rank}.pt")
        torch.distributed.barrier()
    finally:
        dist.destroy_process_group()


def _pp_model(dev, weights):
    from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(GPTConfig(**{**GPT_TINY, "hidden_size": 256,
                                        "num_kv_heads": 2}), device=dev)
    model.load_state_dict(weights)
    model.train()
    return model, AdamW(learning_rate=1e-3, epsilon=1e-6,
                        parameters=model.named_parameters())


@pytest.mark.gpu
def test_pipeline_over_nccl_across_two_cards(cuda, tmp_path):
    """The tiny GPT at pp 2 over NCCL, one stage a card: each tick's
    activations and gradients go by ``batch_isend_irecv`` on the cards;
    the losses within 1e-5 and every parameter, the stages joined, within
    3e-5 of one process's step on the same weights."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    import torch.multiprocessing as mp

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.weights import to_paddle_tpu

    _, weights = _tiny_serving_model(cuda)
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 128, (2, 4, 32), generator=g)
    y = torch.roll(x, -1, 2)
    model, opt = _pp_model(cuda, weights)
    step = fleet.make_sharded_train_step(model, opt, accumulate_steps=2)
    want = [step(x[k], y[k]).item() for k in range(2)]
    mp.spawn(_pp_rank, args=(str(tmp_path / "store"), str(tmp_path),
                             weights, x, y), nprocs=2, join=True)
    outs = [torch.load(tmp_path / f"out.{r}.pt") for r in range(2)]
    for out in outs:
        assert out["backend"] == "NCCL"
        assert max(abs(a - b) for a, b in zip(out["losses"], want)) <= 1e-5
    joined = to_paddle_tpu([o["params"] for o in outs], pp_degree=2)
    for k, v in model.state_dict().items():
        assert float((joined[k] - v.cpu()).abs().max()) <= 3e-5, k
