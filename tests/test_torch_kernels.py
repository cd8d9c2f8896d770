"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``paddle_tpu_torch.kernels`` runs its plain
PyTorch version; here that version is held against the JAX function that
reaches the Pallas kernel, run in interpret mode as the JAX package's own
tests run it. Inputs come from numpy with a fixed seed and go to both
sides. The kernels themselves are held against these plain versions on
the card by ``tests/test_torch_gpu.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels.fused_optim import fused_adamw_update as j_adamw
from paddle_tpu.kernels.norms import fused_layer_norm as j_layer_norm
from paddle_tpu.kernels.paged_attention import paged_attention as j_paged
from paddle_tpu_torch import kernels as K

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: both sides compute in fp32 with other summation orders. bf16: the
# outputs are rounded to bf16 (2^-8 relative), and the flash kernel rounds
# P to bf16 against its running tile max where the plain version uses the
# row max.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _max_err(j, t):
    return float(np.abs(_np(j) - t.float().numpy()).max())


# ---------------- LayerNorm ------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 48), (7, 64), (3, 1, 100)])
def test_layer_norm_ref_matches_pallas(dtype, shape):
    rng = np.random.default_rng(0)
    H = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    want = j_layer_norm(jx, jw, jb, 1e-5)
    before = K.fused_layer_norm.launches
    got = K.fused_layer_norm(tx, tw, tb, 1e-5)  # CPU tensor: plain version
    assert K.fused_layer_norm.launches == before
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert torch.equal(got, K.layer_norm_ref(tx, tw, tb, 1e-5))
    # |y| < 8: bf16 outputs may differ by one rounding step (2^-5)
    assert _max_err(want, got) <= (1e-5 if dtype == "float32" else 3.2e-2)


# ---------------- flash attention forward ----------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_fwd(dtype, causal):
    """O and the log2-domain LSE of ``flash_attention_ref`` against the
    Pallas ``_fwd`` (interpret mode) with several key blocks per row."""
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 32, 2, 16
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    scale = 1.0 / math.sqrt(D)
    o_j, lse_j, _ = jfa._fwd(jq, jk, jv, causal, scale, 8, 8)
    o_t, lse_t = K.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert o_t.dtype == tq.dtype and lse_t.dtype == torch.float32
    o_t = o_t.transpose(1, 2).reshape(B * H, S, D)  # the Pallas [B*H, S, D]
    assert _max_err(o_j, o_t) <= TOL[dtype]
    assert _max_err(lse_j, lse_t) <= 1e-4


def test_flash_ref_gqa_and_ragged_matches_public_entry():
    """GQA (K/V heads indexed ``h // rep``) against the JAX entry point on
    expanded K/V, and a sequence length no Pallas block divides, against
    the JAX reference lowering ``_sdpa_ref`` (fp32)."""
    from paddle_tpu.nn.functional.attention import _sdpa_ref

    rng = np.random.default_rng(2)
    B, S, H, Hkv, D = 1, 16, 4, 2, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kx, vx = np.repeat(k, H // Hkv, axis=2), np.repeat(v, H // Hkv, axis=2)
    want = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(kx),
                                   jnp.asarray(vx), causal=True)
    got, _ = K.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert _max_err(want, got) <= 2e-5
    S = 13  # ragged: the Pallas wrapper has no block for it
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    want = _sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True)
    got, _ = K.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                   causal=True)
    assert _max_err(want, got) <= 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 1)], ids=["mha", "gqa4to1"])
def test_flash_ref_matches_pallas_fwd_at_hopper_tiles(dtype, causal, H, Hkv):
    """O and the log2-domain LSE of ``flash_attention_ref`` against the
    Pallas ``_fwd`` (interpret mode) at the tiling of the tensor-core
    forward (D 128, blocks of 64 query and 64 key rows, S 128: two tiles
    each way), with MHA and with GQA 4/1, where the plain version reads K/V
    natively and Pallas runs on K/V expanded to H heads. fp32: summation
    order only. bf16: Pallas rounds P to bf16 against its running tile max,
    the plain version against the row max (~2^-8 relative on P), and O
    rounds to bf16 (|o| < 4: within 2^-6); the LSE is fp32 on both sides."""
    rng = np.random.default_rng(9)
    B, S, D = 1, 128, 128
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jkx, jvx = (jnp.repeat(a, H // Hkv, axis=2) for a in (jk, jv))
    o_j, lse_j, _ = jfa._fwd(jq, jkx, jvx, causal, 1.0 / math.sqrt(D), 64,
                             64)
    o_t, lse_t = K.flash_attention_ref(tq, tk, tv, causal=causal)
    assert o_t.dtype == tq.dtype and o_t.shape == (B, S, H, D)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B * H, S)
    o_t = o_t.transpose(1, 2).reshape(B * H, S, D)  # the Pallas [B*H, S, D]
    assert _max_err(o_j, o_t) <= TOL[dtype]
    assert _max_err(lse_j, lse_t) <= 1e-4


def test_flash_routes_and_their_counts():
    """Each flash kernel is routed by dtype, bf16 to the tensor cores and
    fp32 to the CUDA cores, and counts its launches by route;
    ``reset_launch_counts`` zeroes those counts. On the CPU the wrappers
    run their plain versions and count nothing, and a tensor on any other
    device is refused (a CUDA tensor launches its route's kernel or
    raises)."""
    from paddle_tpu_torch.kernels.flash_attention import (BWD_ROUTES,
                                                          FWD_ROUTES)

    routes = {torch.bfloat16: "wgmma", torch.float32: "cuda_cores"}
    assert FWD_ROUTES == BWD_ROUTES == routes
    wrappers = (K.flash_attention_fwd, K.flash_attention_bwd_dq,
                K.flash_attention_bwd_dkv)
    for w in wrappers:
        assert set(w.route_launches) == {"wgmma", "cuda_cores"}
        w.launches, w.route_launches["wgmma"] = 3, 2
        w.route_launches["cuda_cores"] = 1
    K.reset_launch_counts()
    assert all(w.launches == 0 and set(w.route_launches.values()) == {0}
               for w in wrappers)
    for dtype in routes:
        q, k, v, g = (torch.randn(1, 9, 4, 64).to(dtype) for _ in range(4))
        _torch_grads(q, k[:, :, :2], v[:, :, :2], g, causal=True)
        K.flash_attention_fwd(q, k, v)
    assert all(w.launches == 0 and set(w.route_launches.values()) == {0}
               for w in wrappers)
    x = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.flash_attention_fwd(x, x, x)


@pytest.mark.parametrize("lib,entry,route,want", [
    ("flash_fwd", "flash_fwd", "wgmma", ("flash_fwd_sm90", "flash_fwd_sm90")),
    ("flash_fwd", "flash_fwd", "cuda_cores", ("flash_fwd", "flash_fwd")),
    ("flash_bwd", "flash_bwd_dkv", "wgmma",
     ("flash_bwd_sm90", "flash_bwd_dkv_sm90")),
    ("flash_bwd", "flash_bwd_dq", "cuda_cores",
     ("flash_bwd", "flash_bwd_dq")),
])
def test_each_route_binds_its_library(monkeypatch, lib, entry, route, want):
    """A route names its library and C entry (the wgmma route's carry
    ``_sm90``), and the library is bound with the signatures of every entry
    it has, so a later call of another entry finds its argument types."""
    import importlib
    import types

    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    loaded = {}

    def load(name, signatures):
        loaded[name] = signatures
        return types.SimpleNamespace(**dict.fromkeys(signatures, name))

    monkeypatch.setattr(FA._build, "load", load)
    assert FA._entry(lib, entry, route) == want[0]
    sfx = "_sm90" if route == "wgmma" else ""
    assert loaded == {want[0]: {e + sfx: FA._ARGS[e] for e in FA._LIBS[lib]}}
    assert want[1] in loaded[want[0]]


def test_build_is_stale_when_a_header_is_newer(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any ``csrc/*.cuh`` header
    (which the tensor-core kernels include) is newer than it."""
    import os

    from paddle_tpu_torch.kernels import _build

    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    src, lib = csrc / "k.cu", build / "libk.so"
    src.write_text("")
    assert _build._stale("k")  # never built
    lib.write_text("")
    os.utime(src, (100, 100))
    os.utime(lib, (200, 200))
    assert not _build._stale("k")
    header = csrc / "sm90.cuh"
    header.write_text("")
    os.utime(header, (150, 150))
    assert not _build._stale("k")
    os.utime(header, (300, 300))
    assert _build._stale("k")
    os.utime(src, (400, 400))
    os.utime(header, (100, 100))
    assert _build._stale("k")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_with_mask_takes_reference_lowering(dtype):
    """With a mask the port's ``scaled_dot_product_attention`` runs its
    ``_sdpa_ref``, matching the JAX reference lowering; GQA K/V are
    expanded there."""
    from paddle_tpu.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 2, 12, 4, 2, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    mask = rng.random((B, 1, S, S)) < 0.7
    mask[..., 0] = True  # every row keeps a key
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    rep = H // Hkv
    want = _sdpa_ref(jq, jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, 2),
                     mask=jnp.asarray(mask), causal=True)
    got = TF.scaled_dot_product_attention(tq, tk, tv,
                                          attn_mask=torch.from_numpy(mask),
                                          is_causal=True, training=False)
    assert _max_err(want, got) <= TOL[dtype]


# ---------------- paged decode ---------------------------------------------
def _paged_inputs(rep, seed=0, B=3, Hkv=2, ps=4, nb=3, D=8):
    """Random pools + a table with ragged live pages, sentinel tails and an
    all-sentinel empty slot (mirrors tests/test_paged_kv.py)."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kp = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    vp = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    table = np.full((B, nb), -1, np.int32)
    table[0, :2] = [1, 2]      # 2 live pages
    table[1, :1] = [5]         # 1 live page; row 2 stays an empty slot
    q = rng.standard_normal((B, Hkv * rep, 1, D)).astype(np.float32)
    pos = np.array([6, 3, 0], np.int32)  # mid-page, page-0-only, empty
    return q, kp, vp, table, pos


def _paged_inputs_at_hopper_tiling(rep, seed=0, Hkv=2, ps=16, nb=8, D=128):
    """The card's tiling: ps 16, D 128, and positions on and next to page
    edges (15, 16, 17) and the card's split edge (63, 64, 65: a split is
    4 pages of 16 tokens), a full table (127) and an empty slot."""
    rng = np.random.default_rng(seed)
    pos = np.array([0, 15, 16, 17, 63, 64, 65, 127], np.int32)
    B = len(pos)
    P = B * nb + 1
    kp = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    vp = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    table = np.full((B, nb), -1, np.int32)
    perm = rng.permutation(P - 1) + 1
    used = 0
    for b, p in enumerate(pos):
        n = int(p) // ps + 1 if p else 0
        table[b, :n] = perm[used:used + n]
        used += n
    q = rng.standard_normal((B, Hkv * rep, 1, D)).astype(np.float32)
    return q, kp, vp, table, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep,tiling", [
    pytest.param(1, None, id="1"), pytest.param(2, None, id="2"),
    pytest.param(1, "hopper", id="hopper-rep1"),
    pytest.param(4, "hopper", id="hopper-rep4")])
def test_paged_ref_matches_pallas(rep, tiling, dtype):
    """The plain version against the Pallas kernel in interpret mode, at a
    tiny shape and at the widths and page size the card runs."""
    make = _paged_inputs if tiling is None else _paged_inputs_at_hopper_tiling
    q, kp, vp, table, pos = make(rep)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    want = j_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                   interpret=True)
    got = K.paged_attention(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(pos))
    assert got.shape == q.shape and got.dtype == tv.dtype
    assert torch.isfinite(got).all()  # the empty slot reads trash page 0
    assert _max_err(want, got) <= TOL[dtype]


def test_paged_routes_and_plan():
    """The vector route takes heads of whole 16-byte chunks up to D 256
    with 16-byte aligned pools and q, the scalar route the rest. The plan
    comes from static shapes alone: 64 tokens a split (at least one page,
    at most the table); up to 8 query heads a block on the vector route
    (rep 12: two head tiles), one on the scalar route; a ring stage holds
    at most 8 KB of K."""
    import importlib

    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    for D, itemsize, ptrs, want in [
            (128, 2, (0, 4096, 512), "vector"), (64, 4, (16,), "vector"),
            (80, 2, (0,), "vector"), (256, 4, (0,), "vector"),
            (20, 2, (0,), "scalar"), (18, 4, (0,), "scalar"),
            (320, 2, (0,), "scalar"), (128, 2, (0, 4), "scalar"),
            (128, 4, (8, 0), "scalar")]:
        assert PA.route(D, itemsize, ptrs) == want, (D, itemsize, ptrs)
    for shape, want in [
            # (Hq, Hkv, ps, nb, D, itemsize): route, heads, pps, splits,
            # tile. The slice (H 16/16, D 128, ps 16, nb 128, bf16)
            ((16, 16, 16, 128, 128, 2), ("vector", 1, 4, 32, 16)),
            # the GQA serving config (H 16/4, D 64, nb 64)
            ((16, 4, 16, 64, 64, 2), ("vector", 4, 4, 16, 16)),
            # pages of 8 tokens: 8 a split
            ((16, 16, 8, 256, 128, 2), ("vector", 1, 8, 32, 8)),
            # rep 12 in two head tiles; fp32 D 256 in 8-token stages
            ((24, 2, 32, 12, 256, 4), ("vector", 8, 2, 6, 8)),
            ((8, 2, 16, 32, 20, 2), ("scalar", 1, 4, 8, 16)),
            # pages of 128 tokens: one page a split, 32-token stages
            ((16, 16, 128, 4, 128, 2), ("vector", 1, 1, 4, 32)),
            # a table shorter than a split: one split of the whole table
            ((16, 16, 16, 2, 128, 2), ("vector", 1, 2, 1, 16))]:
        assert tuple(PA.plan(*shape, (0,))) == want, shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_prescale_q_is_bitwise_the_old_arithmetic(monkeypatch, dtype, D):
    """``prescale_q`` multiplies by the scale rounded to q's dtype on the
    host, creating no tensor on q's device (a host-to-device copy waits for
    the card), and gives the same bits as the product with a 0-dim tensor
    of q's dtype on q's device."""
    import importlib
    import math

    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.standard_normal((3, 16, 1, D)) * 4).to(dtype)
    old = q * torch.tensor(1.0 / math.sqrt(D), dtype=dtype, device=q.device)
    made = []
    real = torch.tensor

    def spy(*args, **kwargs):
        made.append(kwargs.get("device"))
        return real(*args, **kwargs)

    PA._q_scale.cache_clear()
    monkeypatch.setattr(torch, "tensor", spy)
    got = PA.prescale_q(q)
    again = PA.prescale_q(q)
    assert made == [None]  # once, on the host, then cached
    assert got.dtype == dtype and torch.equal(got, old)
    assert torch.equal(got.view(torch.uint8), old.view(torch.uint8))
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attend_mask_is_bitwise_the_old_where(dtype):
    """``decode_attend`` masks with ``masked_fill`` and a host scalar (no
    copy to the device, so a CUDA graph can capture it): bitwise the old
    ``torch.where`` against a 0-dim tensor, per-row and scalar positions."""
    import importlib

    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((3, 4, 1, 32))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((3, 2, 40, 32))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((3, 2, 40, 32))).to(dtype)

    def old(positions):
        kk, vv = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", PA.prescale_q(q).float(),
                         kk.float())
        pos = torch.as_tensor(positions)
        key_pos = torch.arange(40)
        valid = key_pos <= pos if pos.dim() == 0 else \
            key_pos[None, None, None, :] <= pos[:, None, None, None]
        s = torch.where(valid, s, torch.tensor(PA.NEG_INF))
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs.float(),
                            vv.float()).to(v.dtype)

    for positions in (torch.tensor([0, 17, 39], dtype=torch.int32),
                      torch.tensor(21, dtype=torch.int32)):
        got = PA.decode_attend(q, k, v, positions)
        want = old(positions)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_wrappers_reject_other_devices():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_layer_norm(x, x[0], x[0])
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_adamw_update(x, x, x, x, lr=1e-3, beta1=0.9, beta2=0.999,
                             eps=1e-8, weight_decay=0.0, beta1_pow=0.9,
                             beta2_pow=0.999)


# ---------------- flash attention backward ---------------------------------
# the autograd node of the ``paddle_tpu_torch::flash_fwd`` op
FLASH_NODE = "GeneratedBackwardFor_paddle_tpu_torch_flash_fwd_defaultBackward"


def _torch_grads(q, k, v, g, causal):
    """Grads of ``sum(o * g)`` through the port's ``flash_fwd`` op (on the
    CPU: the plain forward, then ``flash_attention_bwd_ref``)."""
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = K.flash_attention(*xs, causal=causal)
    assert type(o.grad_fn).__name__ == FLASH_NODE
    o.backward(g)
    return [t.grad for t in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_pallas_bwd(dtype, causal):
    """dq/dk/dv of ``flash_attention_bwd_ref`` (fed the Pallas forward's O
    and LSE) and of the ``flash_fwd`` op's CPU backward, against
    the Pallas ``_bwd`` (interpret mode) run through ``_fwd``. S 64 with
    blocks of 16 and 32 rows, so both kernels walk several tiles. fp32:
    summation order only. bf16: the plain version repeats the kernels'
    roundings of p and ds (it agrees to ~1e-3); the Function also runs its
    own forward, whose bf16 O differs from Pallas's by a rounding step,
    and delta = rowsum(dO*O) carries that into ds."""
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 64, 2, 16
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_pair(a, dtype)
                                              for a in (q, k, v, g))
    scale = 1.0 / math.sqrt(D)
    o, lse, res = jfa._fwd(jq, jk, jv, causal, scale, 16, 32)
    want = jfa._bwd(causal, scale, 32, 16, (*res, o, lse), jg)
    o_t = torch.from_numpy(_np(jnp.swapaxes(o.reshape(B, H, S, D), 1, 2))) \
        .to(tq.dtype)
    ref = K.flash_attention_bwd_ref(tq, tk, tv, o_t,
                                    torch.from_numpy(np.asarray(lse)), tg,
                                    causal)
    for w, r, t in zip(want, ref, (tq, tk, tv)):
        assert r.dtype == t.dtype and r.shape == t.shape
        assert _max_err(w, r) <= (2e-5 if dtype == "float32" else 2e-3)
    for w, got in zip(want, _torch_grads(tq, tk, tv, tg, causal)):
        assert _max_err(w, got) <= TOL[dtype]


def _pallas_bwd_vs_ref(dtype, causal, H, Hkv, seed):
    """``[(max error, max |Pallas|)]`` for dq, dk, dv of
    ``flash_attention_bwd_ref`` against the Pallas ``_bwd`` (interpret
    mode) at the Hopper kernels' tiling: D 128, blocks of 64 query and 64
    key rows, S 128 (two tiles each way). Pallas runs on K/V expanded to H
    heads; its dk/dv are summed over each KV head's group."""
    rng = np.random.default_rng(seed)
    B, S, D = 1, 128, 128
    rep = H // Hkv
    q, g = (rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_pair(a, dtype)
                                              for a in (q, k, v, g))
    jkx, jvx = (jnp.repeat(a, rep, axis=2) for a in (jk, jv))
    scale = 1.0 / math.sqrt(D)
    o, lse, res = jfa._fwd(jq, jkx, jvx, causal, scale, 64, 64)
    want = jfa._bwd(causal, scale, 64, 64, (*res, o, lse), jg)
    o_t = torch.from_numpy(_np(jnp.swapaxes(o.reshape(B, H, S, D), 1, 2))) \
        .to(tq.dtype)
    got = K.flash_attention_bwd_ref(tq, tk, tv, o_t,
                                    torch.from_numpy(np.asarray(lse)), tg,
                                    causal)
    group_sum = lambda a: _np(a).reshape(B, S, Hkv, rep, D).sum(3)  # noqa: E731
    want = (_np(want[0]), group_sum(want[1]), group_sum(want[2]))
    out = []
    for w, r, t in zip(want, got, (tq, tk, tv)):
        assert r.dtype == t.dtype and r.shape == t.shape
        out.append((float(np.abs(w - r.float().numpy()).max()),
                    float(np.abs(w).max())))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_pallas_bwd_at_hopper_tiles(dtype, causal):
    """As ``test_flash_bwd_matches_pallas_bwd``, at the tiling of the
    tensor-core kernels (D 128, 64 x 64 tiles, S 128). fp32: summation
    order only (|d| < 8). bf16: the plain version repeats the kernels'
    roundings of p and ds, so the two differ where a rounding flips on an
    fp32 ulp of a score, by far less than one rounding step of the bf16
    outputs (2^-7 of the largest; ~2e-3 seen against ~0.03)."""
    for err, mag in _pallas_bwd_vs_ref(dtype, causal, H=2, Hkv=2, seed=7):
        assert err <= (2e-5 if dtype == "float32" else 2 ** -7 * mag)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_gqa_4_to_1_matches_pallas_at_hopper_tiles(dtype):
    """GQA 4/1 at the same tiling: the plain version's dk/dv (K/V read
    natively, summed over the group) against the Pallas grads of expanded
    K/V summed over each group. fp32 as above. bf16: Pallas rounds each
    of the four heads' dk/dv to bf16 before they are summed, the plain
    version rounds the fp32 sum once, so they may differ by up to four
    rounding steps of a head's output (4 x 2^-7 of the largest sum bounds
    that; ~0.02 seen against ~0.16)."""
    for err, mag in _pallas_bwd_vs_ref(dtype, True, H=4, Hkv=1, seed=8):
        assert err <= (2e-5 if dtype == "float32" else 4 * 2 ** -7 * mag)


def test_flash_bwd_gqa_sums_over_the_group():
    """GQA dk/dv (K/V heads read natively) against the JAX grads of the
    expanded K/V through the Pallas flash custom_vjp, summed over each KV
    head's query heads (fp32, summation order only)."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 1, 32, 4, 2, 8
    rep = H // Hkv
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def loss(q, kx, vx):
        return (jfa.flash_attention_fwd(q, kx, vx, causal=True)
                * jnp.asarray(g)).sum()

    dq, dkx, dvx = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)))
    group_sum = lambda a: np.asarray(a).reshape(B, S, Hkv, rep, D).sum(3)  # noqa: E731
    got = _torch_grads(*map(torch.from_numpy, (q, k, v, g)), causal=True)
    assert got[1].shape == (B, S, Hkv, D)
    for want, t in zip((np.asarray(dq), group_sum(dkx), group_sum(dvx)), got):
        assert float(np.abs(want - t.numpy()).max()) <= 2e-5


# ---------------- LayerNorm backward ---------------------------------------
# the rows of the backward tests: a few leading shapes, one row, and H
# that is not a multiple of the bf16 vector (8) on either side of 2048,
# where the kernels change route
NORM_BWD_SHAPES = [(3, 4, 48), (1, 7), (2, 3, 100), (1, 2050)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NORM_BWD_SHAPES, ids=str)
def test_layer_norm_bwd_matches_jax_grad(dtype, shape):
    """dx, dw, db of ``LayerNormFunction`` against ``jax.grad`` through the
    Pallas ``fused_layer_norm`` (whose backward is ``_ln_bwd_rule``). The
    port repeats that rule's arithmetic: fp32 differs by summation order;
    bf16 outputs (|dx| < 4, |dw|, |db| < 16) by at most one rounding step
    of their magnitude (2^-6 relative). On CPU tensors the backward runs
    the plain version and launches nothing."""
    rng = np.random.default_rng(6)
    H = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb), (jg, tg) = (_pair(a, dtype)
                                              for a in (x, w, b, g))
    want = jax.grad(
        lambda x, w, b: (j_layer_norm(x, w, b, 1e-5).astype(jnp.float32)
                         * jg.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(jx, jw, jb)
    xs = [t.clone().requires_grad_() for t in (tx, tw, tb)]
    y = K.fused_layer_norm(*xs, 1e-5)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    assert torch.equal(y.detach(), K.layer_norm_ref(tx, tw, tb, 1e-5))
    before = K.layer_norm_bwd.launches
    y.backward(tg)
    assert K.layer_norm_bwd.launches == before
    for got, ref in zip((t.grad for t in xs),
                        K.layer_norm_bwd_ref(tx, tw, tg, 1e-5)):
        assert torch.equal(got, ref)
    for wnt, t in zip(want, xs):
        assert t.grad.dtype == t.dtype
        mag = float(np.abs(_np(wnt)).max())
        tol = 1e-5 * max(mag, 1) if dtype == "float32" else 2 ** -6 * mag
        assert _max_err(wnt, t.grad) <= tol


def test_serving_calls_stay_outside_autograd():
    """Without grad (serving, ``no_grad``) the wrappers are called directly:
    no autograd node, the same values."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    w, b = torch.ones(8, requires_grad=True), torch.zeros(8)
    with torch.no_grad():
        assert K.fused_layer_norm(x, w, b).grad_fn is None
        qg = q.clone().requires_grad_()
        assert K.flash_attention(qg, k, v, causal=True).grad_fn is None
    assert K.flash_attention(q, k, v, causal=True).grad_fn is None
    assert torch.equal(K.flash_attention(q, k, v, causal=True),
                       K.flash_attention_fwd(q, k, v, causal=True)[0])


# ---------------- fused AdamW ----------------------------------------------
ADAMW_HP = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                beta1_pow=0.9 ** 3, beta2_pow=0.999 ** 3)


@pytest.mark.parametrize("n", [33, 65536 + 17])
@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "master+bf16"])
def test_adamw_ref_matches_pallas(n, mixed):
    """``adamw_ref`` and ``fused_adamw_update`` on CPU tensors (in place)
    against the Pallas ``fused_adamw_update`` (interpret mode), with fp32
    params, and with an fp32 master beside bf16 grad and moments. fp32
    outputs agree to a few ulps of |p| < 8 (XLA may contract a multiply-add
    the plain version rounds twice); bf16 moments to one rounding step
    (2^-8 relative) when such an ulp lands on a rounding boundary."""
    rng = np.random.default_rng(n)
    p = rng.standard_normal(n).astype(np.float32) * 2
    g = rng.standard_normal(n).astype(np.float32)
    m = (0.1 * rng.standard_normal(n)).astype(np.float32)
    v = (0.1 * np.abs(rng.standard_normal(n))).astype(np.float32)
    low = "bfloat16" if mixed else "float32"
    (jp, tp), = (_pair(p, "float32"),)
    (jg, tg), (jm, tm), (jv, tv) = (_pair(a, low) for a in (g, m, v))
    want = j_adamw(jp, jg, jm, jv, beta1=ADAMW_HP["beta1"],
                   **{k: x for k, x in ADAMW_HP.items() if k != "beta1"})
    ref = K.adamw_ref(tp, tg, tm, tv, **ADAMW_HP)
    upd = [t.clone() for t in (tp, tm, tv)]
    before = K.fused_adamw_update.launches
    out = K.fused_adamw_update(upd[0], tg, upd[1], upd[2], **ADAMW_HP)
    assert K.fused_adamw_update.launches == before  # CPU: no kernel
    assert all(o is u for o, u in zip(out, upd))    # in place
    for w, r, u in zip(want, ref, upd):
        assert torch.equal(r, u) and r.dtype == u.dtype
        tol = 2e-6 if r.dtype == torch.float32 else \
            2 ** -8 * float(np.abs(_np(w)).max())
        assert _max_err(w, r) <= tol


def test_adamw_rejects_dtype_combinations_it_was_not_built_for():
    p = torch.zeros(4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported dtypes"):
        K.fused_adamw_update(p, torch.zeros(4), p.clone(), p.clone(),
                             **ADAMW_HP)


# ---------------- RMSNorm --------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 48), (7, 64), (3, 1, 100)])
def test_rms_norm_ref_matches_pallas(dtype, shape):
    """``rms_norm_ref`` (and the wrapper on CPU tensors) against the Pallas
    ``fused_rms_norm`` in interpret mode. fp32: summation order; bf16: the
    outputs (|y| < 8) may differ by one rounding step (2^-5)."""
    from paddle_tpu.kernels.norms import fused_rms_norm as j_rms_norm

    rng = np.random.default_rng(8)
    H = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    (jx, tx), (jw, tw) = (_pair(a, dtype) for a in (x, w))
    want = j_rms_norm(jx, jw, 1e-6)
    before = K.fused_rms_norm.launches
    got = K.fused_rms_norm(tx, tw, 1e-6)  # CPU tensor: plain version
    assert K.fused_rms_norm.launches == before
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert torch.equal(got, K.rms_norm_ref(tx, tw, 1e-6))
    assert _max_err(want, got) <= (1e-5 if dtype == "float32" else 3.2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NORM_BWD_SHAPES, ids=str)
def test_rms_norm_bwd_matches_jax_grad(dtype, shape):
    """dx, dw of ``RMSNormFunction`` (``rms_norm_bwd`` on CPU tensors:
    ``rms_norm_bwd_ref``, no launch) against ``jax.grad`` through the
    Pallas ``fused_rms_norm``, whose backward is ``_rms_bwd_rule``: fp32 to
    1e-5 of the larger of 1 and the gradient's magnitude (summation order);
    bf16 outputs to one rounding step of their magnitude (2^-6
    relative)."""
    from paddle_tpu.kernels.norms import fused_rms_norm as j_rms_norm

    rng = np.random.default_rng(9)
    H = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    (jx, tx), (jw, tw), (jg, tg) = (_pair(a, dtype) for a in (x, w, g))
    want = jax.grad(
        lambda x, w: (j_rms_norm(x, w, 1e-6).astype(jnp.float32)
                      * jg.astype(jnp.float32)).sum(), argnums=(0, 1))(jx, jw)
    xs = [t.clone().requires_grad_() for t in (tx, tw)]
    y = K.fused_rms_norm(*xs, 1e-6)
    assert type(y.grad_fn).__name__ == "RMSNormFunctionBackward"
    assert torch.equal(y.detach(), K.rms_norm_ref(tx, tw, 1e-6))
    before = K.rms_norm_bwd.launches
    y.backward(tg)
    assert K.rms_norm_bwd.launches == before
    for got, ref in zip((t.grad for t in xs),
                        K.rms_norm_bwd_ref(tx, tw, tg, 1e-6)):
        assert torch.equal(got, ref)
    for wnt, t in zip(want, xs):
        assert t.grad.dtype == t.dtype
        mag = float(np.abs(_np(wnt)).max())
        tol = 1e-5 * max(mag, 1) if dtype == "float32" else 2 ** -6 * mag
        assert _max_err(wnt, t.grad) <= tol


def test_norm_routes():
    """The warp route takes rows whose length is a multiple of the 16-byte
    vector (8 bf16, 4 fp32), at most ``WARP_MAX_H``, with every tensor
    16-byte aligned; the block route takes the rest."""
    from paddle_tpu_torch.kernels.norms import WARP_MAX_H, route

    assert WARP_MAX_H == 2048
    for H, itemsize, ptrs, want in [
            (2048, 2, (0, 4096, 64), "warp"), (2048, 4, (16,), "warp"),
            (768, 2, (0,), "warp"), (100, 4, (0,), "warp"),
            (1000, 2, (0,), "warp"), (8, 2, (0,), "warp"),
            (100, 2, (0,), "block"), (7, 4, (0,), "block"),
            (2050, 4, (0,), "block"), (2056, 2, (0,), "block"),
            (4096, 2, (0,), "block"), (2048, 2, (0, 2), "block"),
            (2048, 4, (8, 0), "block")]:
        assert route(H, itemsize, ptrs) == want, (H, itemsize, ptrs)


def test_norm_wrappers_count_by_route_and_refuse_other_devices():
    """The four norm wrappers count launches in total and by route, and
    ``reset_launch_counts`` zeroes both; CPU tensors launch nothing, and a
    tensor on another device is refused by each."""
    wrappers = (K.fused_layer_norm, K.layer_norm_bwd, K.fused_rms_norm,
                K.rms_norm_bwd)
    assert all(w in K.WRAPPERS for w in wrappers)
    for w in wrappers:
        assert set(w.route_launches) == {"warp", "block"}
        w.launches, w.route_launches["warp"], w.route_launches["block"] = \
            3, 2, 1
    K.reset_launch_counts()
    assert all(w.launches == 0 and set(w.route_launches.values()) == {0}
               for w in wrappers)
    x = torch.randn(3, 16)
    w1 = torch.ones(16)
    K.layer_norm_bwd(x, w1, x)
    K.rms_norm_bwd(x, w1, x)
    K.fused_layer_norm(x, w1, w1)
    K.fused_rms_norm(x, w1)
    assert all(w.launches == 0 for w in wrappers)
    m = torch.zeros(2, 4, device="meta")
    for call in (lambda: K.fused_layer_norm(m, m[0], m[0]),
                 lambda: K.fused_rms_norm(m, m[0]),
                 lambda: K.layer_norm_bwd(m, m[0], m),
                 lambda: K.rms_norm_bwd(m, m[0], m)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# ---------------- the C interfaces -----------------------------------------
def _c_entries():
    """{C entry: [argument types]} of every ``extern "C"`` function in
    ``kernels/csrc/*.cu``, with the return type under the key "return"."""
    import re

    from paddle_tpu_torch.kernels import _build

    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for ret, name, args in re.findall(
                r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)',
                text):
            types = [re.sub(r"\s*\b\w+\s*$", "", a.strip())
                     for a in args.split(",") if a.strip()]
            entries[name] = {"return": ret.strip(), "args": types}
    return entries


C_ENTRIES = _c_entries()


def _bound_signatures():
    """{C entry: ctypes argtypes} as the wrappers bind them."""
    import importlib

    # the modules, not the package attributes of the same names (functions)
    mod = {m: importlib.import_module(f"paddle_tpu_torch.kernels.{m}")
           for m in ("flash_attention", "fused_optim", "norms",
                     "paged_attention")}
    bound = {**mod["norms"]._SIGNATURES, **mod["fused_optim"]._SIGNATURES,
             **mod["paged_attention"]._SIGNATURES}
    for entry, args in mod["flash_attention"]._ARGS.items():
        bound[entry] = bound[entry + "_sm90"] = args
    return bound


@pytest.mark.parametrize("entry", sorted(C_ENTRIES))
def test_c_signature_matches_its_ctypes_binding(entry):
    """Each C entry of the CUDA sources against the ``argtypes`` its wrapper
    binds: every pointer (and the stream) a ``c_void_p``, ``int`` a
    ``c_int``, ``long long`` a ``c_longlong``, ``float`` a ``c_float``, and
    an ``int`` returned. A mismatch would cut a pointer or shift every later
    argument on the card, where no CPU test reaches."""
    import ctypes

    c_to_ctypes = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                   "float": ctypes.c_float}
    sig = C_ENTRIES[entry]
    bound = _bound_signatures()
    assert sig["return"] == "int"
    assert entry in bound, f"{entry} has no ctypes binding"
    want = [ctypes.c_void_p if "*" in t
            else c_to_ctypes[" ".join(t.replace("const", "").split())]
            for t in sig["args"]]
    assert bound[entry] == want


def test_every_binding_names_a_c_entry():
    """No wrapper binds an entry that no CUDA source defines, and the
    parser found the entries of every source."""
    assert set(_bound_signatures()) == set(C_ENTRIES)
    assert {"norm_fwd", "norm_bwd", "norm_bwd_grid", "paged_decode",
            "fused_adamw", "flash_fwd_sm90"} <= set(C_ENTRIES)


# ---------------- kernel primitives ----------------------------------------
# the functions and shapes of tests/test_kernels.py's TestKernelPrimitives
PRIMITIVE_SHAPES = [(130,), (8, 128), (3, 5, 7)]


@pytest.mark.parametrize("shape", PRIMITIVE_SHAPES, ids=str)
def test_elementwise_ref_matches_pallas_factory(shape):
    """``x + a * tanh(y)`` through the port's factory (the plain version on
    CPU tensors) against the JAX factory's Pallas kernel in interpret mode;
    fp32, tanh implementations differ by an ulp."""
    from paddle_tpu.kernels import primitive as jkp
    from paddle_tpu_torch.kernels import primitive as P

    rng = np.random.default_rng(10)
    x, y, a = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    want = jkp.elementwise_kernel(lambda x, y, a: x + a * jnp.tanh(y))(x, y, a)
    op = P.elementwise_kernel(lambda x, y, a: x + a * torch.tanh(y))
    before = P.elementwise_kernel.launches
    got = op(*map(torch.from_numpy, (x, y, a)))
    assert P.elementwise_kernel.launches == before
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_elementwise_dtype_preserved_and_shapes_checked():
    """bf16 in, bf16 out (``x * 2.0``), as the JAX factory; operands of two
    shapes raise ``ValueError`` on both sides."""
    import ml_dtypes

    from paddle_tpu.kernels import primitive as jkp
    from paddle_tpu_torch.kernels import primitive as P

    x = np.ones((16, 128), np.float32)
    want = np.asarray(jkp.elementwise_kernel(lambda x: x * 2.0)(
        x.astype(ml_dtypes.bfloat16)))
    got = P.elementwise_kernel(lambda x: x * 2.0)(
        torch.from_numpy(x).to(torch.bfloat16))
    assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    add = P.elementwise_kernel(lambda x, y: x + y)
    with pytest.raises(ValueError, match="share a shape"):
        add(torch.ones(4), torch.ones(5))
    with pytest.raises(ValueError):
        jkp.elementwise_kernel(lambda x, y: x + y)(np.ones(4, np.float32),
                                                   np.ones(5, np.float32))


@pytest.mark.parametrize("shape", [(16, 256), (8, 1280), (5, 33), (2, 3, 64)],
                         ids=str)
@pytest.mark.parametrize("op", ["sum", "max"])
def test_row_reduce_ref_matches_pallas_factory(shape, op):
    """Row sums and row maxima through the port's factory against the JAX
    factory (Pallas interpret for aligned shapes, its jnp route for (5, 33));
    the port walks the same column blocks in order. Sums: fp32 summation
    order; maxima: exact."""
    from paddle_tpu.kernels import primitive as jkp
    from paddle_tpu_torch.kernels import primitive as P

    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    if op == "sum":
        jfn, tfn, init = (lambda acc, b: acc + b.sum(-1),
                          lambda acc, b: acc + b.sum(-1), 0.0)
    else:
        jfn, tfn, init = (lambda acc, b: jnp.maximum(acc, b.max(-1)),
                          lambda acc, b: torch.maximum(acc, b.amax(-1)),
                          float("-inf"))
    want = np.asarray(jkp.row_reduce_kernel(jfn, init)(x))
    got = P.row_reduce_kernel(tfn, init)(torch.from_numpy(x))
    assert got.shape == shape[:-1] and got.dtype == torch.float32
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    else:
        assert np.array_equal(got.numpy(), want)


def test_primitive_factories_reject_what_the_kernel_cannot_express():
    """An op outside the table raises when the factory is called, naming
    the op; so do a reduction inside an elementwise kernel, a reduction
    that keeps its axis, and a tensor closed over."""
    from paddle_tpu_torch.kernels import primitive as P

    with pytest.raises(ValueError, match="'sin'"):
        P.elementwise_kernel(lambda x: torch.sin(x))
    with pytest.raises(ValueError, match="'cumsum'"):
        P.row_reduce_kernel(lambda acc, b: acc + b.cumsum(-1)[:, -1], 0.0)
    with pytest.raises(ValueError, match="last axis"):
        P.elementwise_kernel(lambda x: x.sum(-1))
    with pytest.raises(ValueError, match="last axis"):
        P.row_reduce_kernel(lambda acc, b: acc + b.sum(-1, keepdim=True), 0.0)
    with pytest.raises(ValueError, match="one value per row"):
        P.row_reduce_kernel(lambda acc, b: b * 2.0, 0.0)
    t = torch.ones(3)
    with pytest.raises(ValueError, match="pass tensors as operands"):
        P.elementwise_kernel(lambda x: x + t)


@pytest.mark.parametrize("fn", [
    lambda x, y, a: x + a * y,
    lambda x, y, a: x + a * torch.tanh(y),
    lambda x: torch.where(x > 0, x, 0.5 * x) / 2.0 + x ** 2,
    lambda x, y: torch.maximum(torch.sigmoid(x), torch.exp(-abs(y)))
    - torch.rsqrt(1.0 + torch.abs(y)) * torch.log(torch.sqrt(1 + x * x)),
], ids=["axpy", "tanh", "where_pow", "math"])
def test_elementwise_source_is_python_and_plain_matches_torch(fn):
    """The generated Triton source parses as Python (the card compiles it),
    and the plain version is ``fn`` in fp32 cast to the first operand's
    dtype."""
    from paddle_tpu_torch.kernels import primitive as P

    op = P.elementwise_kernel(fn)
    compile(op.source, "<primitive>", "exec")
    rng = np.random.default_rng(12)
    n = fn.__code__.co_argcount
    xs = [torch.from_numpy(rng.standard_normal((4, 9)).astype(np.float32))
          .to(torch.bfloat16) for _ in range(n)]
    assert torch.equal(op(*xs), fn(*(x.float() for x in xs)).to(torch.bfloat16))
