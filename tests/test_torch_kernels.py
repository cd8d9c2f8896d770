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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
def test_paged_ref_matches_pallas(rep, dtype):
    q, kp, vp, table, pos = _paged_inputs(rep)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    want = j_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                   interpret=True)
    got = K.paged_attention(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(pos))
    assert got.shape == (3, 2 * rep, 1, 8) and got.dtype == tv.dtype
    assert torch.isfinite(got).all()  # the empty slot reads trash page 0
    assert _max_err(want, got) <= TOL[dtype]


def test_wrappers_reject_other_devices():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_layer_norm(x, x[0], x[0])
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_adamw_update(x, x, x, x, lr=1e-3, beta1=0.9, beta2=0.999,
                             eps=1e-8, weight_decay=0.0, beta1_pow=0.9,
                             beta2_pow=0.999)


# ---------------- flash attention backward ---------------------------------
def _torch_grads(q, k, v, g, causal):
    """Grads of ``sum(o * g)`` through the port's ``FlashAttention``
    (on the CPU: the plain forward, then ``flash_attention_bwd_ref``)."""
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = K.flash_attention(*xs, causal=causal)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    o.backward(g)
    return [t.grad for t in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_pallas_bwd(dtype, causal):
    """dq/dk/dv of ``flash_attention_bwd_ref`` (fed the Pallas forward's O
    and LSE) and of the ``FlashAttention`` Function's CPU backward, against
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_bwd_matches_jax_grad(dtype):
    """dx, dw, db of ``LayerNormFunction`` against ``jax.grad`` through the
    Pallas ``fused_layer_norm`` (whose backward is ``_ln_bwd_rule``). The
    port repeats that rule's arithmetic: fp32 differs by summation order;
    bf16 outputs (|dx| < 4, |dw|, |db| < 16) by at most one rounding step
    of their magnitude (2^-6 relative)."""
    rng = np.random.default_rng(6)
    R, H = 12, 48
    x = (rng.standard_normal((3, R // 3, H)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(H)).astype(np.float32)
    g = rng.standard_normal((3, R // 3, H)).astype(np.float32)
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
    y.backward(tg)
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
