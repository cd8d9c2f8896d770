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

from paddle_tpu.kernels import flash_attention as jfa
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
