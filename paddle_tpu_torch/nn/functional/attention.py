"""Attention functionals (``paddle_tpu/nn/functional/attention.py`` analog).

Inputs are ``[batch, seq, heads, head_dim]`` as in the JAX package. With no
mask and no dropout, attention goes through the flash-attention kernels
(``kernels/flash_attention.py``: forward, and dq/dk/dv when autograd needs
a backward; on the CPU the wrappers run the plain versions) — the same gate
as the JAX package's Pallas path. Otherwise it runs ``_sdpa_ref``. K/V may
carry fewer heads than q (GQA): query head ``h`` reads K/V head
``h // (H // H_kv)``.
"""

from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import flash_attention

NEG_INF = -1e30


def _sdpa_ref(q, k, v, mask=None, dropout_p=0.0, causal=False, scale=None,
              generator=None):
    """Reference lowering: q pre-scaled in its own dtype, fp32 logits,
    -1e30 masking, fp32 softmax, probabilities cast to v's dtype."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf = q * torch.tensor(s, dtype=q.dtype, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf.float(), k.float())
    neg = torch.tensor(NEG_INF, device=q.device)
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(keep, logits, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, neg)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), device=probs.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    if attn_mask is None and dropout_p == 0.0:
        return flash_attention(query, key, value, causal=is_causal)
    return _sdpa_ref(query, key, value, mask=attn_mask,
                     dropout_p=dropout_p if training else 0.0,
                     causal=is_causal, generator=generator)
