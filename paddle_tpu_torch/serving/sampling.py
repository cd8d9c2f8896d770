"""Per-request sampling for the serving engine
(``paddle_tpu/serving/sampling.py`` analog).

Two faces over the same math (temperature scale -> top-k filter ->
categorical draw, or plain argmax). Random draws come from an explicit
``torch.Generator``; greedy is an exact argmax (first maximum on ties, as
in JAX), so greedy output is token-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass
class SamplingParams:
    """Per-request decoding controls."""

    max_new_tokens: int = 16
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0            # 0 = no top-k filter
    eos_token_id: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


def _categorical(logits, generator):
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _top_k_filter(logits, k):
    """Keep each row's k largest logits, -1e30 the rest (k <= 0 or >= V is
    a no-op)."""
    V = logits.shape[-1]
    k_eff = min(int(k), V)
    if k_eff <= 0 or k_eff >= V:
        return logits
    kth = torch.topk(logits, k_eff, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def sample_static(logits, key, do_sample: bool, temperature: float,
                  top_k: int):
    """[B, V] logits -> [B] token ids with call-wide scalar params. ``key``
    is the ``torch.Generator`` the draws come from (where the JAX package
    takes a PRNG key)."""
    if not do_sample:
        return logits.argmax(dim=-1)
    lf = logits.float() / max(float(temperature), 1e-6)
    return _categorical(_top_k_filter(lf, top_k), key)


def sample_batched(logits, key, temperatures, top_ks, greedy):
    """[B, V] logits -> [B] token ids with per-row parameter tensors:
    ``temperatures`` [B] f32, ``top_ks`` [B] int (0 = off), ``greedy`` [B]
    bool. As in the JAX decode program, every row is drawn and greedy rows
    take their argmax by ``torch.where``: nothing is read on the host, so
    a CUDA graph can capture the call, and each call advances the
    generator ``key`` (the JAX package's PRNG key) whatever the batch
    holds."""
    lf = logits.float()
    V = lf.shape[-1]
    scaled = lf / temperatures.float().clamp(min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_ks.long() - 1).clamp(0, V - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    filter_on = (top_ks > 0) & (top_ks < V)
    filtered = torch.where(filter_on[:, None] & (scaled < kth),
                           torch.full_like(scaled, NEG_INF), scaled)
    return torch.where(greedy, lf.argmax(dim=-1),
                       _categorical(filtered, key))
