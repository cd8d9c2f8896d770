"""GPT: the flagship decoder-only LM (``paddle_tpu/models/gpt.py`` analog),
dense path.

Module and parameter names match the JAX package's, and weights keep its
``[in, out]`` layout, so ``weights.from_paddle_tpu`` loads a converted
``paddle_tpu`` parameter dict name for name. Attention runs through
``nn.functional.scaled_dot_product_attention`` (the flash kernel) and
LayerNorm through the fused LayerNorm kernel; the serving decode step
attends through the paged-decode kernel (``serving/kv_cache.py``).

Ported: the training path (``forward`` with per-block recompute,
``loss`` and the chunked ``forward_with_loss``) and the serving protocol
(``prefill_with_cache`` and ``decode_step`` over the paged KV layout). MoE,
sharding, ``extend_step`` and the dense-cache ``generate`` belong to later
slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..distributed.fleet.recompute import recompute
from ..nn import Dropout, Embedding, LayerNorm
from ..nn import functional as F


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = None  # grouped-query attention (None = full MHA)
    max_seq_len: int = 1024
    intermediate_size: int = None
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    use_recompute: bool = False
    recompute_policy: str = None  # None/'full' (the save-some policies are
    #                               ROADMAP queue A item 3c)
    recompute_interval: int = 1   # recompute every k-th block
    loss_chunk: int = 0           # CE in sequence chunks of this size (0 =
    #                               off): no [B, S, V] fp32 logits
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide num_heads")
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


# GPT-3 1.3B — the JAX package's BASELINE.json pretrain config
GPT3_1p3B = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                 num_heads=16, max_seq_len=2048)
GPT_TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=64)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        self.qkv = ColumnParallelLinear(cfg.hidden_size, qkv_out,
                                        gather_output=False, device=device,
                                        dtype=dtype)
        self.proj = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                      input_is_parallel=True, device=device,
                                      dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def _split(self, qkv, B, S):
        cfg = self.cfg
        Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = qkv[:, :, :Hq * D].reshape(B, S, Hq, D)
        k = qkv[:, :, Hq * D:(Hq + Hkv) * D].reshape(B, S, Hkv, D)
        v = qkv[:, :, (Hq + Hkv) * D:].reshape(B, S, Hkv, D)
        return q, k, v

    def forward(self, x, kv_cache=None, cache_positions=None,
                return_kv=False):
        B, S = x.shape[0], x.shape[1]
        qkv = self.qkv(x)
        if return_kv or kv_cache is not None:
            return self._serving_forward(qkv, B, S, kv_cache,
                                         cache_positions, return_kv)
        q, k, v = self._split(qkv, B, S)
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.cfg.dropout, is_causal=True,
            training=self.training)
        return self.dropout(self.proj(out.reshape(B, S, self.cfg.hidden_size)))

    def _serving_forward(self, qkv, B, S, kv_cache, cache_positions,
                         return_kv):
        """Prefill (``return_kv=True``): causal attention over the padded
        prompt plus this layer's K/V in cache layout ``[B, H_kv, S, D]``.
        Paged decode (``kv_cache=(k_pool, v_pool, page_table)``, ``S == 1``):
        write the token's K/V into the pools in place at
        ``cache_positions``, then attend the slot's live pages."""
        from ..serving import kv_cache as _kvc

        q, k, v = self._split(qkv, B, S)
        if return_kv:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=False)
            out = out.reshape(B, S, self.cfg.hidden_size)
            return (self.dropout(self.proj(out)),
                    (k.transpose(1, 2), v.transpose(1, 2)))
        if len(kv_cache) != 3 or S != 1:
            raise NotImplementedError(
                "only the paged single-token decode step is ported; the "
                "dense cache and extend_step are ROADMAP queue A item 1/2")
        kc, vc, table = kv_cache
        _kvc.paged_write_kv(kc, k.transpose(1, 2), table, cache_positions)
        _kvc.paged_write_kv(vc, v.transpose(1, 2), table, cache_positions)
        o = _kvc.paged_decode_attend(q.transpose(1, 2), kc, vc, table,
                                     cache_positions)
        out = o.transpose(1, 2).reshape(B, S, self.cfg.hidden_size)
        return self.dropout(self.proj(out)), (kc, vc)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size,
                                        gather_output=False, device=device,
                                        dtype=dtype)
        self.fc2 = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size,
                                     input_is_parallel=True, device=device,
                                     dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                             device=device, dtype=dtype)
        self.attn = GPTAttention(cfg, device, dtype)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                             device=device, dtype=dtype)
        self.mlp = GPTMLP(cfg, device, dtype)

    def forward(self, x, kv_cache=None, cache_positions=None,
                return_kv=False):
        if return_kv or kv_cache is not None:
            a, kv = self.attn(self.ln1(x), kv_cache=kv_cache,
                              cache_positions=cache_positions,
                              return_kv=return_kv)
            x = x + a
            return x + self.mlp(self.ln2(x)), kv
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.position_embeddings = Embedding(cfg.max_seq_len, cfg.hidden_size,
                                             device=device, dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        h = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        return self.dropout(h)


class GPTModel(nn.Module):
    """Transformer trunk: embeddings -> blocks -> final LN."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, device, dtype)
        self.layers = nn.ModuleList(GPTBlock(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                  device=device, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's init: every matrix from N(0, std), biases zero,
        LayerNorm weights one."""
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            elif "bias" in name:
                p.zero_()
            else:
                p.fill_(1.0)

    def forward(self, input_ids, position_ids=None, kv_caches=None,
                cache_positions=None, return_kv=False):
        h = self.embeddings(input_ids, position_ids)
        if return_kv or kv_caches is not None:
            kvs = []
            for i, block in enumerate(self.layers):
                cache_i = kv_caches[i] if kv_caches is not None else None
                h, kv = block(h, kv_cache=cache_i,
                              cache_positions=cache_positions,
                              return_kv=return_kv)
                kvs.append(kv)
            return self.final_ln(h), kvs
        interval = max(self.cfg.recompute_interval, 1)
        for i, block in enumerate(self.layers):
            if self.cfg.use_recompute and self.training and i % interval == 0:
                h = recompute(block, h, policy=self.cfg.recompute_policy)
            else:
                h = block(h)
        return self.final_ln(h)


class GPTForCausalLM(nn.Module):
    """Trunk + (tied) LM head.

    ``device`` defaults to ``cuda`` (raising without a card); ``dtype`` to
    float32. Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted) with the JAX package's init."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator: torch.Generator = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False,
                gather_output=False, device=device, dtype=dtype)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.gpt.init_weights(generator)
        if not cfg.tie_word_embeddings:
            with torch.no_grad():
                self.lm_head.weight.normal_(0.0, cfg.initializer_range,
                                            generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.final_ln.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.final_ln.weight.dtype

    def _logits(self, h):
        if self.cfg.tie_word_embeddings:
            return torch.matmul(h, self.gpt.embeddings.word_embeddings.weight.t())
        return self.lm_head(h)

    def forward(self, input_ids, position_ids=None):
        return self._logits(self.gpt(input_ids, position_ids))

    def loss(self, logits, labels):
        """Next-token CE, labels already shifted by the data pipeline."""
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, V),
                               labels.reshape(-1)).mean()

    def forward_with_loss(self, input_ids, labels):
        """Trunk and loss in one call. With ``cfg.loss_chunk`` dividing S,
        the LM head and the fp32 cross-entropy run per sequence chunk under
        ``recompute``, so the ``[B, S, V]`` fp32 logits never
        exist; the loss is the sum over chunks over ``B*S``. Otherwise it
        is ``loss(forward(input_ids), labels)``."""
        chunk = self.cfg.loss_chunk
        B, S = input_ids.shape
        if not chunk or S % chunk:
            return self.loss(self.forward(input_ids), labels)
        h = self.gpt(input_ids)
        W = (self.gpt.embeddings.word_embeddings.weight
             if self.cfg.tie_word_embeddings else self.lm_head.weight)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(0, S, chunk):
            total = total + recompute(self._chunk_ce, h[:, c:c + chunk],
                                      labels[:, c:c + chunk], W)
        return total / (B * S)

    def _chunk_ce(self, h_c, y_c, W):
        logits = (h_c @ (W.t() if self.cfg.tie_word_embeddings else W)).float()
        gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    # ---- serving decode protocol (paddle_tpu_torch/serving engine) ----
    def prefill_with_cache(self, input_ids, lengths=None, position_ids=None):
        """One causal forward over the (right-padded) prompt ``[B, T]`` that
        also returns each layer's K/V in cache layout ``[B, H_kv, T, D]``.
        ``lengths`` (``[B]``, or None for the full width) selects each row's
        last real token; returns ``(last_logits [B, V], kvs)``."""
        B, T = input_ids.shape
        h, kvs = self.gpt(input_ids, position_ids=position_ids,
                          return_kv=True)
        if lengths is None:
            h_last = h[:, T - 1:T]
        else:
            idx = (torch.as_tensor(lengths, device=h.device).long() - 1) \
                .clamp(0, T - 1)
            h_last = torch.gather(
                h, 1, idx[:, None, None].expand(B, 1, h.shape[-1]))
        return self._logits(h_last)[:, 0], kvs

    def decode_step(self, tokens, kv_caches, positions):
        """One cached decode step: ``tokens`` ``[B]`` (or ``[B, 1]``) ids,
        ``kv_caches`` a per-layer list of paged ``(k_pool, v_pool,
        page_table)`` triples (pools ``[P, H_kv, ps, D]``, updated in
        place), ``positions`` ``[B]`` — the index each row's token is
        written at. Returns ``(logits [B, V], per-layer (k_pool, v_pool))``."""
        ids = tokens[:, None] if tokens.dim() == 1 else tokens
        pos = torch.as_tensor(positions, device=ids.device).to(torch.int32)
        if pos.dim() == 0:
            pos = pos.expand(ids.shape[0])
        # position embedding indices clamp at the table edge, as the JAX
        # package's clamping gather does
        position_ids = pos.clamp(0, self.cfg.max_seq_len - 1).long()[:, None]
        h, new = self.gpt(ids, position_ids=position_ids,
                          kv_caches=kv_caches, cache_positions=pos)
        return self._logits(h)[:, -1], new
