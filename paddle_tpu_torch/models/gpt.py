"""GPT: the flagship decoder-only LM (``paddle_tpu/models/gpt.py`` analog),
dense path.

Module and parameter names match the JAX package's, and weights keep its
``[in, out]`` layout, so ``weights.from_paddle_tpu`` loads a converted
``paddle_tpu`` parameter dict name for name. Attention runs through
``nn.functional.scaled_dot_product_attention`` (the flash kernel) and
LayerNorm through the fused LayerNorm kernel; the serving decode step
attends through the paged-decode kernel over the paged KV layout, and
through the plain ``decode_attend`` over the dense one
(``serving/kv_cache.py``).

Ported: the training path (``forward`` with per-block recompute,
``loss`` and the chunked ``forward_with_loss``), the serving protocol over
both KV layouts (``prefill_with_cache``, ``decode_step``, and on the paged
layout the multi-token ``extend_step`` of prefix-cache suffix prefills and
speculative verify), ``generate``, and GPT-MoE on one device
(``GPTMoEMLP`` in every ``moe_every_k``-th block, routed by
``incubate.distributed.models.moe.moe_route``). Data parallelism is the
train step's. Under expert parallelism (the ``fleet.init`` topology's
``ep`` axis) each GPT-MoE block holds its ep rank's ``E/ep`` experts and
routes this rank's tokens at their places in the global batch over the
data axes, the gate whole on every rank. Under tensor parallelism (an mp group of more than one
rank, the ``fleet.init`` topology's) each rank holds its block of the mp
layers, as the JAX package's ``gpt.py`` annotates them: attention over
its ``num_heads/mp`` query and ``num_kv_heads/mp`` K/V heads (the fused
qkv projection's columns are three segments, q | k | v, each split by
head), the MLP column- then row-parallel, the vocabulary-parallel
embedding and tied logits ``c_identity(h) @ W_local.T`` of
``[B, S, V/mp]``, and the loss through the vocabulary-parallel cross
entropy (``forward_with_loss`` unchunked, as the JAX package's at mp). A
GPT-MoE block at mp holds its experts whole on every rank of the mp group
(placed ``P("ep", ...)`` only), as the JAX package places them: the mp
ranks route the same rows through the same experts. Pipeline and
sequence parallelism (ROADMAP queue A items A5.6, A5.7) raise.

The serving protocol runs on a split model too: at mp each rank's
attention prefills and decodes over its own query and K/V heads (its KV
cache holds its ``num_kv_heads/mp`` heads only), the row-parallel
projections all-reduce as in training, and the vocabulary-parallel
logits are gathered over mp (``mp_ops.c_concat``) into the whole ``[B, V]``
before anything samples them, so every rank sees the same bits. A GPT-MoE
block served at ep routes the rows, which are the same on every rank, as
one process would (the capacity of their ``T``), runs this rank's
``E/ep`` experts on their slots and gathers the experts' outputs over ep
before the combine (``moe_route(replicated=)``): the one process's values,
bit for bit.
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
    mp_ops,
)
from ..distributed.fleet.meta_parallel.mp_layers import mp_group_of
from ..distributed.fleet.recompute import recompute
from ..distributed.mesh import PartitionSpec
from ..distributed.sharding_utils import annotate_parameter
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
    sequence_parallel: bool = False
    context_parallel: str = "ring"  # attention scheme under a sep axis
    use_recompute: bool = False
    recompute_policy: str = None  # None/'full', 'dots_saveable',
    #                               'dots_with_no_batch_dims_saveable',
    #                               'save_flash' (fleet/recompute.py)
    recompute_interval: int = 1   # recompute every k-th block
    loss_chunk: int = 0           # CE in sequence chunks of this size (0 =
    #                               off): no [B, S, V] fp32 logits
    initializer_range: float = 0.02
    # GPT-MoE: the reference's defaults; ``moe_num_experts`` 0 is the dense
    # FFN everywhere, and the other fields act only with experts
    moe_num_experts: int = 0
    moe_every_k: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "dense"

    def __post_init__(self):
        for what, on, item in (
                ("sequence_parallel", self.sequence_parallel, "A5.7"),
                ("context_parallel", self.context_parallel != "ring", "A5.7")):
            if on:
                raise NotImplementedError(
                    f"GPTConfig.{what}={getattr(self, what)!r} is not ported "
                    f"yet (ROADMAP queue A item {item})")
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
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        n = mp_group_of(None).nranks
        if cfg.num_heads % n or cfg.num_kv_heads % n:
            raise ValueError(f"num_heads {cfg.num_heads} and num_kv_heads "
                             f"{cfg.num_kv_heads} must divide by the mp "
                             f"degree {n}")
        # heads of this rank
        self.num_heads, self.num_kv_heads = cfg.num_heads // n, \
            cfg.num_kv_heads // n
        D = cfg.head_dim
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, (cfg.num_heads + 2 * cfg.num_kv_heads) * D,
            gather_output=False, device=device, dtype=dtype,
            segments=(cfg.num_heads * D, cfg.num_kv_heads * D,
                      cfg.num_kv_heads * D))
        self.proj = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                      input_is_parallel=True, device=device,
                                      dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def _split(self, qkv, B, S):
        Hq, Hkv, D = self.num_heads, self.num_kv_heads, self.cfg.head_dim
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
        out = out.reshape(B, S, self.num_heads * self.cfg.head_dim)
        return self.dropout(self.proj(out))

    def _serving_forward(self, qkv, B, S, kv_cache, cache_positions,
                         return_kv):
        """Prefill (``return_kv=True``): causal attention over the padded
        prompt plus this layer's K/V in cache layout ``[B, H_kv, S, D]``.
        Paged (``kv_cache=(k_pool, v_pool, page_table)``): write the ``S``
        tokens' K/V into the pools in place, token ``t`` of row ``b`` at
        ``cache_positions[b] + t``, then attend: one token through the
        paged-decode kernel, several (``extend_step``) through
        ``paged_extend_attend``. Dense (``kv_cache=(k, v)``, each
        ``[B, H_kv, S_max, D]``): write the one token at
        ``cache_positions``, then ``decode_attend`` over all ``S_max``
        positions, masked to the valid prefix. At mp every tensor here is
        this rank's heads (``num_heads/mp`` and ``num_kv_heads/mp``), and
        the row-parallel ``proj`` sums the ranks' outputs."""
        from ..serving import kv_cache as _kvc

        q, k, v = self._split(qkv, B, S)
        width = self.num_heads * self.cfg.head_dim
        if return_kv:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=False)
            out = out.reshape(B, S, width)
            return (self.dropout(self.proj(out)),
                    (k.transpose(1, 2), v.transpose(1, 2)))
        if len(kv_cache) == 3:
            kc, vc, table = kv_cache
            _kvc.paged_write_kv(kc, k.transpose(1, 2), table,
                                cache_positions)
            _kvc.paged_write_kv(vc, v.transpose(1, 2), table,
                                cache_positions)
            attend = (_kvc.paged_decode_attend if S == 1
                      else _kvc.paged_extend_attend)
            o = attend(q.transpose(1, 2), kc, vc, table, cache_positions)
        else:
            if S > 1:
                raise NotImplementedError(
                    "multi-token cached decode (extend_step / speculative "
                    "verify) requires the paged KV layout; the dense cache "
                    "only decodes one token per step")
            kc, vc = kv_cache
            _kvc.write_kv(kc, k.transpose(1, 2), cache_positions)
            _kvc.write_kv(vc, v.transpose(1, 2), cache_positions)
            o = _kvc.decode_attend(q.transpose(1, 2), kc, vc,
                                   cache_positions)
        out = o.transpose(1, 2).reshape(B, S, width)
        return self.dropout(self.proj(out)), (kc, vc)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
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


class GPTMoEMLP(nn.Module):
    """The GPT-MoE block's FFN: ``moe_num_experts`` experts as stacked
    parameters (``w1 [E, d, f]``, ``b1 [E, f]``, ``w2 [E, f, d]``,
    ``b2 [E, d]``) behind a gate ``gate_weight [d, E]``, routed by
    ``moe_route`` (GShard when ``moe_top_k`` is 2, else Switch) at
    capacity ``max(1, int(moe_capacity_factor * T / E))`` for the ``T``
    tokens of the global batch. The experts run in the activation dtype:
    two batched products with the tanh GELU between them. ``aux_loss``
    holds the gate's load-balancing term of the last forward.

    Built after ``fleet.init`` with an ``ep`` axis of ``n`` ranks, the
    block holds its ep rank's ``E/n`` experts (the stacks' dim 0, placed
    ``P("ep", ...)`` as the JAX package annotates them) and routes over
    the topology's ``moe_groups()``; the gate is whole. Over an mp group
    every rank holds the same experts and routes the same rows.

    ``local_ep`` (set for its own forward by the train step whose explicit
    gradient reduction runs over an ep axis, as the JAX step's fully-manual
    region does, and ``None`` again after it) makes
    each rank route its own rows alone, at the capacity of its own ``T``,
    over the whole stacks gathered over that group; their gradients
    collect, whole, in ``whole_grads``.

    ``forward(x, replicated=True)`` (the serving forward) takes rows that
    are the same on every rank: they are routed as one process routes
    them, at the capacity of their own ``T``, and each ep rank runs its
    experts on their slots (``moe_route(replicated=)``)."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        from ..incubate.distributed.models.moe.moe_layer import moe_groups

        E, d, f = cfg.moe_num_experts, cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.groups = moe_groups()
        n = self.groups.ep.nranks if self.groups is not None else 1
        if E % n:
            raise ValueError(f"moe_num_experts {E} must divide by the ep "
                             f"degree {n}")

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device,
                                            dtype=dtype))

        self.gate_weight = param(d, E)
        self.w1, self.b1 = param(E // n, d, f), param(E // n, f)
        self.w2, self.b2 = param(E // n, f, d), param(E // n, d)
        for p in (self.w1, self.b1, self.w2, self.b2):
            annotate_parameter(p, PartitionSpec(
                "ep", *[None] * (p.dim() - 1)))
        self.dropout = Dropout(cfg.dropout)
        self.aux_loss = None
        self.local_ep = None
        self.whole_grads = {}

    def _stacks(self):
        """``(w1, b1, w2, b2)`` as the forward uses them: this rank's, or
        under ``local_ep`` the whole ones."""
        from ..incubate.distributed.models.moe.moe_layer import _WholeStack

        ws = (self.w1, self.b1, self.w2, self.b2)
        if self.local_ep is None:
            return ws
        return tuple(_WholeStack.apply(w, self.local_ep, self.whole_grads, k)
                     for k, w in zip(("w1", "b1", "w2", "b2"), ws))

    def _experts(self, ein, stacks):
        """``[E, C, d]`` -> ``[E, C, d]``, every expert of ``stacks``
        (``w1, b1, w2, b2``) at once."""
        w1, b1, w2, b2 = stacks
        dt = ein.dtype
        h = torch.bmm(ein, w1.to(dt)) + b1.to(dt)[:, None]
        h = F.gelu(h, approximate=True)
        return torch.bmm(h, w2.to(dt)) + b2.to(dt)[:, None]

    def forward(self, x, *, replicated: bool = False):
        from ..incubate.distributed.models.moe.moe_layer import moe_route

        cfg = self.cfg
        B, S, d = x.shape
        xt = x.reshape(-1, d)
        groups = self.groups if self.local_ep is None else None
        ep = None
        if replicated and groups is not None:
            groups, ep = None, groups.ep
        T = xt.shape[0] * (groups.data.nranks if groups else 1)
        capacity = max(1, int(cfg.moe_capacity_factor * T
                              / cfg.moe_num_experts))
        stacks = self._stacks()
        out, aux = moe_route(
            xt, self.gate_weight, "gshard" if cfg.moe_top_k == 2 else "switch",
            capacity, lambda ein: self._experts(ein, stacks),
            dispatch_mode=cfg.moe_dispatch, groups=groups, replicated=ep)
        self.aux_loss = aux
        return self.dropout(out.reshape(B, S, d))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, use_moe: bool = False, *, device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                             device=device, dtype=dtype)
        self.attn = GPTAttention(cfg, device=device, dtype=dtype)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                             device=device, dtype=dtype)
        self.mlp = (GPTMoEMLP if use_moe else GPTMLP)(cfg, device=device,
                                                       dtype=dtype)

    def forward(self, x, kv_cache=None, cache_positions=None,
                return_kv=False):
        if return_kv or kv_cache is not None:
            a, kv = self.attn(self.ln1(x), kv_cache=kv_cache,
                              cache_positions=cache_positions,
                              return_kv=return_kv)
            x = x + a
            h = self.ln2(x)
            # the served rows are the same on every rank
            h = self.mlp(h, replicated=True) if isinstance(
                self.mlp, GPTMoEMLP) else self.mlp(h)
            return x + h, kv
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
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

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, device=device, dtype=dtype)
        k = max(cfg.moe_every_k, 1)
        self.layers = nn.ModuleList(
            GPTBlock(cfg, use_moe=cfg.moe_num_experts > 0 and i % k == k - 1,
                     device=device, dtype=dtype)
            for i in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                  device=device, dtype=dtype)
        self.moe_aux_loss = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's init: every tensor of rank 2 or more (the MoE
        FFN's stacked biases included) from N(0, std), biases zero,
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
        if any(b is None for b in self.layers):
            raise RuntimeError(
                "this model holds its pipeline stage's blocks only: it runs "
                "through the pipelined train step")
        interval = max(self.cfg.recompute_interval, 1)
        aux = None
        for i, block in enumerate(self.layers):
            moe = isinstance(block.mlp, GPTMoEMLP)
            # MoE blocks run outside recompute, as in the JAX package
            # (their aux loss is read by the loss of this forward)
            if self.cfg.use_recompute and self.training \
                    and i % interval == 0 and not moe:
                h = recompute(block, h, policy=self.cfg.recompute_policy)
            else:
                h = block(h)
            if moe and block.mlp.aux_loss is not None:
                aux = block.mlp.aux_loss if aux is None \
                    else aux + block.mlp.aux_loss
        self.moe_aux_loss = aux
        return self.final_ln(h)


class GPTForCausalLM(nn.Module):
    """Trunk + (tied) LM head.

    ``device`` defaults to ``cuda`` (raising without a card); ``dtype`` to
    float32. Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted) with the JAX package's init."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None,
                 generator: torch.Generator = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device, dtype=dtype)
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

    @property
    def mp_group(self):
        """The group the model's mp layers are split over."""
        return self.gpt.embeddings.word_embeddings.mp_group

    @property
    def local_kv_heads(self) -> int:
        """The K/V heads this rank's attention holds (``num_kv_heads/mp``),
        which its serving caches are sized by."""
        return next(b for b in self.gpt.layers
                    if b is not None).attn.num_kv_heads

    def _logits(self, h):
        """Logits, this rank's ``V/mp`` of them at mp above 1."""
        if self.cfg.tie_word_embeddings:
            W = self.gpt.embeddings.word_embeddings.weight
            return torch.matmul(mp_ops.c_identity(h, self.mp_group), W.t())
        return self.lm_head(h)

    def _whole_logits(self, h):
        """The serving logits: whole ``[..., V]`` on every rank, this
        rank's ``V/mp`` gathered over mp (the same bits on every rank)."""
        logits = self._logits(h)
        if self.mp_group.nranks > 1:
            logits = mp_ops.c_concat(logits, self.mp_group, dim=-1)
        return logits

    def forward(self, input_ids, position_ids=None):
        return self._logits(self.gpt(input_ids, position_ids))

    def _moe_aux(self):
        """The weighted MoE load-balancing term of the last trunk forward
        (None for a dense model)."""
        aux = self.gpt.moe_aux_loss
        return None if aux is None else aux * self.cfg.moe_aux_weight

    def loss(self, logits, labels):
        """Next-token CE, labels already shifted by the data pipeline. A
        MoE model's aux term is added by ``forward_with_loss``; this method
        sees only logits."""
        V = logits.shape[-1]
        if self.mp_group.nranks > 1:  # vocabulary-sharded logits
            return mp_ops.parallel_cross_entropy(
                logits.reshape(-1, V), labels.reshape(-1),
                self.mp_group).mean()
        return F.cross_entropy(logits.reshape(-1, V),
                               labels.reshape(-1)).mean()

    def forward_with_loss(self, input_ids, labels):
        """Trunk and loss in one call. With ``cfg.loss_chunk`` dividing S,
        the LM head and the fp32 cross-entropy run per sequence chunk under
        ``recompute``, so the ``[B, S, V]`` fp32 logits never
        exist; the loss is the sum over chunks over ``B*S``. Otherwise, and
        at mp above 1 (whose logits go through the vocabulary-parallel
        cross entropy), it is ``loss(forward(input_ids), labels)``. A MoE
        model adds ``moe_aux_weight`` times the blocks' summed aux loss
        either way."""
        loss = self._lm_loss(self.gpt(input_ids), labels)
        aux = self._moe_aux()
        return loss if aux is None else loss + aux

    def _lm_loss(self, h, labels):
        """The LM head and the mean cross entropy on the trunk's output
        ``h`` (after the final LayerNorm): per sequence chunk as
        ``forward_with_loss`` says, else on the whole logits."""
        chunk = self.cfg.loss_chunk
        B, S = labels.shape
        if not chunk or S % chunk or self.mp_group.nranks > 1:
            return self.loss(self._logits(h), labels)
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

    # ---- the pipeline-parallel protocol (PipelineSpec) ----
    def embed(self, input_ids):
        """The pipeline's first stage before the blocks: the embeddings."""
        return self.gpt.embeddings(input_ids)

    def head_loss(self, h, labels):
        """The pipeline's last stage after the blocks: the final LayerNorm,
        the LM head and the cross entropy, per sequence chunk under
        ``cfg.loss_chunk`` as in ``forward_with_loss``. The chunked sum
        agrees with the JAX package's ``head_loss`` on the whole logits to
        fp32 rounding (its order of summation is the only difference)."""
        return self._lm_loss(self.gpt.final_ln(h), labels)

    def pipeline_spec(self):
        """The ``PipelineSpec`` the train step pipelines this model by
        under a ``pp`` axis: the embeddings before the homogeneous
        ``gpt.layers`` stack, the final LayerNorm, head and loss after it.
        A GPT-MoE model pipelines with every block MoE only
        (``moe_every_k=1``), its gate's aux through ``block_with_aux``."""
        from ..distributed.fleet.meta_parallel.pipeline_parallel import \
            make_layer_stack_pipeline_spec

        layer = next(b for b in self.gpt.layers if b is not None)
        if self.cfg.moe_num_experts > 0:
            if self.cfg.moe_every_k != 1:
                raise NotImplementedError(
                    "pipelined GPT-MoE needs a homogeneous stack: set "
                    "moe_every_k=1 (every block MoE) so the scanned stage "
                    "params stack; mixed dense/MoE stacks compose with "
                    "dp x ep x sharding x mp instead")
            return make_layer_stack_pipeline_spec(
                self, layer, "gpt.layers", self.cfg.num_layers,
                context_parallel=True, aux_attr="mlp.aux_loss",
                aux_weight=self.cfg.moe_aux_weight)
        return make_layer_stack_pipeline_spec(
            self, layer, "gpt.layers", self.cfg.num_layers,
            context_parallel=True)

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
        return self._whole_logits(h_last)[:, 0], kvs

    def decode_step(self, tokens, kv_caches, positions):
        """One cached decode step: ``tokens`` ``[B]`` (or ``[B, 1]``) ids,
        ``kv_caches`` a per-layer list of either dense ``(k, v)`` entries
        (each ``[B, H_kv, S_max, D]``) or paged ``(k_pool, v_pool,
        page_table)`` triples (pools ``[P, H_kv, ps, D]``, table
        ``[B, num_blocks]`` int32), both updated in place, ``positions``
        ``[B]`` (or a scalar) — the index each row's token is written at.
        Returns ``(logits [B, V], per-layer (k, v))``: the caches
        themselves (a paged table is host state and is not returned)."""
        ids = tokens[:, None] if tokens.dim() == 1 else tokens
        pos = torch.as_tensor(positions, device=ids.device).to(torch.int32)
        if pos.dim() == 0:
            pos = pos.expand(ids.shape[0])
        # position embedding indices clamp at the table edge, as the JAX
        # package's clamping gather does
        position_ids = pos.clamp(0, self.cfg.max_seq_len - 1).long()[:, None]
        h, new = self.gpt(ids, position_ids=position_ids,
                          kv_caches=kv_caches, cache_positions=pos)
        return self._whole_logits(h)[:, -1], new

    def extend_step(self, tokens, kv_caches, positions):
        """Multi-token cached step: ``tokens`` ``[B, T]`` ids, row ``b``'s
        token ``t`` written at ``positions[b] + t`` (the speculative verify
        block ``k+1`` wide, or a suffix prefill after a prefix-cache
        splice), over paged ``kv_caches`` as ``decode_step`` takes them.
        Returns ``(logits [B, T, V], per-layer (k_pool, v_pool))``: logits
        at every position, so the caller reads the model's next-token
        choice after each draft. Position ids clamp at the table edge."""
        ids = tokens[:, None] if tokens.dim() == 1 else tokens
        B, T = ids.shape
        pos = torch.as_tensor(positions, device=ids.device).to(torch.int32)
        if pos.dim() == 0:
            pos = pos.expand(B)
        qpos = pos.long()[:, None] + torch.arange(T, device=ids.device)
        h, new = self.gpt(ids, position_ids=qpos.clamp(
            0, self.cfg.max_seq_len - 1), kv_caches=kv_caches,
            cache_positions=pos)
        return self._whole_logits(h), new

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, eos_token_id=None, *,
                 generator: torch.Generator = None):
        """Autoregressive decoding (PaddleNLP ``GenerationMixin.generate``'s
        greedy/sampling core) of ``input_ids`` ``[B, S]``: one prefill and
        one-token decode steps over a dense KV cache; returns the prompt
        and the new tokens as ``[B, S + n]`` ids on the model's device.
        Greedy, temperature and top-k sampling, and the forced-eos fill of
        finished rows with an early stop once every row has finished, as
        the JAX package's. Sampled draws come from ``generator`` (a
        ``torch.Generator`` on the model's device; the device's default
        generator when omitted, which ``torch.manual_seed`` seeds), which
        advances as the draws consume it. On CUDA the prefill and the
        decode step are CUDA graphs captured once per shape and kept with
        their caches on the model (``serving.engine.cached_generate``)."""
        from ..serving.engine import cached_generate

        return cached_generate(
            self, input_ids, max_new_tokens=max_new_tokens,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            eos_token_id=eos_token_id, generator=generator)


def gpt_tiny(*, device=None, dtype=None, generator: torch.Generator = None,
             **overrides) -> GPTForCausalLM:
    """The JAX package's tiny GPT fixture (``GPT_TINY`` with
    ``overrides``)."""
    return GPTForCausalLM(GPTConfig(**{**GPT_TINY, **overrides}),
                          device=device, dtype=dtype, generator=generator)


def gpt_moe_tiny(*, device=None, dtype=None,
                 generator: torch.Generator = None,
                 **overrides) -> GPTForCausalLM:
    """Tiny GPT-MoE fixture: 4 experts, the MoE FFN in every 2nd block."""
    cfg = {**GPT_TINY, "num_layers": 2, "moe_num_experts": 4,
           "moe_every_k": 2, **overrides}
    return GPTForCausalLM(GPTConfig(**cfg), device=device, dtype=dtype,
                          generator=generator)
