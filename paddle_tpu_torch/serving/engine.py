"""LLM serving engine: bucketed prefill + batched decode with continuous
batching over a paged or dense KV cache (``paddle_tpu/serving/engine.py``
analog), and ``cached_generate``, the batch decode loop
``GPTForCausalLM.generate`` rides on.

The JAX engine AOT-compiles one prefill executable and one suffix-prefill
(extend) executable per prompt-length bucket and one decode executable for
its lifetime. The port keeps the same static shapes (power-of-two prefill
buckets, a ``[B_max]`` decode batch, a ``[B_max, num_blocks]`` page table
or a ``[B_max, S_max]`` dense row per slot), and captures each of these
programs as a CUDA graph over static buffers on its first use, replayed
for the engine's lifetime (``serving/graphs.py``): ``"prefill:T"`` and
``"extend:T"`` per bucket, and the per-token ``"decode"`` step or, with
speculation on, ``"verify"``. KV caches and parameters are updated in
place where the JAX engine donated and rebound them.

Request flow: ``add_request`` queues; each ``step()`` first admits waiting
requests into free KV-cache slots (a prefill, or a prefix splice plus a
suffix prefill, and the first token), then runs one batched decode (or
verify-k) step over every running request.

A model split over ranks (built after ``fleet.init`` at mp, at ep, or
both) is served by one engine on every rank, each fed the same requests:
the caches hold this rank's K/V heads, the logits come back whole on
every rank, and every host decision (admission, eviction, prefix matches,
speculative acceptance, finishes, buckets) is taken from the same tokens,
so the ranks stay in lockstep and enter every collective together. A
split model whose groups run on gloo serves eagerly (a CUDA graph cannot
record a host collective; ``graphs.capturable``); over NCCL its programs
are captured as one process's are.

Ported: both KV layouts, the radix prefix cache (``prefix_cache``),
n-gram speculative decoding (``speculative``), ``cached_generate``,
serving a split model and ``load_weights(shardings=)``. Not ported yet,
raising ``NotImplementedError`` naming its ROADMAP item:
``request_trace_dir`` (A6).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.mesh import DeviceMesh, NamedSharding, device_count
from ..distributed.sharding_utils import placement
from ..kernels.paged_attention import no_tpu_tier
from . import graphs as _graphs
from . import sampling as _sampling
from .kv_cache import PAGE_SENTINEL, KVCache, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import FINISHED, PageAllocator, Request, Scheduler
from .speculative import SpeculativeConfig, accept_greedy, propose_ngram


# ---------------------------------------------------------------------------
# Batch decode loop: the static-shape core GPTForCausalLM.generate rides on.
# ---------------------------------------------------------------------------

class _GenerateState(NamedTuple):
    """One shape's programs for ``cached_generate``, kept on the model."""

    key: tuple
    cache: KVCache
    prefill: _graphs.CapturedStep
    decode: _graphs.CapturedStep
    generator: torch.Generator  # the decode graph's own; see cached_generate


def _generate_state(model, key: tuple) -> _GenerateState:
    state = getattr(model, "_generate_state", None)
    if state is not None and state.key == key:
        return state
    # a graph is bound to its buffers: one shape's caches and programs are
    # kept per model, and a new shape releases the old one's before its own
    # are made
    model._generate_state = state = None
    B, S, S_max = key[:3]
    cfg, dev = model.cfg, model.device
    cache = KVCache(cfg.num_layers, B, model.local_kv_heads, S_max,
                    cfg.head_dim, model.dtype, device=dev)
    pre = _graphs.Buffers(
        ids=torch.zeros((B, S), dtype=torch.long, device=dev),
        length=torch.full((B,), S, dtype=torch.long, device=dev),
        row=torch.arange(B, device=dev))
    step = _graphs.StepBuffers(B, None, None, dev)
    gen = torch.Generator(device=dev)
    eager = not _graphs.capturable(model, dev)
    model._generate_state = _GenerateState(
        key, cache,
        _graphs.CapturedStep(_graphs.prefill_program(model, cache, pre, S),
                             pre, dev, eager=eager),
        _graphs.CapturedStep(_graphs.decode_program(model, cache, gen, step),
                             step, dev, gen, eager=eager),
        gen)
    return model._generate_state


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


@torch.no_grad()
def cached_generate(model, input_ids, *, max_new_tokens: int = 32,
                    do_sample: bool = False, temperature: float = 1.0,
                    top_k: int = 0, eos_token_id=None,
                    generator: Optional[torch.Generator] = None):
    """Autoregressive decoding over a static dense KV cache: the body of
    ``GPTForCausalLM.generate`` (the JAX package's ``cached_generate``,
    same semantics). ``input_ids`` ``[B, S]``; returns ``[B, S + n]`` ids
    (the input's dtype, on the model's device), ``n <= max_new_tokens``:
    fewer only when ``eos_token_id`` is set and every row has emitted it,
    rows that finished earlier filled with it. ``max_new_tokens <= 0``
    returns the ids.

    One prefill over the prompt into caches ``[L, B, H_kv, S +
    max_new_tokens, D]``, the first token sampled from its logits, then one
    decode step per token at positions ``S, S+1, ...``. Greedy is the
    argmax; ``do_sample`` draws from the temperature-scaled, top-k
    filtered distribution with ``generator`` (the model device's default
    generator when None), which advances by the draws as an eager run
    would advance it; a greedy call leaves it as it was.

    A model split over ranks is driven on every rank with the same ids;
    its logits are whole on every rank, so the ranks draw the same tokens
    when their generators hold the same state (seed them alike, or pass
    generators seeded alike).

    The JAX package compiles one prefill and one decode executable per
    ``(B, S, S_max, dtypes, do_sample, temperature, top_k)`` per model.
    Here each is a CUDA graph, captured on the first call with a ``(B, S,
    S_max, dtypes)`` key and replayed by every later one; the caches and
    buffers the graphs are bound to stay on the model with them. The
    decode step is the engine's ``decode_program`` over the dense cache:
    the sampling settings are buffers it reads, so a call with other
    settings replays it too. Like the engine's step it draws for greedy
    rows as well and takes their argmax (a sort, a softmax and a draw over
    ``[B, V]`` a step, from the model's own generator, never the
    caller's): one program for every setting, for that cost.
    One key's are kept per model: a call with another key releases them
    first. They are not
    small: the caches alone take ~0.9 GB for GPT-3 1.3B at B 8 × 576
    positions in bf16. With ``eos_token_id`` set, each step reads the
    finished rows on the host (the early stop); without it nothing is read
    until the end."""
    dev = model.device
    ids = torch.as_tensor(input_ids).to(dev)
    if max_new_tokens <= 0:
        return ids
    B, S = int(ids.shape[0]), int(ids.shape[1])
    S_max = S + max_new_tokens
    key = (B, S, S_max, ids.dtype, model.dtype)
    state = _generate_state(model, key)
    if generator is None:
        generator = _default_generator(dev)
    state.generator.set_state(generator.get_state())
    bufs = state.decode.buffers
    bufs.temps.fill_(float(temperature))
    bufs.top_ks.fill_(int(top_k))
    bufs.greedy.fill_(not do_sample)
    out = torch.empty((B, S_max), dtype=ids.dtype, device=dev)
    out[:, :S] = ids
    logits = state.prefill.run(ids=ids)[0]
    nxt = _sampling.sample_static(logits, state.generator,
                                  do_sample=do_sample,
                                  temperature=temperature, top_k=top_k)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    n = max_new_tokens
    for i in range(max_new_tokens):
        if i > 0:
            bufs.tokens.copy_(nxt)
            bufs.positions.fill_(S - 1 + i)
            nxt = state.decode.run()[0]
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished |= nxt == eos_token_id
        out[:, S + i] = nxt
        if eos_token_id is not None and bool(finished.all()):
            n = i + 1
            break
    if do_sample:
        generator.set_state(state.generator.get_state())
    return out[:, :S + n]


@dataclass
class EngineConfig:
    """Static serving envelope, fixed at engine construction."""

    max_batch_size: int = 4      # decode slots (B_max)
    max_seq_len: int = 128       # per-slot prompt + generation budget (S_max)
    prefill_buckets: Optional[Tuple[int, ...]] = None  # default: pow2 <= S_max
    cache_dtype: Optional[str] = None  # default: the model's param dtype
    # request traces and SLO monitoring wait for the observability layer
    # (ROADMAP queue A item A6): set, they raise
    request_trace_dir: Optional[str] = None
    trace_sample_every: int = 1
    slo: Optional[object] = None
    kv_layout: str = "paged"
    page_size: int = 16          # tokens per KV page (shrunk to divide S_max)
    kv_pages: Optional[int] = None  # pool size; default = full budget + trash
    # the JAX package's paged-attend tier ("oracle"|"interpret"|"pallas");
    # the port has one path per device, so only None is accepted
    paged_attention_impl: Optional[str] = None
    # radix prefix cache (prefix_cache.py): finished prompts' full KV
    # blocks stay indexed by content, and a prompt that shares a
    # block-aligned prefix maps the same pages and prefills its suffix only
    prefix_cache: bool = False
    # speculative decoding (speculative.py): True, an int k, or a
    # SpeculativeConfig; the verify-k step then replaces the decode step
    speculative: Optional[Union[bool, int, SpeculativeConfig]] = None

    def __post_init__(self):
        if self.kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout {self.kv_layout!r}; "
                             "want 'paged' or 'dense'")
        for what, on in (("request_trace_dir", self.request_trace_dir),
                         ("slo", self.slo is not None),
                         ("trace_sample_every", self.trace_sample_every != 1)):
            if on:
                raise NotImplementedError(
                    f"EngineConfig.{what} is not ported yet (ROADMAP queue A "
                    "item A6: request traces and SLOs with the "
                    "observability layer)")
        no_tpu_tier("paged_attention_impl", self.paged_attention_impl)
        if isinstance(self.speculative, bool):
            self.speculative = SpeculativeConfig() if self.speculative \
                else None
        elif isinstance(self.speculative, int):
            self.speculative = SpeculativeConfig(k=int(self.speculative))
        if (self.speculative is not None
                and not isinstance(self.speculative, SpeculativeConfig)):
            raise ValueError(
                f"speculative={self.speculative!r}; want True, an int k, or "
                "a SpeculativeConfig")
        if ((self.prefix_cache or self.speculative is not None)
                and self.kv_layout != "paged"):
            raise ValueError(
                "prefix_cache / speculative require kv_layout='paged' "
                "(page-table splices and trash-routed draft writes have no "
                "dense equivalent)")
        while self.page_size > 1 and self.max_seq_len % self.page_size:
            self.page_size //= 2
        if self.prefill_buckets is None:
            buckets = []
            b = 8
            while b < self.max_seq_len:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_seq_len)
            self.prefill_buckets = tuple(buckets)
        else:
            self.prefill_buckets = tuple(sorted(set(self.prefill_buckets)))


class Engine:
    """Offline/online LLM serving engine over a cache-aware causal LM
    (``GPTForCausalLM``'s ``prefill_with_cache`` / ``decode_step`` /
    ``extend_step``).

        engine = Engine(model, EngineConfig(max_batch_size=8,
                                            max_seq_len=2048))
        outputs = engine.generate([[5, 17, 3], [9, 2]],
                                  SamplingParams(max_new_tokens=16))

    ``device`` defaults to ``cuda`` (raising without a card) and must be the
    model's device. Sampled requests draw from ``generator`` (a
    ``torch.Generator`` on that device, seed 0 when omitted: every rank of
    a split model draws alike). ``steps``
    holds the programs made so far (``"prefill:T"`` and ``"extend:T"`` per
    bucket ``T``, ``"decode"``, ``"verify"``), each captured once for the
    engine's lifetime on CUDA, all into one memory pool: a program's
    outputs are valid until the engine replays any program. ``captured``
    says whether they are captured (``graphs.capturable``: not for a
    split model over gloo, whose programs run eagerly).

    A model split over ranks (module docstring) is served by an engine on
    every rank, each given the same requests in the same order.
    """

    def __init__(self, model, config: Optional[EngineConfig] = None, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 **kw):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        model.eval()
        self.config = config or EngineConfig(**kw)
        cfg = model.cfg
        if self.config.max_seq_len > cfg.max_seq_len:
            raise ValueError(
                f"engine max_seq_len {self.config.max_seq_len} exceeds the "
                f"model's position table ({cfg.max_seq_len})")
        B, S_max = self.config.max_batch_size, self.config.max_seq_len
        dt = self.config.cache_dtype or model.dtype
        # this rank's K/V heads: num_kv_heads / mp
        hkv = model.local_kv_heads
        self.page_alloc: Optional[PageAllocator] = None
        if self.config.kv_layout == "paged":
            ps = self.config.page_size
            num_pages = self.config.kv_pages
            if num_pages is None:
                num_pages = B * (S_max // ps) + 1  # full budget + trash page
            self.cache = PagedKVCache(
                cfg.num_layers, B, hkv, S_max, cfg.head_dim, dt,
                page_size=ps, num_pages=num_pages, device=self.device)
            self.page_alloc = PageAllocator(num_pages)
        else:
            self.cache = KVCache(cfg.num_layers, B, hkv, S_max,
                                 cfg.head_dim, dt, device=self.device)
        self.captured = _graphs.capturable(model, self.device)
        self.scheduler = Scheduler(B)
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self._slots: List[Optional[Request]] = [None] * B
        self._tokens = np.zeros((B,), np.int64)
        self._positions = np.zeros((B,), np.int32)
        self._temps = np.ones((B,), np.float32)
        self._top_ks = np.zeros((B,), np.int32)
        self._greedy = np.ones((B,), bool)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.config.page_size, self.page_alloc)
            if self.config.prefix_cache else None)
        self.spec: Optional[SpeculativeConfig] = self.config.speculative
        # speculation totals over greedy rows (sampled rows draft nothing)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.steps: Dict[str, _graphs.CapturedStep] = {}
        # one memory pool for all of the engine's graphs: a replay may
        # overwrite another program's outputs, and each output is consumed
        # (a prefill's logits sampled, a step's tokens read back) before
        # the next replay
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.captured else None)

    # -- weight management --
    def shardings(self) -> Dict[str, NamedSharding]:
        """The placement of each served parameter (``state_dict`` names):
        the block this rank's model holds, on the hybrid topology's mesh
        (``fleet.init``'s), else on a ``("dp",)`` mesh of the world, where
        every parameter is whole. ``load_weights`` moves its ``params``
        onto these; ``CheckpointManager.restore(shardings={"params":
        engine.shardings()})`` reads each rank's blocks of a save."""
        from ..distributed.topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        mesh = hcg.get_mesh() if hcg is not None \
            else DeviceMesh(np.arange(device_count()), ("dp",))
        return {name: placement(p, mesh) for name, p in
                self.model.state_dict(keep_vars=True).items()}

    @torch.no_grad()
    def load_weights(self, params, shardings=None,
                     allow_missing: bool = False):
        """Swap in serving weights: ``params`` maps the model's
        ``state_dict`` names (as ``weights.from_paddle_tpu`` makes them) to
        whole tensors or numpy arrays, which are sliced to this rank's
        block, or to ``resharding.ShardedTensor`` blocks (from
        ``CheckpointManager.restore(shardings=)``, or a live train step's
        ``live_state()`` / ``state_for_checkpoint()`` on any layout),
        which move device to device onto this rank's block through the
        resharding executor (collective: every rank loads the same names).
        Each block is copied into the existing parameter in place, so the
        captured steps go on reading the same addresses. Global shapes and
        dtypes must match exactly; a missing name raises unless
        ``allow_missing``. Nothing is copied unless every entry passes.

        ``shardings`` (``{name: NamedSharding}``, a serving layout per
        parameter) defaults to the model's own placement (``shardings()``),
        as the JAX engine's default keeps each parameter's sharding; an
        empty dict, and a None entry, mean the same. A placement the built
        model does not hold raises ``ValueError``: the JAX engine relays
        its arrays and recompiles, while a built ``nn.Module`` holds its
        blocks and cannot change them; build the model on the mesh that
        places them so."""
        from ..distributed.resharding import ShardedTensor, block_of, reshard

        own = self.shardings()
        for name, want in (shardings or {}).items():
            if name not in own:
                raise KeyError(f"load_weights: shardings names no parameter "
                               f"of the model: {name!r}")
            if want is not None and want != own[name]:
                raise ValueError(
                    f"load_weights: shardings[{name!r}] = {want!r}, but the "
                    f"built model holds {own[name]!r}; a built model cannot "
                    "change its blocks' layout (the JAX engine relays and "
                    "recompiles): build it on the mesh that places them so")
        current = self.model.state_dict(keep_vars=True)
        missing = [k for k in current if k not in params]
        if missing and not allow_missing:
            raise KeyError(f"load_weights: missing params {missing[:4]}"
                           + ("..." if len(missing) > 4 else ""))
        new = {}
        for name, cur in current.items():
            if name not in params:
                continue
            leaf = params[name]
            if isinstance(leaf, np.ndarray):
                leaf = torch.from_numpy(leaf)
            whole = ShardedTensor(cur, own[name]).shape
            if tuple(leaf.shape) != whole or leaf.dtype != cur.dtype:
                raise ValueError(
                    f"load_weights: param {name!r} is "
                    f"{tuple(leaf.shape)}/{leaf.dtype}, the engine serves "
                    f"{whole}/{cur.dtype}")
            new[name] = leaf
        rank = torch.distributed.get_rank() \
            if torch.distributed.is_initialized() else 0
        for name, leaf in new.items():  # collective: one name at a time
            want = own[name]
            if isinstance(leaf, ShardedTensor):
                block = leaf.block if leaf.sharding == want \
                    else reshard(leaf, want).block
            elif want.is_replicated:
                block = leaf
            else:
                flat = [int(r) for r in want.mesh.devices.reshape(-1)]
                block = block_of(leaf.__getitem__, leaf.shape, want,
                                 flat.index(rank))
            new[name] = block
        for name, block in new.items():
            current[name].copy_(block)
        return self

    # -- request API --
    def add_request(self, prompt_ids: Sequence[int],
                    sampling: Optional[SamplingParams] = None) -> Request:
        req = Request(prompt_ids, sampling)
        if len(req.prompt_ids) >= self.config.max_seq_len:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens leaves no room to "
                f"generate within max_seq_len={self.config.max_seq_len}")
        self.scheduler.add(req)
        return req

    @property
    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Union[SamplingParams, Sequence[SamplingParams],
                                 None] = None) -> List[List[int]]:
        """Queue every prompt, run steps to drain, and return each prompt's
        generated token ids (prompt excluded), in order."""
        if isinstance(sampling, SamplingParams) or sampling is None:
            sampling = [sampling] * len(prompts)
        if len(sampling) != len(prompts):
            raise ValueError("len(sampling) != len(prompts)")
        reqs = [self.add_request(p, sp) for p, sp in zip(prompts, sampling)]
        while self.scheduler.has_unfinished:
            self.step()
        return [r.output_ids for r in reqs]

    # -- engine loop --
    @torch.no_grad()
    def step(self):
        """One scheduler iteration: admit waiting requests into free slots
        (prefill or prefix splice + suffix prefill, and the first token
        each), then one batched decode or verify step over every running
        request."""
        self._admit()
        self._decode()

    def step_program(self, name: str) -> _graphs.CapturedStep:
        """The program ``name``, made on first use and kept for the
        engine's lifetime: ``"prefill:T"`` or ``"extend:T"`` for a bucket
        ``T`` (of ``config.prefill_buckets``, or ``max_seq_len``; what
        ``_bucket`` returns) (``prefill_program`` /
        ``extend_program`` analog; extend on the paged layout only),
        ``"decode"`` or ``"verify"`` (``decode_program`` /
        ``verify_program`` analog)."""
        step = self.steps.get(name)
        if step is not None:
            return step
        kind, _, bucket = name.partition(":")
        nb = (self.cache.num_blocks if self.page_alloc is not None
              else None)
        gen = None
        if kind in ("prefill", "extend") and bucket.isdigit() \
                and self._bucket(int(bucket)) == int(bucket):
            T = int(bucket)
            if kind == "extend" and nb is None:
                raise ValueError("the extend program needs "
                                 "kv_layout='paged'")
            bufs = _graphs.PrefillBuffers(T, nb, self.device)
            program = (_graphs.prefill_program if kind == "prefill"
                       else _graphs.extend_program)
            fn = program(self.model, self.cache, bufs, T)
        elif name in ("decode", "verify"):
            width, program = None, _graphs.decode_program
            if name == "verify":
                if self.spec is None:
                    raise ValueError("the verify step needs "
                                     "EngineConfig(speculative=...)")
                width, program = self.spec.k + 1, _graphs.verify_program
            bufs = _graphs.StepBuffers(self.config.max_batch_size, nb, width,
                                       self.device)
            gen = self.generator
            fn = program(self.model, self.cache, gen, bufs)
        else:
            raise ValueError(
                f"program {name!r}; want 'decode', 'verify', or 'prefill:T' "
                f"/ 'extend:T' for T in {self.config.prefill_buckets}")
        step = _graphs.CapturedStep(fn, bufs, self.device, gen,
                                    self._graph_pool,
                                    eager=not self.captured)
        self.steps[name] = step
        return step

    # -- internals --
    def _bucket(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if b >= n:
                return b
        return self.config.max_seq_len

    def _pages_needed(self, prompt_len: int) -> int:
        """Pages covering positions [0, prompt_len] — prompt plus the slot
        the first decode step writes into."""
        return prompt_len // self.cache.page_size + 1

    def _slot_row(self, slot: int) -> np.ndarray:
        """What a prefill program reads for ``slot``: its table row
        (paged) or its index (dense)."""
        if self.page_alloc is not None:
            return self.cache.page_table[slot:slot + 1]
        return np.array([slot], np.int64)

    def _prefill(self, req: Request, slot: int):
        """Bucketed prefill of ``req`` into ``slot`` through the bucket's
        ``prefill:T`` program; returns the last real token's logits
        ``[1, V]`` (the program's output, valid until its next run)."""
        n = len(req.prompt_ids)
        T = self._bucket(n)
        ids = np.zeros((1, T), np.int64)
        ids[0, :n] = req.prompt_ids
        return self.step_program(f"prefill:{T}").run(
            ids=ids, length=np.array([n]), row=self._slot_row(slot))[0]

    def _extend(self, suffix: List[int], slot: int, start: int):
        """Suffix prefill after a prefix splice through the bucket's
        ``extend:T`` program: the suffix, padded to ``T``, at positions
        ``start, start+1, ...`` over the slot's table row. Returns the last
        real suffix token's logits ``[1, V]``."""
        m = len(suffix)
        T = self._bucket(m)
        ids = np.zeros((1, T), np.int64)
        ids[0, :m] = suffix
        return self.step_program(f"extend:{T}").run(
            ids=ids, length=np.array([m]), row=self._slot_row(slot),
            start=np.array([start], np.int32))[0]

    def _admit(self):
        while self.cache.free_slots and self.scheduler.waiting:
            # peek before committing: admission backpressures on the page
            # pool, leaving the head request queued until a finish frees
            # pages
            req = self.scheduler.waiting[0]
            n = len(req.prompt_ids)
            owner = f"req{req.request_id}"
            hit_blocks, hit_pages = 0, []
            if self.prefix_cache is not None:
                hit_blocks, hit_pages = self.prefix_cache.match(req.prompt_ids)
            pages = None
            if self.page_alloc is not None:
                # the splice's reference first: evicting the matched
                # chain's leaves to make room must not hand their pages
                # out again
                self.page_alloc.retain(hit_pages, owner=owner)
                pages = self._alloc_pages(
                    self._pages_needed(n) - hit_blocks, owner)
                if pages is None:
                    # the next try matches again (the trie may have lost it)
                    self.page_alloc.free(hit_pages, owner=owner)
                    break
            # (dense admission never backpressures: a free slot is the
            # whole reservation)
            self.scheduler.next_waiting()  # pops the peeked head
            slot = self.cache.alloc_slot()
            req.slot = slot
            if hit_pages:
                # the splice: a table-row write over the retained pages, no
                # device work
                self.cache.assign_pages(slot, hit_pages)
                req.prefix_hit_blocks = hit_blocks
            if pages is not None:
                self.cache.assign_pages(slot, pages, start_block=hit_blocks)
            ps = self.config.page_size
            if hit_blocks:
                # at least one suffix token: match is capped at (n-1)//ps
                logits = self._extend(req.prompt_ids[hit_blocks * ps:], slot,
                                      hit_blocks * ps)
            else:
                logits = self._prefill(req, slot)
            if self.prefix_cache is not None:
                # index this prompt's full blocks (shared ones are already
                # nodes; new ones take a trie reference)
                self.prefix_cache.insert(req.prompt_ids,
                                         self.cache.slot_pages(slot)[:n // ps])
            sp = req.sampling
            tok = int(_sampling.sample_static(
                logits, self.generator, do_sample=sp.do_sample,
                temperature=sp.temperature, top_k=sp.top_k)[0])
            req.first_token_time = time.perf_counter()
            self._slots[slot] = req
            self._tokens[slot] = tok
            self._positions[slot] = n  # first generated
            self._temps[slot] = sp.temperature
            self._top_ks[slot] = sp.top_k
            self._greedy[slot] = not sp.do_sample
            req.output_ids.append(tok)
            self._maybe_finish(req, tok)

    def _alloc_pages(self, n: int, owner: str) -> Optional[List[int]]:
        """``n`` fresh pages, or None; a short pool first reclaims cold
        cached prefixes."""
        pages = self.page_alloc.alloc(n, owner=owner)
        if pages is None and self.prefix_cache is not None:
            self.prefix_cache.evict_lru(n)
            pages = self.page_alloc.alloc(n, owner=owner)
        return pages

    def _ensure_writable(self, slot: int, block: int, owner: str) -> bool:
        """Copy-on-write guard: a slot about to write ``block`` must own its
        page exclusively. The engine never maps a shared page where it
        writes (prefix matches stop below the suffix, decode and drafts
        write after the prompt), so this keeps an invariant: a shared page
        in the write path gets a private copy first, and the other sharers
        never see the write. False = no page free for the copy."""
        page = int(self.cache.page_table[slot, block])
        if page == PAGE_SENTINEL or not self.page_alloc.is_shared(page):
            return True
        fresh = self._alloc_pages(1, owner)
        if fresh is None:
            return False
        self.cache.copy_page(page, fresh[0])
        self.cache.page_table[slot, block] = fresh[0]
        self.page_alloc.free([page], owner=owner)
        return True

    def _grow_pages(self, width: int = 1):
        """Before a decode step, make sure every running slot has private
        pages mapped for the ``width`` positions it may write (1 for
        decode, ``k+1`` for verify; positions past the sequence budget go
        to the trash page and need none). A slot that can't grow finishes
        ``cache_full`` (its generated prefix is intact)."""
        ps, S_max = self.cache.page_size, self.config.max_seq_len
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            owner = f"req{req.request_id}"
            p = int(self._positions[slot])
            last = min(p + width - 1, S_max - 1)
            ok = True
            for block in range(p // ps, last // ps + 1):
                if self.cache.page_table[slot, block] == PAGE_SENTINEL:
                    pages = self._alloc_pages(1, owner)
                    if pages is None:
                        ok = False
                        break
                    self.cache.assign_pages(slot, pages, start_block=block)
                elif not self._ensure_writable(slot, block, owner):
                    ok = False
                    break
            if not ok:
                self._finish(req, "cache_full")

    def _step_inputs(self, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        host = dict(tokens=tokens, positions=self._positions,
                    temps=self._temps, top_ks=self._top_ks,
                    greedy=self._greedy)
        if self.page_alloc is not None:
            host["table"] = self.cache.page_table
        return host

    def _decode(self):
        if self.spec is not None:
            return self._decode_speculative()
        if self.page_alloc is not None:
            self._grow_pages()
        running = [r for r in self._slots if r is not None]
        if not running:
            return
        out = self.step_program("decode").run(**self._step_inputs(
            self._tokens))
        nxt = out[0].cpu().numpy()  # the one read back
        for req in running:
            slot = req.slot
            tok = int(nxt[slot])
            req.output_ids.append(tok)
            self._tokens[slot] = tok
            self._positions[slot] += 1
            self._maybe_finish(req, tok)

    def _decode_speculative(self):
        """One verify-k step over every running slot: ``k`` n-gram drafts
        per row, the verify step over the static ``[B, k+1]`` block, then
        per row on the host: a greedy row keeps the longest draft prefix
        the model's argmax agrees with plus the model's own token at the
        divergence (1 to k+1 tokens, the one-at-a-time greedy stream); a
        sampled row emits position 0's sample. Rolling back a rejected
        draft is not advancing ``_positions`` past the kept tokens."""
        k = self.spec.k
        self._grow_pages(width=k + 1)
        running = [r for r in self._slots if r is not None]
        if not running:
            return
        block = np.zeros((self.config.max_batch_size, k + 1), np.int64)
        drafts: Dict[int, List[int]] = {}
        for req in running:
            slot = req.slot
            drafts[slot] = propose_ngram(req.prompt_ids + req.output_ids, k,
                                         self.spec.ngram)
            block[slot, 0] = self._tokens[slot]
            block[slot, 1:] = drafts[slot]
        out = self.step_program("verify").run(**self._step_inputs(block))
        out = out[0].cpu().numpy()  # the one read back
        targets, sampled0 = out[:, :k + 1], out[:, k + 1]
        for req in running:
            slot = req.slot
            if self._greedy[slot]:
                a, emitted = accept_greedy(drafts[slot], targets[slot])
                req.draft_tokens += k
                req.accepted_tokens += a
                self.spec_drafted += k
                self.spec_accepted += a
            else:
                emitted = [int(sampled0[slot])]
            for tok in emitted:
                req.output_ids.append(tok)
                self._tokens[slot] = tok
                self._positions[slot] += 1
                self._maybe_finish(req, tok)
                if req.state == FINISHED:
                    break

    def _maybe_finish(self, req: Request, tok: int):
        sp = req.sampling
        reason = None
        if sp.eos_token_id is not None and tok == sp.eos_token_id:
            reason = "eos"
        elif req.num_generated >= sp.max_new_tokens:
            reason = "length"
        elif (len(req.prompt_ids) + req.num_generated
              >= self.config.max_seq_len):
            reason = "cache_full"  # next token would fall off the cache
        if reason is not None:
            self._finish(req, reason)

    def _finish(self, req: Request, reason: str):
        slot = req.slot
        self.scheduler.finish(req, reason)
        self._slots[slot] = None
        self._tokens[slot] = 0
        self._positions[slot] = 0
        self._temps[slot] = 1.0
        self._top_ks[slot] = 0
        self._greedy[slot] = True
        if self.page_alloc is not None:
            # drop this request's reference on every page its slot mapped;
            # the allocator raises on double-free
            self.page_alloc.free(self.cache.clear_slot(slot),
                                 owner=f"req{req.request_id}")
        self.cache.free_slot(slot)
