"""LLM serving engine: bucketed prefill + batched paged decode with
continuous batching (``paddle_tpu/serving/engine.py`` analog, paged layout).

The JAX engine AOT-compiles one prefill executable per prompt-length bucket
and one decode executable for its lifetime; PyTorch runs eagerly, so the
port keeps the same static shapes (power-of-two prefill buckets, a
``[B_max]`` decode batch, a ``[B_max, num_blocks]`` page table) and calls
the model directly. KV pools are updated in place where the JAX engine
donated and rebound them.

Request flow: ``add_request`` queues; each ``step()`` first admits waiting
requests into free KV-cache slots (prefill + first token), then runs one
batched decode step over every running request.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``kv_layout="dense"``, ``prefix_cache``, ``speculative``,
``request_trace_dir``; ``cached_generate`` waits with the dense cache.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import sampling as _sampling
from .kv_cache import PAGE_SENTINEL, PagedKVCache
from .sampling import SamplingParams
from .scheduler import PageAllocator, Request, Scheduler


@dataclass
class EngineConfig:
    """Static serving envelope, fixed at engine construction."""

    max_batch_size: int = 4      # decode slots (B_max)
    max_seq_len: int = 128       # per-slot prompt + generation budget (S_max)
    prefill_buckets: Optional[Tuple[int, ...]] = None  # default: pow2 <= S_max
    cache_dtype: Optional[str] = None  # default: the model's param dtype
    request_trace_dir: Optional[str] = None
    kv_layout: str = "paged"
    page_size: int = 16          # tokens per KV page (shrunk to divide S_max)
    kv_pages: Optional[int] = None  # pool size; default = full budget + trash
    prefix_cache: bool = False
    speculative: Optional[Union[bool, int]] = None

    def __post_init__(self):
        if self.kv_layout == "dense":
            raise NotImplementedError(
                "kv_layout='dense' is not ported yet (ROADMAP queue A item "
                "1: dense KVCache + cached_generate)")
        if self.kv_layout != "paged":
            raise ValueError(f"kv_layout {self.kv_layout!r}; want 'paged'")
        for name in ("prefix_cache", "speculative", "request_trace_dir"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet (ROADMAP queue A "
                    "item 2: extend_step + prefix cache + speculative + "
                    "request traces)")
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
    (``GPTForCausalLM``'s ``prefill_with_cache`` / ``decode_step``).

        engine = Engine(model, EngineConfig(max_batch_size=8,
                                            max_seq_len=2048))
        outputs = engine.generate([[5, 17, 3], [9, 2]],
                                  SamplingParams(max_new_tokens=16))

    ``device`` defaults to ``cuda`` (raising without a card) and must be the
    model's device. Sampled requests draw from ``generator`` (a
    ``torch.Generator`` on that device, seed 0 when omitted).
    """

    def __init__(self, model, config: Optional[EngineConfig] = None,
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
        ps = self.config.page_size
        num_pages = self.config.kv_pages
        if num_pages is None:
            num_pages = B * (S_max // ps) + 1  # full budget + trash page
        self.cache = PagedKVCache(
            cfg.num_layers, B, cfg.num_kv_heads, S_max, cfg.head_dim,
            self.config.cache_dtype or model.dtype, page_size=ps,
            num_pages=num_pages, device=self.device)
        self.page_alloc = PageAllocator(num_pages)
        self.scheduler = Scheduler(B)
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self._slots: List[Optional[Request]] = [None] * B
        self._tokens = np.zeros((B,), np.int64)
        self._positions = np.zeros((B,), np.int32)
        self._temps = np.ones((B,), np.float32)
        self._top_ks = np.zeros((B,), np.int32)
        self._greedy = np.ones((B,), bool)

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
        (bucketed prefill + first token each), then one batched decode step
        over every running request."""
        self._admit()
        self._decode()

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

    def _prefill(self, req: Request, slot: int):
        """Bucketed prefill of ``req`` into ``slot``'s pages; returns the
        last real token's logits ``[1, V]``."""
        n = len(req.prompt_ids)
        T = self._bucket(n)
        ids = torch.zeros((1, T), dtype=torch.long)
        ids[0, :n] = torch.tensor(req.prompt_ids)
        logits, kvs = self.model.prefill_with_cache(
            ids.to(self.device),
            lengths=torch.tensor([n], device=self.device))
        self.cache.write_prefill(kvs, self.cache.page_table[slot], T)
        return logits

    def _admit(self):
        while self.cache.free_slots and self.scheduler.waiting:
            # peek before committing: admission backpressures on the page
            # pool, leaving the head request queued until a finish frees
            # pages
            req = self.scheduler.waiting[0]
            owner = f"req{req.request_id}"
            pages = self.page_alloc.alloc(
                self._pages_needed(len(req.prompt_ids)), owner=owner)
            if pages is None:
                break
            self.scheduler.next_waiting()  # pops the peeked head
            slot = self.cache.alloc_slot()
            req.slot = slot
            self.cache.assign_pages(slot, pages)
            logits = self._prefill(req, slot)
            sp = req.sampling
            tok = int(_sampling.sample_static(
                logits, self.generator, do_sample=sp.do_sample,
                temperature=sp.temperature, top_k=sp.top_k)[0])
            req.first_token_time = time.perf_counter()
            self._slots[slot] = req
            self._tokens[slot] = tok
            self._positions[slot] = len(req.prompt_ids)  # first generated
            self._temps[slot] = sp.temperature
            self._top_ks[slot] = sp.top_k
            self._greedy[slot] = not sp.do_sample
            req.output_ids.append(tok)
            self._maybe_finish(req, tok)

    def _ensure_writable(self, slot: int, block: int, owner: str) -> bool:
        """Copy-on-write guard: a slot about to write ``block`` must own its
        page exclusively. Without the prefix cache no page is ever shared,
        so this holds by construction; a shared page in the write path gets
        a private copy first. False = no page free for the copy."""
        page = int(self.cache.page_table[slot, block])
        if page == PAGE_SENTINEL or not self.page_alloc.is_shared(page):
            return True
        fresh = self.page_alloc.alloc(1, owner=owner)
        if fresh is None:
            return False
        self.cache.copy_page(page, fresh[0])
        self.cache.page_table[slot, block] = fresh[0]
        self.page_alloc.free([page], owner=owner)
        return True

    def _grow_pages(self):
        """Before a decode step, make sure every running slot has a private
        page mapped for the position it writes. A slot that can't grow
        finishes ``cache_full`` (its generated prefix is intact)."""
        ps, S_max = self.cache.page_size, self.config.max_seq_len
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            owner = f"req{req.request_id}"
            block = min(int(self._positions[slot]), S_max - 1) // ps
            if self.cache.page_table[slot, block] == PAGE_SENTINEL:
                pages = self.page_alloc.alloc(1, owner=owner)
                if pages is None:
                    self._finish(req, "cache_full")
                    continue
                self.cache.assign_pages(slot, pages, start_block=block)
            elif not self._ensure_writable(slot, block, owner):
                self._finish(req, "cache_full")

    def _decode(self):
        self._grow_pages()
        running = [r for r in self._slots if r is not None]
        if not running:
            return
        dev = self.device
        logits, _ = self.model.decode_step(
            torch.from_numpy(self._tokens).to(dev),
            self.cache.layer_caches(),
            torch.from_numpy(self._positions).to(dev))
        nxt = _sampling.sample_batched(
            logits, self.generator, torch.from_numpy(self._temps).to(dev),
            torch.from_numpy(self._top_ks).to(dev),
            torch.from_numpy(self._greedy).to(dev)).cpu().numpy()
        for req in running:
            slot = req.slot
            tok = int(nxt[slot])
            req.output_ids.append(tok)
            self._tokens[slot] = tok
            self._positions[slot] += 1
            self._maybe_finish(req, tok)

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
        # drop this request's reference on every page its slot mapped; the
        # allocator raises on double-free
        self.page_alloc.free(self.cache.clear_slot(slot),
                             owner=f"req{req.request_id}")
        self.cache.free_slot(slot)
