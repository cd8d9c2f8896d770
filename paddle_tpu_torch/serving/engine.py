"""LLM serving engine: bucketed prefill + batched paged decode with
continuous batching (``paddle_tpu/serving/engine.py`` analog, paged layout).

The JAX engine AOT-compiles one prefill executable per prompt-length bucket
and one decode executable for its lifetime. The port keeps the same static
shapes (power-of-two prefill buckets, a ``[B_max]`` decode batch, a
``[B_max, num_blocks]`` page table). Its per-token program, the decode
step or, with speculation on, the verify-k step, is captured once per
engine lifetime as a CUDA graph over static buffers and replayed every
step (``serving/graphs.py``). Prefill, and the suffix prefill after a
prefix-cache hit, run eagerly, once per request. KV pools and parameters
are updated in place where the JAX engine donated and rebound them.

Request flow: ``add_request`` queues; each ``step()`` first admits waiting
requests into free KV-cache slots (a prefill, or a prefix splice plus a
suffix prefill, and the first token), then runs one batched decode (or
verify-k) step over every running request.

Ported: the paged layout, the radix prefix cache (``prefix_cache``),
n-gram speculative decoding (``speculative``) and ``load_weights`` (which
takes no ``shardings=`` until ROADMAP queue A item A5). Not ported yet,
each raising ``NotImplementedError`` naming its ROADMAP item:
``kv_layout="dense"`` with ``cached_generate`` (A1) and
``request_trace_dir`` (A6).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import graphs as _graphs
from . import sampling as _sampling
from .kv_cache import PAGE_SENTINEL, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import FINISHED, PageAllocator, Request, Scheduler
from .speculative import SpeculativeConfig, accept_greedy, propose_ngram


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
    # radix prefix cache (prefix_cache.py): finished prompts' full KV
    # blocks stay indexed by content, and a prompt that shares a
    # block-aligned prefix maps the same pages and prefills its suffix only
    prefix_cache: bool = False
    # speculative decoding (speculative.py): True, an int k, or a
    # SpeculativeConfig; the verify-k step then replaces the decode step
    speculative: Optional[Union[bool, int, SpeculativeConfig]] = None

    def __post_init__(self):
        if self.kv_layout == "dense":
            raise NotImplementedError(
                "kv_layout='dense' is not ported yet (ROADMAP queue A item "
                "A1: dense KVCache + cached_generate)")
        if self.kv_layout != "paged":
            raise ValueError(f"kv_layout {self.kv_layout!r}; want 'paged'")
        if self.request_trace_dir:
            raise NotImplementedError(
                "EngineConfig.request_trace_dir is not ported yet (ROADMAP "
                "queue A item A6: request traces with the observability "
                "layer)")
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
    ``torch.Generator`` on that device, seed 0 when omitted). ``steps``
    holds the per-token programs made so far (``"decode"``, ``"verify"``),
    each captured once for the engine's lifetime on CUDA.
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
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(ps, self.page_alloc) if self.config.prefix_cache
            else None)
        self.spec: Optional[SpeculativeConfig] = self.config.speculative
        # speculation totals over greedy rows (sampled rows draft nothing)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.steps: Dict[str, _graphs.CapturedStep] = {}

    # -- weight management --
    @torch.no_grad()
    def load_weights(self, params, allow_missing: bool = False):
        """Swap in serving weights: ``params`` maps the model's
        ``state_dict`` names (as ``weights.from_paddle_tpu`` makes them) to
        tensors or numpy arrays. Each is copied into the existing parameter
        in place, so the captured steps go on reading the same addresses.
        Shapes and dtypes must match exactly; a missing name raises unless
        ``allow_missing``. Nothing is copied unless every entry passes."""
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
            if tuple(leaf.shape) != tuple(cur.shape) \
                    or leaf.dtype != cur.dtype:
                raise ValueError(
                    f"load_weights: param {name!r} is "
                    f"{tuple(leaf.shape)}/{leaf.dtype}, the engine serves "
                    f"{tuple(cur.shape)}/{cur.dtype}")
            new[name] = leaf
        for name, leaf in new.items():
            current[name].copy_(leaf)
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
        """The ``"decode"`` or ``"verify"`` step (``decode_program`` /
        ``verify_program`` analog), made on first use and kept for the
        engine's lifetime."""
        step = self.steps.get(name)
        if step is not None:
            return step
        if name == "decode":
            width, program = None, _graphs.decode_program
        elif name == "verify":
            if self.spec is None:
                raise ValueError("the verify step needs "
                                 "EngineConfig(speculative=...)")
            width, program = self.spec.k + 1, _graphs.verify_program
        else:
            raise ValueError(f"step {name!r}; want 'decode' or 'verify'")
        bufs = _graphs.StepBuffers(self.config.max_batch_size,
                                   self.cache.num_blocks, width, self.device)
        step = _graphs.CapturedStep(
            program(self.model, self.cache, self.generator, bufs), bufs,
            self.generator)
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

    def _extend(self, suffix: List[int], slot: int, start: int):
        """Suffix prefill after a prefix splice (``extend_program``
        analog): the suffix, padded to its bucket, through ``extend_step``
        at positions ``start, start+1, ...`` over the slot's table row
        (padding past the mapped pages lands on the trash page). Returns
        the last real suffix token's logits ``[1, V]``."""
        m = len(suffix)
        ids = torch.zeros((1, self._bucket(m)), dtype=torch.long)
        ids[0, :m] = torch.tensor(suffix)
        dev = self.device
        table = torch.from_numpy(self.cache.page_table[slot:slot + 1]).to(dev)
        logits, _ = self.model.extend_step(
            ids.to(dev), self.cache.layer_caches(table),
            torch.tensor([start], dtype=torch.int32, device=dev))
        return logits[:, m - 1]

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
            # the splice's reference first: evicting the matched chain's
            # leaves to make room must not hand their pages out again
            self.page_alloc.retain(hit_pages, owner=owner)
            pages = self._alloc_pages(self._pages_needed(n) - hit_blocks,
                                      owner)
            if pages is None:
                # the next try matches again (the trie may have lost it)
                self.page_alloc.free(hit_pages, owner=owner)
                break
            self.scheduler.next_waiting()  # pops the peeked head
            slot = self.cache.alloc_slot()
            req.slot = slot
            if hit_pages:
                # the splice: a table-row write over the retained pages, no
                # device work
                self.cache.assign_pages(slot, hit_pages)
                req.prefix_hit_blocks = hit_blocks
            self.cache.assign_pages(slot, pages, start_block=hit_blocks)
            ps = self.cache.page_size
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
        return dict(tokens=tokens, positions=self._positions,
                    temps=self._temps, top_ks=self._top_ks,
                    greedy=self._greedy, table=self.cache.page_table)

    def _decode(self):
        if self.spec is not None:
            return self._decode_speculative()
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
        # drop this request's reference on every page its slot mapped; the
        # allocator raises on double-free
        self.page_alloc.free(self.cache.clear_slot(slot),
                             owner=f"req{req.request_id}")
        self.cache.free_slot(slot)
