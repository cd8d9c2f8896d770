"""Continuous-batching request scheduler and KV page allocator
(``paddle_tpu/serving/scheduler.py`` analog, without the observability
calls).

Requests queue FIFO; the engine admits one into a KV-cache slot the moment
the slot frees, between decode steps.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from .sampling import SamplingParams

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"

_req_counter = itertools.count()


class Request:
    """One generation request: prompt ids + SamplingParams + accumulated
    output. ``finish_reason`` is ``eos`` | ``length`` | ``cache_full``."""

    def __init__(self, prompt_ids, sampling: Optional[SamplingParams] = None,
                 request_id: Optional[int] = None):
        self.request_id = (next(_req_counter) if request_id is None
                           else request_id)
        self.prompt_ids = [int(t) for t in prompt_ids]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.sampling = sampling or SamplingParams()
        self.output_ids: List[int] = []
        self.state = QUEUED
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        # prefix-cache and speculative-decoding bookkeeping
        self.prefix_hit_blocks = 0
        self.draft_tokens = 0
        self.accepted_tokens = 0
        # host clocks: the engine sets them after work that ends in a
        # device synchronisation (the sampled token's copy to the host)
        self.arrival_time = time.perf_counter()
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None

    @property
    def num_generated(self) -> int:
        return len(self.output_ids)

    def __repr__(self):
        return (f"Request(id={self.request_id}, state={self.state}, "
                f"prompt={len(self.prompt_ids)} toks, "
                f"generated={self.num_generated})")


class PageAllocator:
    """Refcounted free-list allocator over the paged KV cache's page pool.

    Page ids run ``[1, num_pages)``: page 0 is the reserved trash page that
    sentinel table entries clamp to and is never handed out. ``alloc`` is
    all-or-nothing. Double-free (or freeing a page never handed out)
    raises, naming the pages and their owners; a page returns to the free
    list exactly when its last reference drops.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (trash page + 1)")
        self.num_pages = num_pages
        # pop() from the tail hands out the lowest free id first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._owners: Dict[int, List[str]] = {}

    @property
    def num_allocatable(self) -> int:
        return self.num_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def is_shared(self, page: int) -> bool:
        return self._refs.get(page, 0) > 1

    def alloc(self, n: int, owner: Optional[str] = None) -> Optional[List[int]]:
        """``n`` fresh page ids at refcount 1, or None (pool unchanged) if
        fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
            self._owners[p] = [owner] if owner is not None else []
        return pages

    def retain(self, pages: List[int], owner: Optional[str] = None):
        """Add one reference per page (a new sharer of live pages)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(
                    f"retain of page {p} which is not allocated"
                    + (f" (by {owner})" if owner is not None else ""))
        for p in pages:
            self._refs[p] += 1
            if owner is not None:
                self._owners[p].append(owner)

    def free(self, pages: List[int], owner: Optional[str] = None):
        """Drop one reference per page; raises (freeing nothing) if any page
        is not allocated."""
        bad = [p for p in pages if p not in self._refs]
        if bad:
            known = {p: list(self._owners.get(p, [])) for p in bad}
            raise ValueError(
                f"free of page(s) {bad} not allocated (double-free "
                f"or never handed out); freed by {owner!r}, last known "
                f"owners: {known}")
        for p in pages:
            self._refs[p] -= 1
            if owner is not None and owner in self._owners[p]:
                self._owners[p].remove(owner)
            if self._refs[p] == 0:
                del self._refs[p]
                del self._owners[p]
                self._free.append(p)
        self._free.sort(reverse=True)


class Scheduler:
    """FIFO waiting queue + fixed slot table of size ``num_slots``."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []

    def add(self, request: Request):
        request.state = QUEUED
        self.waiting.append(request)

    def next_waiting(self) -> Optional[Request]:
        """Pop the request the engine should admit next (None when the
        queue is empty)."""
        if not self.waiting:
            return None
        req = self.waiting.popleft()
        req.state = RUNNING
        self.running.append(req)
        return req

    def finish(self, request: Request, reason: str):
        request.state = FINISHED
        request.finish_reason = reason
        request.finish_time = time.perf_counter()
        self.running.remove(request)

    @property
    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)
