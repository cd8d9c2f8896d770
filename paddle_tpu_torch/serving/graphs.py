"""The serving programs, each captured once per shape as a CUDA graph
(``paddle_tpu/serving/engine.py`` ``_aot`` analog: ``prefill_program``,
``extend_program``, ``decode_program`` and ``verify_program``, which
``cached_generate`` uses too for its prefill and decode).

The JAX package compiles one executable per program and shape: the engine
a prefill and a suffix prefill (extend) per prompt bucket and one decode
(with speculation on, verify-k) step for its lifetime, ``cached_generate``
a prefill and a decode step per batch shape. The host ships its numpy
state in and reads back only the logits or the sampled tokens. Here a
program is a function over static device buffers (``StepBuffers`` for the
per-token steps, ``PrefillBuffers`` for a bucket's prefill or extend), and
``CapturedStep`` captures it as a CUDA graph on its first call and replays
the graph on every call after, once the host has copied its state into the
buffers.

A capture runs on the state of its first call: the host state goes into
the buffers first, and the warm-up run then writes exactly the K/V that
the first replay, right after the capture, writes again (the same
positions of the same slots from the same inputs; a step writes a
position before it reads it). So a capture leaves every other slot's K/V
as it was, in either layout: the dense decode step, which writes one
position in every row, writes each live row's next position and each
idle row's position 0, which holds nothing live. The generator's state is
saved before the warm-up and put back after the capture, so a capture
consumes no draws: a call draws the same numbers whether it captured or
replayed. The K/V buffers, the parameters and the program buffers keep
their addresses (the caches are written in place, ``Engine.load_weights``
copies into the parameters), so a graph stays valid; the generator is
registered with the graph, so each replay draws new numbers from it.

Programs captured into one memory pool (``pool``, as ``Engine`` does for
all of its own) share their intermediate memory: a replay may overwrite
the outputs of any other program of the pool. So a program's outputs are
valid until the next replay of any program of its pool, and are read (or
copied) before it; the engine samples each prefill's logits and reads each
step's tokens back before it replays another program.

On the CPU the same function runs eagerly on CPU buffers, because the
caller asked for the CPU. On CUDA a program is captured unless its model
is split over a group whose collectives run on the host (gloo's, which a
CUDA graph cannot record): ``capturable`` decides that once, from the
groups' backend, and such an engine runs every program eagerly
(``CapturedStep(eager=True)``, counted in ``eager_steps``). Over NCCL a
split model's programs are captured with their collectives. Nothing
falls back: a capture that fails raises.

A kernel wrapper counts its launches where it launches: the warm-up run
and the capture (which records the launch into the graph) each add one.
A replay runs the recorded kernels without calling their wrappers, so
their counts do not grow with replays; ``replays`` counts the replays,
and a profiler's kernel events count what ran on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .kv_cache import PAGE_SENTINEL, PagedKVCache
from .sampling import sample_batched


def capturable(model, device) -> bool:
    """Whether ``model``'s serving programs are captured on ``device``: on
    CUDA, unless a group its serving forward communicates over (its mp
    layers' group, its MoE blocks' ep group) has more than one rank on
    gloo, whose collectives run on the host, out of a graph's reach."""
    if torch.device(device).type != "cuda":
        return False
    for mod in model.modules():
        for g in (getattr(mod, "mp_group", None),
                  getattr(getattr(mod, "groups", None), "ep", None)):
            if g is not None and g.nranks > 1 and g.process_group is not None \
                    and dist.get_backend(g.process_group) == "gloo":
                return False
    return True


class Buffers:
    """Named static device tensors that a program reads."""

    def __init__(self, **tensors: torch.Tensor):
        self.__dict__.update(tensors)

    def write(self, **host):
        """Copy arrays (numpy, or tensors on any device) into the buffers
        of the same names, in place."""
        for name, value in host.items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            getattr(self, name).copy_(value)


class StepBuffers(Buffers):
    """Static inputs of a per-token program on ``device``: ``tokens``
    ``[B]`` (decode) or ``[B, width]`` (verify) int64, ``positions`` [B]
    int32, ``temps`` [B] fp32, ``top_ks`` [B] int32, ``greedy`` [B] bool
    and, for a paged cache (``num_blocks`` given), ``table``
    ``[B, num_blocks]`` int32 (None for a dense cache)."""

    def __init__(self, B: int, num_blocks: Optional[int],
                 width: Optional[int], device):
        tok_shape = (B,) if width is None else (B, width)
        self.tokens = torch.zeros(tok_shape, dtype=torch.long, device=device)
        self.positions = torch.zeros((B,), dtype=torch.int32, device=device)
        self.temps = torch.ones((B,), dtype=torch.float32, device=device)
        self.top_ks = torch.zeros((B,), dtype=torch.int32, device=device)
        self.greedy = torch.ones((B,), dtype=torch.bool, device=device)
        self.table = None if num_blocks is None else torch.full(
            (B, num_blocks), PAGE_SENTINEL, dtype=torch.int32, device=device)


class PrefillBuffers(Buffers):
    """Static inputs of a ``T``-token bucket's prefill or extend program on
    ``device``: ``ids`` ``[1, T]`` int64 (the prompt or suffix, zero
    padded), ``length`` [1] int64 (its real tokens), ``start`` [1] int32
    (extend: the suffix's first position) and ``row``: the slot's table
    row ``[1, num_blocks]`` int32 for a paged cache, the slot index [1]
    int64 for a dense one (``num_blocks`` None)."""

    def __init__(self, T: int, num_blocks: Optional[int], device):
        self.ids = torch.zeros((1, T), dtype=torch.long, device=device)
        self.length = torch.ones((1,), dtype=torch.long, device=device)
        self.start = torch.zeros((1,), dtype=torch.int32, device=device)
        self.row = (torch.zeros((1,), dtype=torch.long, device=device)
                    if num_blocks is None else
                    torch.full((1, num_blocks), PAGE_SENTINEL,
                               dtype=torch.int32, device=device))


def decode_program(model, cache, generator, bufs: StepBuffers):
    """The decode step: ``decode_step`` over the buffers (the page table's,
    or the dense cache's rows), then ``sample_batched``. Returns ``fn() ->
    (next tokens [B], logits [B, V])``."""

    @torch.no_grad()
    def fn():
        caches = (cache.layer_caches() if bufs.table is None
                  else cache.layer_caches(table=bufs.table))
        logits, _ = model.decode_step(bufs.tokens, caches, bufs.positions)
        return (sample_batched(logits, generator, bufs.temps, bufs.top_ks,
                               bufs.greedy), logits)

    return fn


def verify_program(model, cache, generator, bufs: StepBuffers):
    """The speculative verify step: ``extend_step`` over the ``[B, k+1]``
    block (each row's pending token and its ``k`` drafts). Returns
    ``fn() -> (tokens [B, k+2], logits [B, k+1, V])``: the argmax target
    at each block position (the greedy acceptance oracle), then position
    0's sampled token (what a sampled row emits)."""

    @torch.no_grad()
    def fn():
        logits, _ = model.extend_step(bufs.tokens,
                                      cache.layer_caches(table=bufs.table),
                                      bufs.positions)
        sampled0 = sample_batched(logits[:, 0], generator, bufs.temps,
                                  bufs.top_ks, bufs.greedy)
        return (torch.cat([logits.argmax(dim=-1), sampled0[:, None]], dim=1),
                logits)

    return fn


def prefill_program(model, cache, bufs: Buffers, T: int):
    """The ``T``-token bucket's prefill: ``prefill_with_cache`` over the
    padded prompt, its K/V written into the slot's pages (paged) or into
    positions ``[0, T)`` of the slot's row (dense) inside the program.
    Returns ``fn() -> (last real token's logits [1, V],)``. Over dense
    buffers of ``n`` rows (``ids [n, T]``, ``length [n]``, ``row`` the
    ``n`` slots) it is ``cached_generate``'s prefill."""
    paged = isinstance(cache, PagedKVCache)

    @torch.no_grad()
    def fn():
        logits, kvs = model.prefill_with_cache(bufs.ids, lengths=bufs.length)
        cache.write_prefill(kvs, bufs.row[0] if paged else bufs.row, T)
        return (logits,)

    return fn


def extend_program(model, cache, bufs: PrefillBuffers, T: int):
    """The ``T``-token bucket's suffix prefill after a prefix-cache splice
    (paged only): ``extend_step`` over the padded suffix at positions
    ``start, start+1, ...`` through the slot's table row (padding past the
    mapped pages lands on the trash page). Returns ``fn() -> (last real
    suffix token's logits [1, V],)``."""

    @torch.no_grad()
    def fn():
        logits, _ = model.extend_step(bufs.ids, cache.layer_caches(table=bufs.row),
                                      bufs.start)
        last = (bufs.length - 1).clamp(0, T - 1)
        return (logits[0].index_select(0, last),)

    return fn


class CapturedStep:
    """``fn`` over ``buffers``, captured as a CUDA graph on its first call
    and replayed after (run eagerly on CPU buffers, and with ``eager``,
    which ``capturable`` decides for a split model over gloo, on CUDA
    ones). ``captures`` counts
    the captures, ``capture_seconds`` is the host time of the capture with
    its warm-up run, ``outputs`` holds ``fn``'s outputs (on CUDA the
    graph's static output tensors, in the graph's memory pool: its own, or
    ``pool`` shared with other programs, when they are valid until any of
    them replays), and ``fn`` stays callable for a comparison on the same
    buffers. ``replays`` counts the graph's replays, ``eager_steps`` the
    eager runs."""

    def __init__(self, fn: Callable[[], Sequence[torch.Tensor]],
                 buffers: Buffers, device,
                 generator: Optional[torch.Generator] = None, pool=None,
                 eager: bool = False):
        self.fn = fn
        self.buffers = buffers
        self.device = torch.device(device)
        self.generator = generator
        self.pool = pool
        self.eager = eager or self.device.type == "cpu"
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.eager_steps = 0
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._graph = None

    def run(self, **host: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Copy ``host`` into the buffers and run the step once (on CUDA,
        captured first if it was not, unless ``eager``); returns its
        outputs."""
        self.buffers.write(**host)
        if self.eager:
            self.outputs = tuple(self.fn())
            self.eager_steps += 1
            return self.outputs
        if self._graph is None:
            self._capture()
        self.replay()
        return self.outputs

    def replay(self):
        """One replay of the captured graph on the buffers as they are."""
        self._graph.replay()
        self.replays += 1

    def _capture(self):
        dev = self.device
        t0 = time.perf_counter()
        gen = self.generator
        saved = gen.get_state() if gen is not None else None
        graph = torch.cuda.CUDAGraph()
        try:
            # one eager run on a side stream first: builds and loads the
            # kernels and lets the libraries allocate their workspaces
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            if gen is not None:
                with torch.cuda.device(dev):
                    graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn()
        finally:
            if gen is not None:
                # the warm-up's draws are given back, the capture failed
                # or not
                gen.set_state(saved)
        self._graph, self.outputs = graph, tuple(outputs)
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0
