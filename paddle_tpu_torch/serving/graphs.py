"""The serving engine's per-token programs, each captured once as a CUDA
graph (``paddle_tpu/serving/engine.py`` ``_aot``, ``decode_program`` and
``verify_program`` analog).

The JAX engine compiles one decode executable for its lifetime (with
speculation on, one verify-k executable in its place) and calls it every
step: the host ships its numpy state in and reads back only the sampled
tokens. Here the program is a function over static device buffers
(``StepBuffers``: tokens, positions, per-row sampling parameters, the page
table), and ``CapturedStep`` captures it as a CUDA graph on its first call
and replays the graph on every call after, once the host has copied its
state into the buffers.

The capture runs with an all-sentinel table and zero positions, so its
warm-up run writes K/V only into the trash page 0. The K/V pools, the
parameters and the buffers keep their addresses for the engine's lifetime
(the pools are written in place, ``Engine.load_weights`` copies into the
parameters), so the graph stays valid. The sampling generator is
registered with the graph, so each replay draws new numbers from it.

On a CPU engine the same function runs eagerly on CPU buffers, because the
caller asked for the CPU. On CUDA nothing runs it eagerly: a capture that
fails raises.

A kernel wrapper counts its launches where it launches: the warm-up run
and the capture (which records the launch into the graph) each add one.
A replay runs the recorded kernels without calling their wrappers, so
their counts do not grow with replays; ``replays`` counts the replays,
and a profiler's kernel events count what ran on the card.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .kv_cache import PAGE_SENTINEL
from .sampling import sample_batched


class StepBuffers:
    """Static inputs of a per-token program on ``device``: ``tokens``
    ``[B]`` (decode) or ``[B, width]`` (verify) int64, ``positions`` [B]
    int32, ``temps`` [B] fp32, ``top_ks`` [B] int32, ``greedy`` [B] bool
    and ``table`` ``[B, num_blocks]`` int32."""

    def __init__(self, B: int, num_blocks: int, width: Optional[int],
                 device):
        tok_shape = (B,) if width is None else (B, width)
        self.tokens = torch.zeros(tok_shape, dtype=torch.long, device=device)
        self.positions = torch.zeros((B,), dtype=torch.int32, device=device)
        self.temps = torch.ones((B,), dtype=torch.float32, device=device)
        self.top_ks = torch.zeros((B,), dtype=torch.int32, device=device)
        self.greedy = torch.ones((B,), dtype=torch.bool, device=device)
        self.table = torch.full((B, num_blocks), PAGE_SENTINEL,
                                dtype=torch.int32, device=device)

    def write(self, **host: np.ndarray):
        """Copy host arrays into the buffers of the same names, in place."""
        for name, value in host.items():
            getattr(self, name).copy_(torch.from_numpy(value))

    def idle(self):
        """The state a capture runs on: no live slot, every K/V write on
        the trash page."""
        self.tokens.zero_()
        self.positions.zero_()
        self.temps.fill_(1.0)
        self.top_ks.zero_()
        self.greedy.fill_(True)
        self.table.fill_(PAGE_SENTINEL)


def decode_program(model, cache, generator, bufs: StepBuffers):
    """The decode step: ``decode_step`` over the buffers, then
    ``sample_batched``. Returns ``fn() -> (next tokens [B], logits
    [B, V])``."""

    @torch.no_grad()
    def fn():
        logits, _ = model.decode_step(bufs.tokens,
                                      cache.layer_caches(bufs.table),
                                      bufs.positions)
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
                                      cache.layer_caches(bufs.table),
                                      bufs.positions)
        sampled0 = sample_batched(logits[:, 0], generator, bufs.temps,
                                  bufs.top_ks, bufs.greedy)
        return (torch.cat([logits.argmax(dim=-1), sampled0[:, None]], dim=1),
                logits)

    return fn


class CapturedStep:
    """``fn`` over ``buffers``, captured as a CUDA graph on its first call
    and replayed after (run eagerly on CPU buffers). ``captures`` counts
    the captures, ``outputs`` holds ``fn``'s outputs (on CUDA the graph's
    static output tensors), and ``fn`` stays callable for a comparison on
    the same buffers. ``replays`` counts the graph's replays."""

    def __init__(self, fn: Callable[[], Sequence[torch.Tensor]],
                 buffers: StepBuffers,
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.buffers = buffers
        self.device = buffers.table.device
        self.generator = generator
        self.captures = 0
        self.replays = 0
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._graph = None

    def run(self, **host: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Copy ``host`` into the buffers and run the step once; returns
        its outputs."""
        if self.device.type == "cpu":
            self.buffers.write(**host)
            self.outputs = self.fn()
            return self.outputs
        if self._graph is None:
            self._capture()
        self.buffers.write(**host)
        self.replay()
        return self.outputs

    def replay(self):
        """One replay of the captured graph on the buffers as they are."""
        self._graph.replay()
        self.replays += 1

    def _capture(self):
        dev = self.device
        self.buffers.idle()
        # one eager run on a side stream first: builds and loads the
        # kernels and lets the libraries allocate their workspaces
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            with torch.cuda.device(dev):
                graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            outputs = self.fn()
        self._graph, self.outputs = graph, tuple(outputs)
        self.captures += 1
