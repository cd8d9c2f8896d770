"""Asynchronous host-to-device input prefetch
(``paddle_tpu/io/prefetch.py`` analog).

A producer thread stages upcoming batches on the device through a bounded
queue, so the copy of batch k+1 overlaps step k. On CUDA each batch's
leaves are copied into **pinned** host buffers and from there to the
device with ``non_blocking=True`` on a side stream; the consumer's stream
waits on the copy's event before it uses the batch (no host wait), and
each device tensor is recorded on the consumer's stream
(``record_stream``) so the allocator cannot hand its memory out while the
consumer's kernels still read it. The pinned buffers are a ring reused
batch after batch: the producer waits for a buffer's last copy to finish
before it overwrites it. An early ``break`` (or an exception) in the
consumer stops the producer, which never stays blocked on a full queue.

A batch is a nested dict/list/tuple of numpy arrays, tensors or Python
scalars (kept as they are); the device defaults to ``cuda`` and the CPU
runs only when asked for, where a batch is made of CPU tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def _leaves(batch):
    out = []
    _tree_map(out.append, batch)
    return out


def _as_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return None  # a scalar rides along as it is


class _PinnedRing:
    """``n`` sets of pinned host buffers, reused round robin; each set's
    event marks its last device copy, which must finish before the set is
    written again."""

    def __init__(self, n: int):
        self._slots = [None] * n
        self._events = [None] * n
        self._i = 0

    def stage(self, tensors):
        i = self._i
        self._i = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()  # its last copy has finished
        bufs = self._slots[i]
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != \
                [(t.shape, t.dtype) for t in tensors]:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
            self._slots[i] = bufs
        for b, t in zip(bufs, tensors):
            b.copy_(t)
        return i, bufs

    def copied(self, i, event):
        self._events[i] = event


class DevicePrefetcher:
    """Double-buffered device staging over any batch iterable: with
    ``depth=2`` the producer copies batch k+1 (and k+2) while the consumer
    runs step k."""

    _END = object()

    def __init__(self, iterable: Iterable, depth: int = 2, device=None):
        self._iterable = iterable
        self._depth = max(1, int(depth))
        self._device = resolve_device(device)

    def __iter__(self) -> Iterator:
        dev = self._device
        cuda = dev.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        err: list = []
        stop = threading.Event()
        if cuda:
            dev = torch.device("cuda", dev.index if dev.index is not None
                               else torch.cuda.current_device())
            side = torch.cuda.Stream(device=dev)
            # the queue's batches, one being staged and one in the
            # consumer's hands each hold a buffer set
            ring = _PinnedRing(self._depth + 2)

        def _put(item) -> bool:
            # a bounded put that notices the consumer leaving: without the
            # stop check an early break would leave this thread blocked in
            # q.put for good
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage(batch):
            if not cuda:
                return _tree_map(lambda v: v if _as_tensor(v) is None
                                 else _as_tensor(v).to(dev), batch), None
            tensors = [t for t in map(_as_tensor, _leaves(batch))
                       if t is not None]
            i, bufs = ring.stage(tensors)
            with torch.cuda.stream(side):
                on_dev = iter([b.to(dev, non_blocking=True) for b in bufs])
                done = torch.cuda.Event()
                done.record(side)
            ring.copied(i, done)
            return _tree_map(lambda v: v if _as_tensor(v) is None
                             else next(on_dev), batch), done

        def produce():
            try:
                if cuda:
                    torch.cuda.set_device(dev)
                for batch in self._iterable:
                    if stop.is_set() or not _put(stage(batch)):
                        return
            except Exception as e:  # noqa: BLE001 — re-raised by the consumer
                err.append(e)
            finally:
                _put(self._END)

        t = threading.Thread(target=produce, daemon=True,
                             name="device-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                batch, done = item
                if cuda:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(done)
                    for v in _leaves(batch):
                        if isinstance(v, torch.Tensor):
                            v.record_stream(consumer)
                yield batch
        finally:
            # the consumer is done or left early: release the producer and
            # drop the staged batches
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=2.0)


def prefetch_to_device(iterable: Iterable, depth: int = 2, device=None):
    """Functional form: wrap any batch iterator so its batches arrive on
    the device ahead of use."""
    return DevicePrefetcher(iterable, depth=depth, device=device)
