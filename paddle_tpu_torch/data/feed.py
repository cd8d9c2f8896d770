"""Batch feeding onto the device, with exact checkpoint positioning
(``paddle_tpu/data/feed.py`` analog).

``GlobalBatchFeeder`` turns the packer's host batches into torch tensors
on the device through ``io.prefetch.DevicePrefetcher``: a producer thread
copies batch k+1 (pinned host buffers, a side stream) while the consumer
runs step k. The consumer-side stall that remains is measured:
``host_wait_ms_mean`` is the mean time ``__next__`` blocked on the queue.

Prefetch means the upstream stages run ahead of the consumer, so
``get_state()`` does not read the live stage state: the producer
snapshots the pipeline state right after producing each batch, and the
feeder hands each snapshot over with its batch. The state read after
consuming batch k resumes at batch k+1, whatever the prefetch depth.

Over a mesh (``sharding``, from ``batch_sharding``), each rank's pipeline
reads its own files and the feeder yields the rank's *local* rows on its
device: the train step takes local rows, so nothing is assembled (the JAX
package assembles the global array from the same local rows).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Iterator, Optional

from ..device import resolve_device
from .protocol import CheckpointableIterator, iterator_state, restore_iterator


def batch_sharding(mesh, batch_axes="dp"):
    """``NamedSharding`` placing dim 0 of each batch field over the mesh's
    data axes (an axis name or a tuple of names, e.g. ``("dp",
    "sharding")``)."""
    from ..distributed.mesh import NamedSharding, PartitionSpec

    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    missing = [a for a in batch_axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"mesh {mesh.axis_names} has no axes {missing}")
    return NamedSharding(mesh, PartitionSpec(tuple(batch_axes)))


class GlobalBatchFeeder(CheckpointableIterator):
    """Iterate device-resident batches with copy/compute overlap and exact
    checkpoint positioning.

    ``upstream`` is the host-batch iterator (usually a SequencePacker; any
    iterator of numpy or tensor trees works). ``device`` defaults to
    ``cuda``. ``state_of``/``restore_to`` default to the upstream's own
    protocol methods and may be overridden to snapshot a larger pipeline.
    ``sharding`` (``batch_sharding``'s) records that the batches are this
    rank's rows of a batch split over its data axes; a split along another
    dimension raises (ROADMAP queue A item A5.7).
    """

    def __init__(self, upstream: Iterator, sharding=None,
                 prefetch_depth: int = 2,
                 state_of: Optional[Callable] = None,
                 restore_to: Optional[Callable] = None, *, device=None):
        if sharding is not None and any(e is not None
                                        for e in sharding.spec[1:]):
            raise NotImplementedError(
                f"GlobalBatchFeeder(sharding={sharding!r}): a batch split "
                "along another dimension than its rows is context "
                "parallelism, not ported yet (ROADMAP queue A item A5.7)")
        self.upstream = upstream
        self.sharding = sharding
        self.device = resolve_device(device)
        self.prefetch_depth = max(1, int(prefetch_depth))
        self._state_of = state_of or (lambda: iterator_state(self.upstream))
        self._restore_to = restore_to or (
            lambda s: restore_iterator(self.upstream, s))
        self._last_state = None
        # host-wait stats (consumer-side stalls)
        self.batches_fed = 0
        self.host_wait_s_total = 0.0

    @property
    def host_wait_ms_mean(self) -> float:
        if not self.batches_fed:
            return 0.0
        return 1e3 * self.host_wait_s_total / self.batches_fed

    def __iter__(self):
        from ..io.prefetch import DevicePrefetcher

        pending = collections.deque()

        def produce():
            for host_batch in self.upstream:
                # snapshot AFTER producing: resuming from it starts at the
                # NEXT batch; append-then-yield keeps the deque in step with
                # the prefetch queue (both FIFO, producer-ordered)
                pending.append(self._state_of())
                yield host_batch

        pre = iter(DevicePrefetcher(produce(), depth=self.prefetch_depth,
                                    device=self.device))
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    dev = next(pre)
                except StopIteration:
                    return
                wait = time.perf_counter() - t0  # the consumer's stall
                self._last_state = pending.popleft()
                self.batches_fed += 1
                self.host_wait_s_total += wait
                yield dev
        finally:
            pre.close()  # an early break stops the producer thread

    def get_state(self):
        """Pipeline state as of the last batch yielded to the consumer
        (not the producer's read-ahead position)."""
        if self._last_state is not None:
            return self._last_state
        return self._state_of()

    def set_state(self, state) -> None:
        self._restore_to(state)
        self._last_state = state
