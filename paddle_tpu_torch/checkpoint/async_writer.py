"""Background checkpoint writer with loud failures
(``paddle_tpu/checkpoint/async_writer.py`` analog).

The save path splits in two: the device-to-host snapshot runs on the
caller's thread (the only step-blocking cost, see
``CheckpointManager.save``) and the disk I/O runs here, on one ordered
worker thread per writer, so step N's COMMIT cannot race step N+1's shard
writes.

An exception in a background write is kept and re-raised, as
``AsyncCheckpointError``, on the next ``submit`` or
``wait_until_finished``; then it is cleared, and work queued after the
failing item still runs (each item is independent).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class AsyncCheckpointError(RuntimeError):
    """A background checkpoint write failed (original exception chained)."""


class AsyncWriter:
    def __init__(self, name: str = "ckpt-writer"):
        self._name = name
        self._queue: "queue.Queue[Optional[Callable[[], None]]]" = \
            queue.Queue()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                try:
                    item()
                except BaseException as e:  # noqa: BLE001 — re-raised later
                    with self._lock:
                        if self._error is None:
                            self._error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise AsyncCheckpointError(
                f"a background checkpoint write failed: {err!r}") from err

    def submit(self, fn: Callable[[], None]):
        """Queue ``fn``; raises first if a previous background write
        failed."""
        if self._closed:
            raise RuntimeError(f"AsyncWriter {self._name!r} is closed")
        self._raise_pending()
        self._ensure_thread()
        self._queue.put(fn)

    def run_sync(self, fn: Callable[[], None]):
        """Synchronous mode: the same failure surfacing, on the caller's
        thread, still after any queued work."""
        if self._closed:
            raise RuntimeError(f"AsyncWriter {self._name!r} is closed")
        self.wait_until_finished()
        fn()

    def wait_until_finished(self):
        """Block until every queued write has run; re-raise any failure."""
        self._queue.join()
        self._raise_pending()

    def close(self):
        self._closed = True
        self.wait_until_finished()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=10)
        self._thread = None
