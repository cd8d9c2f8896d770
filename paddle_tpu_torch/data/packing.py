"""Greedy sequence packing: variable-length documents -> fixed [B, S]
(``paddle_tpu/data/packing.py`` analog, the same batches bit for bit).

The training step sees the SAME [B, S] int32 batch shape every step (one
shape per compiled program in the JAX package). The packer turns the
source's ragged document stream into static-shape buffers:

    tokens      [B, S] int32 — documents back to back, 0-padded tails
    segment_ids [B, S] int32 — 1-based per-document id within a row,
                               0 on padding (the attention-mask /
                               loss-mask carrier for packed attention)
    positions   [B, S] int32 — position WITHIN each document (reset to 0
                               at every document boundary)

Packing is greedy and sequential — documents fill the current row until
one doesn't fit, then the row is closed (tail padded) and the next row
starts. A document longer than S is truncated (default) or split into
S-sized continuation segments (``split_long_docs=True``, token-lossless).
Deterministic by construction: output is a pure function of the source
stream, so the checkpointable state is only the in-flight carry —
``{"carry": [...tokens...]}`` (the document pulled from the source that
did not fit the emitted batch). Source position + packer carry together
resume the exact batch sequence.

Efficiency is tracked per batch (non-pad fraction of B*S) as rolling
attributes (``efficiency``, ``batches``, ``docs_packed``,
``docs_truncated``); the ``data.*`` metrics wait for the observability
layer (ROADMAP queue A item A6).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .protocol import CheckpointableIterator

_STATE_VERSION = 1


class SequencePacker(CheckpointableIterator):
    """Pack a document stream (iterator of 1-D int token arrays) into
    fixed-shape ``{"tokens", "segment_ids", "positions"}`` batches.

    ``drop_remainder=True`` (default) only emits full [B, S] batches — a
    partially-fillable final batch (finite source) is dropped, keeping
    every emitted shape static. With ``repeat=True`` sources the
    stream is infinite and nothing is ever dropped.
    """

    def __init__(self, source: Iterator, batch_size: int, seq_len: int,
                 pad_id: int = 0, split_long_docs: bool = False,
                 drop_remainder: bool = True):
        self.source = source
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.pad_id = int(pad_id)
        self.split_long_docs = bool(split_long_docs)
        self.drop_remainder = bool(drop_remainder)
        if self.batch_size < 1 or self.seq_len < 1:
            raise ValueError("batch_size and seq_len must be >= 1")
        self._carry: Optional[np.ndarray] = None  # doc that missed the batch
        # rolling packing stats
        self.batches = 0
        self.tokens_packed = 0      # non-pad tokens emitted
        self.docs_packed = 0
        self.docs_truncated = 0
        self.tokens_truncated = 0

    # ---------------- stats ----------------
    @property
    def efficiency(self) -> float:
        """Rolling non-pad fraction over every batch emitted so far."""
        cap = self.batches * self.batch_size * self.seq_len
        return self.tokens_packed / cap if cap else 0.0

    # ---------------- iteration ----------------
    def _next_doc(self) -> Optional[np.ndarray]:
        if self._carry is not None:
            doc, self._carry = self._carry, None
            return doc
        while True:
            try:
                doc = next(self.source)
            except StopIteration:
                return None
            doc = np.asarray(doc, dtype=np.int32).reshape(-1)
            if doc.size:
                return doc

    def __next__(self) -> Dict[str, np.ndarray]:
        B, S = self.batch_size, self.seq_len
        tokens = np.full((B, S), self.pad_id, dtype=np.int32)
        segments = np.zeros((B, S), dtype=np.int32)
        positions = np.zeros((B, S), dtype=np.int32)
        row, col, seg, placed = 0, 0, 0, 0
        while row < B:
            doc = self._next_doc()
            if doc is None:  # source exhausted
                if placed == 0 or self.drop_remainder:
                    raise StopIteration
                break
            n = doc.size
            if n > S:
                if self.split_long_docs:
                    # the first S-col tokens continue below; the rest is
                    # carried as a fresh document (lossless)
                    n = S - col if col else S
                else:
                    self.docs_truncated += 1
                    self.tokens_truncated += doc.size - S
                    doc, n = doc[:S], S
            if n > S - col:  # close this row, retry the doc on the next
                self._carry = doc
                row += 1
                col = 0
                seg = 0
                continue
            if self.split_long_docs and doc.size > n:
                self._carry = doc[n:]
                doc = doc[:n]
            tokens[row, col:col + n] = doc
            segments[row, col:col + n] = seg + 1
            positions[row, col:col + n] = np.arange(n, dtype=np.int32)
            col += n
            seg += 1
            placed += n
            self.docs_packed += 1
            if col == S:
                row += 1
                col = 0
                seg = 0
        self.batches += 1
        self.tokens_packed += placed
        return {"tokens": tokens, "segment_ids": segments,
                "positions": positions}

    # ---------------- protocol ----------------
    def get_state(self) -> dict:
        return {
            "version": _STATE_VERSION,
            "carry": None if self._carry is None else
                     [int(t) for t in self._carry],
        }

    def set_state(self, state: dict) -> None:
        carry = state.get("carry")
        self._carry = (None if carry is None
                       else np.asarray(carry, dtype=np.int32))
