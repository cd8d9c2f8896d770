"""File-shard sources: deterministic, per-process, checkpointable
readers (``paddle_tpu/data/sources.py`` analog; numpy and the standard
library, the same orders as the JAX package's).

  * shard assignment — the sorted global file list is permuted with an
    epoch-seeded RNG and dealt round-robin by ``(process_index,
    process_count)``; every process computes the same permutation, so
    assignment is coordination-free and disjoint by construction;
  * epoch-seeded shuffling — shard order (and optionally document order
    inside a shard) reshuffles every epoch from ``mix_seed(seed, epoch)``,
    never from ambient RNG state, so a resumed run replays it exactly;
  * checkpointable position — ``get_state()`` is (epoch, shard_cursor,
    intra-shard offset); ``set_state`` reproduces the identical remaining
    record stream.

The process identity defaults to ``torch.distributed``'s rank and world
size when it is initialised, else (0, 1).
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from .protocol import CheckpointableIterator, mix_seed

_STATE_VERSION = 1


def _default_process() -> tuple:
    """(process_index, process_count): the dp rank and world of the
    ``fleet.init`` topology, else ``torch.distributed``'s rank and world
    when it is initialised, else (0, 1)."""
    import torch.distributed as dist

    from ..distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return (hcg.get_data_parallel_rank(),
                hcg.get_data_parallel_world_size())
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), max(dist.get_world_size(), 1)
    return 0, 1


def expand_files(files, sort: bool = True) -> List[str]:
    """str glob / list of paths-or-globs -> deduped file list, sorted by
    default. Sorting is load-bearing for multi-host use: every host must
    derive the same global order from the same pattern. ``sort=False``
    keeps the caller's explicit order (the fleet set_filelist contract,
    where the list itself IS the agreed order)."""
    if isinstance(files, (str, os.PathLike)):
        files = [files]
    out: List[str] = []
    for f in files:
        f = os.fspath(f)
        matches = sorted(_glob.glob(f)) if _glob.has_magic(f) else [f]
        out.extend(matches)
    seen, uniq = set(), []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return sorted(uniq) if sort else uniq


def shard_assignment(files: Sequence[str], process_index: int,
                     process_count: int, seed: int = 0, epoch: int = 0,
                     shuffle: bool = True) -> List[str]:
    """This host's shard list for one epoch. Pure function of its inputs —
    the whole-fleet property (disjoint, covering, deterministic) follows
    from every host permuting the same sorted list with the same seed and
    taking a strided slice."""
    files = list(files)
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"process_count {process_count}")
    if shuffle:
        order = np.random.RandomState(mix_seed(seed, epoch)).permutation(len(files))
    else:
        order = np.arange(len(files))
    return [files[i] for i in order[process_index::process_count]]


class CoverageError(ValueError):
    """The fleet's shard assignment is not a partition of the file list
    (a shard unowned, or owned twice)."""


def validate_coverage(files: Sequence[str], process_count: int,
                      seed: int = 0, epoch: int = 0,
                      shuffle: bool = True) -> dict:
    """Prove the whole-fleet property for one epoch at one world size:
    every file owned by EXACTLY one process. Cheap (pure python over the
    file list), so the elastic runner re-runs it after every re-assignment
    rather than trusting the construction. Returns {file: owner}."""
    owners: dict = {}
    dups = {}
    for pi in range(int(process_count)):
        for f in shard_assignment(files, pi, process_count, seed=seed,
                                  epoch=epoch, shuffle=shuffle):
            if f in owners:
                dups.setdefault(f, [owners[f]]).append(pi)
            else:
                owners[f] = pi
    missing = [f for f in files if f not in owners]
    if missing or dups:
        raise CoverageError(
            f"shard assignment at process_count={process_count} epoch="
            f"{epoch} is not a partition: {len(missing)} unowned file(s) "
            f"{missing[:3]}..., {len(dups)} multiply-owned {dict(list(dups.items())[:3])}")
    return owners


class ShardedFileSource(CheckpointableIterator):
    """Base class: epoch/shard/offset bookkeeping over per-host file shards.

    Subclasses implement ``_read_shard(path) -> list_of_records`` (the
    record index for one shard; records are yielded in list order, after
    the optional epoch-seeded intra-shard permutation).

    State: ``{"epoch", "shard_cursor", "offset"}`` — offset counts records
    already YIELDED from the current shard, so restore skips exactly that
    many and the remaining stream is identical.
    """

    def __init__(self, files, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, seed: int = 0,
                 shuffle_shards: bool = True, shuffle_records: bool = False,
                 repeat: bool = True, sort_files: bool = True):
        self.files = expand_files(files, sort=sort_files)
        if not self.files:
            raise FileNotFoundError(f"no shard files match {files!r}")
        if process_index is None or process_count is None:
            dflt = _default_process()
            process_index = dflt[0] if process_index is None else process_index
            process_count = dflt[1] if process_count is None else process_count
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if len(self.files) < self.process_count:
            raise ValueError(
                f"{len(self.files)} shard file(s) cannot feed "
                f"{self.process_count} processes disjointly — write at least "
                "one shard per host")
        self.seed = int(seed)
        self.shuffle_shards = bool(shuffle_shards)
        self.shuffle_records = bool(shuffle_records)
        self.repeat = bool(repeat)
        self._epoch = 0
        self._shard_cursor = 0   # index into this epoch's local shard order
        self._offset = 0         # records yielded from the current shard
        self._records: Optional[list] = None  # current shard's record index
        self._exhausted = False
        self._empty_epochs = 0  # consecutive rollovers with no records
        # elastic residue (reassign mid-epoch): shards already consumed this
        # epoch under the OLD identity, and partial offsets to resume at
        self._epoch_done: set = set()
        self._partial_resume: dict = {}

    # ---------------- subclass surface ----------------
    def _read_shard(self, path: str) -> list:
        raise NotImplementedError

    # ---------------- assignment ----------------
    def local_shards(self, epoch: Optional[int] = None) -> List[str]:
        return shard_assignment(
            self.files, self.process_index, self.process_count,
            seed=self.seed, epoch=self._epoch if epoch is None else epoch,
            shuffle=self.shuffle_shards)

    @property
    def epoch(self) -> int:
        return self._epoch

    # ---------------- iteration ----------------
    def _record_order(self, n: int, path: str) -> np.ndarray:
        if self.shuffle_records:
            # salted by the shard's GLOBAL index, not the local cursor: the
            # intra-shard order must be a property of the shard itself so a
            # partially-read shard adopted by another host (elastic
            # reassign) resumes the same sequence
            return np.random.RandomState(
                mix_seed(self.seed, self._epoch, self.files.index(path), 1)
            ).permutation(n)
        return np.arange(n)

    def _load_current_shard(self) -> bool:
        """Position _records on the cursor's shard; False when the epoch is
        done (cursor past the local list). Shards another identity already
        consumed this epoch are skipped; partially-consumed ones resume at
        their recorded offset."""
        shards = self.local_shards()
        while self._shard_cursor < len(shards):
            path = shards[self._shard_cursor]
            if path in self._epoch_done:
                self._shard_cursor += 1
                self._offset = 0
                continue
            if self._offset == 0 and path in self._partial_resume:
                self._offset = int(self._partial_resume.pop(path))
            recs = self._read_shard(path)
            order = self._record_order(len(recs), path)
            recs = [recs[i] for i in order]
            if self._offset < len(recs):
                self._records = recs[self._offset:]
                return True
            # offset can only exceed the shard via a stale restore; treat
            # as shard-consumed and move on
            self._shard_cursor += 1
            self._offset = 0
        return False

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        while True:
            if self._records:
                self._offset += 1
                self._empty_epochs = 0
                return self._records.pop(0)
            if self._records is not None:  # current shard drained
                self._shard_cursor += 1
                self._offset = 0
                self._records = None
            if not self._load_current_shard():
                self._empty_epochs += 1
                if self.repeat and self._empty_epochs >= 2:
                    # two consecutive full scans found nothing: the local
                    # shard set is empty, repeat=True would spin forever
                    raise RuntimeError(
                        f"shard files for process {self.process_index} hold "
                        "no records")
                self._epoch += 1
                self._shard_cursor = 0
                self._offset = 0
                self._records = None
                self._epoch_done.clear()       # elastic residue is per-epoch
                self._partial_resume.clear()
                if not self.repeat:
                    self._exhausted = True
                    raise StopIteration

    # ---------------- elastic re-assignment ----------------
    def shard_progress(self) -> dict:
        """This identity's consumption of the CURRENT epoch: shards fully
        read (``done``) and in-flight offsets (``partial``) — the unit a
        surviving host hands to ``reassign`` so a dead peer's work isn't
        replayed and a partial shard resumes instead of restarting."""
        shards = self.local_shards()
        done = set(self._epoch_done)
        done.update(shards[:self._shard_cursor])
        partial = {p: int(o) for p, o in self._partial_resume.items()}
        if self._shard_cursor < len(shards) and self._offset > 0:
            partial[shards[self._shard_cursor]] = self._offset
        partial = {p: o for p, o in partial.items() if p not in done}
        return {"epoch": self._epoch, "done": sorted(done),
                "partial": partial}

    def reassign(self, process_index: int, process_count: int,
                 peer_progress=None, validate: bool = True
                 ) -> "ShardedFileSource":
        """Adopt a new fleet identity mid-epoch (elastic shrink/grow).

        Re-deals the file list at the new ``(process_index,
        process_count)`` and folds in epoch progress — this source's own
        plus any ``peer_progress`` (``shard_progress()`` dicts from OTHER
        former identities, e.g. recovered from a dead host's checkpoint) —
        so already-consumed shards are skipped and cursor-carrying shards
        resume at their offset rather than restarting. With ``validate``
        (default) the new assignment is proven to be a partition via
        ``validate_coverage`` before the switch. Calling ``set_state``
        across a world-size change instead of this raises (see there):
        that path silently skips/double-reads shards."""
        process_index, process_count = int(process_index), int(process_count)
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}")
        if len(self.files) < process_count:
            raise ValueError(
                f"{len(self.files)} shard file(s) cannot feed "
                f"{process_count} processes disjointly")
        progress = [self.shard_progress()]
        for p in (peer_progress or []):
            if int(p.get("epoch", -1)) == self._epoch:
                progress.append(p)  # stale-epoch peer state is meaningless
        if validate:
            validate_coverage(self.files, process_count, seed=self.seed,
                              epoch=self._epoch, shuffle=self.shuffle_shards)
        done: set = set()
        partial: dict = {}
        for p in progress:
            done.update(p.get("done") or [])
            for path, off in (p.get("partial") or {}).items():
                partial[path] = max(int(off), partial.get(path, 0))
        self.process_index = process_index
        self.process_count = process_count
        self._epoch_done = done
        self._partial_resume = {p: o for p, o in partial.items()
                                if p not in done and o > 0}
        self._shard_cursor = 0
        self._offset = 0
        self._records = None
        self._exhausted = False
        return self

    # ---------------- protocol ----------------
    def get_state(self) -> dict:
        state = {
            "version": _STATE_VERSION,
            "epoch": self._epoch,
            "shard_cursor": self._shard_cursor,
            "offset": self._offset,
            "process_index": self.process_index,
            "process_count": self.process_count,
        }
        if self._epoch_done:
            state["done_shards"] = sorted(self._epoch_done)
        if self._partial_resume:
            state["partial_shards"] = dict(self._partial_resume)
        return state

    def set_state(self, state: dict) -> None:
        pc = state.get("process_count")
        if pc is not None and int(pc) != self.process_count:
            raise ValueError(
                f"state was written at process_count {pc} but this source "
                f"runs at {self.process_count} — a blind restore would "
                "skip or double-read shards; use reassign() for elastic "
                "world-size changes")
        self._epoch = int(state["epoch"])
        self._shard_cursor = int(state["shard_cursor"])
        self._offset = int(state["offset"])
        self._records = None
        self._exhausted = False
        self._epoch_done = set(state.get("done_shards") or [])
        self._partial_resume = {k: int(v) for k, v in
                                (state.get("partial_shards") or {}).items()}


class TokenBinSource(ShardedFileSource):
    """Token ``.bin`` shards -> one int32 numpy array per document.

    Each shard is a flat token dump (``np.memmap``-readable, ``dtype``
    tokens back to back). With ``eos_id`` set, documents are the spans
    ENDING at each eos token (the eos stays with its document — the
    megatron-style boundary); trailing tokens after the last eos form a
    final document. Without ``eos_id``, the shard splits into fixed
    ``chunk_len`` documents (last partial chunk kept).
    """

    def __init__(self, files, dtype="uint16", eos_id: Optional[int] = None,
                 chunk_len: Optional[int] = None, **kw):
        if eos_id is None and chunk_len is None:
            raise ValueError("TokenBinSource needs eos_id or chunk_len to "
                             "delimit documents")
        self.dtype = np.dtype(dtype)
        self.eos_id = eos_id
        self.chunk_len = chunk_len
        super().__init__(files, **kw)

    def _read_shard(self, path: str) -> list:
        if os.path.getsize(path) == 0:
            return []  # memmap rejects empty files; an empty shard is legal
        tokens = np.memmap(path, dtype=self.dtype, mode="r")
        if self.eos_id is not None:
            ends = np.flatnonzero(tokens == self.dtype.type(self.eos_id)) + 1
            if len(ends) == 0 or ends[-1] != len(tokens):
                ends = np.append(ends, len(tokens))
            starts = np.concatenate(([0], ends[:-1]))
        else:
            starts = np.arange(0, len(tokens), self.chunk_len)
            ends = np.minimum(starts + self.chunk_len, len(tokens))
        return [np.asarray(tokens[s:e], dtype=np.int32)
                for s, e in zip(starts, ends) if e > s]


class JsonlSource(ShardedFileSource):
    """``.jsonl`` shards -> one int32 token array per line.

    Lines with a ``tokens`` field use it directly; lines with only
    ``text`` go through ``tokenizer(text) -> list[int]`` when supplied,
    else a UTF-8 byte fallback (vocab 256) so the source works without any
    tokenizer dependency.
    """

    def __init__(self, files, tokens_field: str = "tokens",
                 text_field: str = "text",
                 tokenizer: Optional[Callable] = None, **kw):
        self.tokens_field = tokens_field
        self.text_field = text_field
        self.tokenizer = tokenizer
        super().__init__(files, **kw)

    def _tokens_of(self, obj) -> np.ndarray:
        if self.tokens_field in obj:
            return np.asarray(obj[self.tokens_field], dtype=np.int32)
        text = obj[self.text_field]
        if self.tokenizer is not None:
            return np.asarray(self.tokenizer(text), dtype=np.int32)
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def _read_shard(self, path: str) -> list:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(self._tokens_of(json.loads(line)))
        return out


class TextLineSource(ShardedFileSource):
    """Plain-text shards -> one stripped, non-empty line (str) per record.
    The fleet InMemoryDataset/QueueDataset ingestion backbone."""

    def _read_shard(self, path: str) -> list:
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
