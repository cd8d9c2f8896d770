"""CheckpointManager: step directories, atomic COMMIT, keep-last-N GC
(``paddle_tpu/checkpoint/manager.py`` analog).

Directory layout (one manager directory, many steps)::

    <directory>/
      step_00000100/
        manifest.json            # arrays + structure + checksums
        COMMIT                   # atomic publish marker, written LAST
        params__w.o0_0.bin       # one file per array
        ...
      step_00000200/ ...

A step is visible to ``latest_step``/``all_steps``/``restore`` only once
its COMMIT exists, and COMMIT is written (tmp file + rename) after every
array file and the manifest. A save killed mid-write leaves a torn,
invisible directory that the next manager construction deletes.

``save`` blocks only for the device-to-host snapshot; the files, the
manifest, COMMIT and the GC run on the ordered background writer, whose
failures surface on the next ``save``/``wait_until_finished``. A
restore reads and checks its files on up to 8 threads
(``arrays.map_files``).
``keep_last_n`` never deletes the newest committed step.

Across the ranks of a ``torch.distributed`` job every rank constructs the
manager and saves each step: each snapshots and writes its files (rank 0
every whole array; each rank the blocks of the ``ShardedTensor`` leaves
it holds as replica 0, as a train step's ``state_for_checkpoint()``
gives them over mp, ZeRO and ep, so no array is gathered) and
``manifest.part{r}.json``; after a barrier rank 0 merges the parts into
the manifest, writes COMMIT and removes the parts; a last barrier ends the
save on every rank. The barriers run on a gloo group of the manager's own,
made at construction: the writer thread calls them while the training
step's collectives run on the default group, and two threads issuing
collectives on one NCCL communicator can deadlock. ``restore`` takes a
layout on any mesh (each rank reads its blocks' byte ranges) and live
state to move device to device (``arrays.load_tree``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional

from . import arrays as _arrays
from .async_writer import AsyncWriter
from ..distributed.collective import new_group
from ..distributed.communication import barrier

STEP_PREFIX = "step_"
COMMIT_NAME = "COMMIT"


def step_dir_name(step: int) -> str:
    if step < 0:
        raise ValueError(f"checkpoint step must be >= 0, got {step}")
    return f"{STEP_PREFIX}{step:08d}"


def parse_step(name: str) -> Optional[int]:
    if not name.startswith(STEP_PREFIX):
        return None
    try:
        return int(name[len(STEP_PREFIX):])
    except ValueError:
        return None


def is_committed(step_path: str) -> bool:
    return os.path.exists(os.path.join(step_path, COMMIT_NAME))


def _sync_processes(tag: str, group=None):
    """Cross-process barrier of a cooperative save (``tag`` names it), on
    ``group``; nothing to wait for in one process."""
    if group is not None:
        barrier(group)


class CheckpointManager:
    """save/restore/latest_step/all_steps/wait_until_finished over one
    checkpoint directory. See the module docstring for the protocol.

    ``last_save`` holds the latest save's ``blocking_s`` (the snapshot),
    and, once written, ``total_s`` and ``bytes`` (this rank's bytes
    written); ``last_restore`` the
    latest restore's ``seconds`` and ``bytes``."""

    def __init__(self, directory: str, keep_last_n: Optional[int] = None,
                 async_: bool = True, validate_on_restore: bool = True):
        self.directory = os.path.abspath(str(directory))
        self.keep_last_n = keep_last_n
        self.async_ = async_
        self.validate_on_restore = validate_on_restore
        self._proc, self._nproc = _arrays._world()
        # the barriers' own gloo group (collective: every rank builds one)
        self._group = new_group(backend="gloo") if self._nproc > 1 else None
        self._writer = AsyncWriter(name=f"ckpt-writer:{self.directory}")
        self.last_save: Dict[str, float] = {}
        self.last_restore: Dict[str, float] = {}
        os.makedirs(self.directory, exist_ok=True)
        self._gc_uncommitted()
        # no rank writes into a step directory before rank 0 has swept
        _sync_processes("ckpt_init", self._group)

    # ---------------- step discovery ----------------
    def all_steps(self) -> List[int]:
        """Committed steps, ascending. Torn/in-flight saves are invisible."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            step = parse_step(name)
            if step is None:
                continue
            if is_committed(os.path.join(self.directory, name)):
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, step_dir_name(step))

    def manifest(self, step: int) -> dict:
        return _arrays.read_manifest(self.step_path(step))

    # ---------------- save ----------------
    def save(self, step: int, state, force: bool = False) -> None:
        """Checkpoint ``state`` (a nested dict/list tree of tensors, arrays
        and JSON scalars) as ``step``. Blocks only for the device-to-host
        snapshot; the rest runs on the writer when ``async_``. Raises
        ``AsyncCheckpointError`` here if a previous background save
        failed."""
        self._writer._raise_pending()
        sdir = self.step_path(step)
        if is_committed(sdir):
            if not force:
                raise ValueError(
                    f"step {step} already committed in {self.directory} "
                    "(pass force=True to overwrite)")
            self.wait_until_finished()
            if self._proc == 0:
                shutil.rmtree(sdir, ignore_errors=True)
            _sync_processes(f"ckpt_overwrite_{step}", self._group)

        t0 = time.perf_counter()
        flat = _arrays.flatten_tree(state)
        snaps = {path: _arrays.snapshot_array(leaf)
                 for path, leaf in flat.items()
                 if _arrays._is_array_leaf(leaf)}
        structure = _arrays._structure(state, snaps)
        record = {"blocking_s": time.perf_counter() - t0}
        self.last_save = record

        def write():
            # one file at a time: the writer shares the host with the
            # training loop, which a pool of writers would starve
            os.makedirs(sdir, exist_ok=True)
            entries = {path: _arrays.write_snapshot(sdir, path, snap)
                       for path, snap in snaps.items()}
            total = sum(e.pop("_bytes_written") for e in entries.values())
            manifest = {
                "format": _arrays.FORMAT,
                "step": step,
                "structure": structure,
                "arrays": entries,
                "bytes_written": total,
            }
            self._publish(sdir, step, manifest)
            record.update(total_s=time.perf_counter() - t0, bytes=total)
            self._gc_old()

        if self.async_:
            self._writer.submit(write)
        else:
            self._writer.run_sync(write)

    def _publish(self, sdir: str, step: int, manifest: dict) -> None:
        """Every rank's files are on disk -> make the step visible
        atomically. Across ranks: every rank writes its manifest part,
        then, after the barrier, rank 0 merges the parts, writes the
        manifest and COMMIT and removes the parts; a last barrier holds
        the others until the step is committed."""
        if self._nproc == 1:
            _arrays.write_manifest(sdir, manifest)
            self._write_commit(sdir, step)
            return
        _arrays.write_manifest(sdir, manifest,
                               manifest_name=f"manifest.part{self._proc}.json")
        _sync_processes(f"ckpt_commit_{step}", self._group)
        if self._proc == 0:
            parts = [f"manifest.part{p}.json" for p in range(self._nproc)]
            _arrays.write_manifest(sdir, _arrays.merge_manifests(
                [_arrays.read_manifest(sdir, name) for name in parts]))
            for name in parts:
                os.remove(os.path.join(sdir, name))
            self._write_commit(sdir, step)
        _sync_processes(f"ckpt_committed_{step}", self._group)

    def _write_commit(self, sdir: str, step: int) -> None:
        """The atomic publish: rename so a crash can never leave a partial
        COMMIT (a step is either fully visible or fully invisible)."""
        tmp = os.path.join(sdir, COMMIT_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(sdir, COMMIT_NAME))

    # ---------------- restore ----------------
    def restore(self, step: Optional[int] = None, shardings=None,
                live_state=None):
        """Restore a committed step (default: the latest) as a tree of CPU
        tensors on every rank: whole arrays, or where ``shardings`` (such
        as a train step's ``checkpoint_shardings()``, on any mesh) splits a
        leaf, this rank's block of it as a ``ShardedTensor``, read from the
        shard files it overlaps (CRC-checked whole; from the byte ranges
        the block needs alone when ``validate_on_restore`` is off).
        ``live_state`` (such as another step's ``live_state()``) moves the
        leaves it still holds device to device instead
        (``arrays.load_tree``)."""
        self.wait_until_finished()
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise FileNotFoundError(
                    f"no committed checkpoint steps in {self.directory}")
            step = steps[-1]
        elif step not in steps:
            raise FileNotFoundError(
                f"step {step} is not a committed checkpoint in "
                f"{self.directory} (committed: {steps})")
        t0 = time.perf_counter()
        m = self.manifest(step)
        tree = _arrays.load_tree(self.step_path(step), shardings=shardings,
                                 validate=self.validate_on_restore,
                                 manifest=m, live_state=live_state)
        self.last_restore = {"seconds": time.perf_counter() - t0,
                             "bytes": m["bytes_written"]}
        return tree

    # ---------------- lifecycle ----------------
    def wait_until_finished(self) -> None:
        """Drain in-flight saves; re-raise any background failure."""
        self._writer.wait_until_finished()

    def close(self) -> None:
        self._writer.close()

    # ---------------- GC ----------------
    def _gc_uncommitted(self) -> None:
        """Construction-time sweep: torn saves (no COMMIT) are deleted."""
        if self._proc != 0:
            return
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for name in names:
            if parse_step(name) is None:
                continue
            path = os.path.join(self.directory, name)
            if os.path.isdir(path) and not is_committed(path):
                shutil.rmtree(path, ignore_errors=True)

    def _gc_old(self) -> None:
        """keep_last_n sweep over committed steps; the newest committed
        step is never deleted (keep_last_n <= 0 still keeps one)."""
        if self.keep_last_n is None or self._proc != 0:
            return
        keep = max(1, int(self.keep_last_n))
        steps = self.all_steps()
        for step in steps[:-keep] if keep < len(steps) else []:
            # COMMIT first: a sweep killed mid-rmtree leaves an invisible
            # directory that construction GC removes, not a corrupt step
            sdir = self.step_path(step)
            try:
                os.remove(os.path.join(sdir, COMMIT_NAME))
            except FileNotFoundError:
                pass
            shutil.rmtree(sdir, ignore_errors=True)
