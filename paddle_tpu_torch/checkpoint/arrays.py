"""Array-tree serialization (``paddle_tpu/checkpoint/arrays.py`` analog).

The on-disk format is the JAX package's, byte for byte, so either package
restores what the other wrote: ``manifest.json`` (``format``
``paddle_tpu.ckpt.v1``; per array its global shape, dtype string,
``sharding`` and per-shard file, offset, shape, CRC32 and byte count; the
tree's structure with array leaves as ``{"__array__": path}`` markers and
JSON scalars inline) and one raw ``.bin`` per shard, named by the leaf's
path and its shard's offsets. A tensor is one shard at offset zero and
``sharding`` is null; a ``resharding.ShardedTensor`` (a rank's block and
its ``NamedSharding``) is written as the JAX package writes a sharded
``jax.Array``: each rank writes the blocks it holds as replica 0 (the
rank at coordinate 0 of every mesh axis the placement does not split),
one file per box at its global offsets, and ``sharding`` is the JAX
package's description of the placement (mesh axes, mesh shape, spec). A
segmented dimension (the qkv projection's q | k | v under mp) gives one
box per segment, each a box of the global array, so the JAX reader
assembles them by their offsets as it assembles its own.

Leaves are ``torch.Tensor`` (on any device: snapshotted to the host),
numpy arrays or scalars, or JSON scalars (int, float, str, bool, None) in
nested dicts, lists and tuples (tuples come back as lists). A tensor is
written as its raw bytes under numpy's name for its dtype; ``bfloat16``
(and the fp8 types, which numpy lacks) are written as their raw words
under the name the JAX package's ``ml_dtypes`` arrays carry, so the bytes
are the same on both sides. Restored arrays come back as CPU tensors
(``torch.frombuffer`` over the validated bytes), whatever their dtype.

Across the ranks of a job the JAX package's replica-0 rule applies: a
whole array is written by rank 0 alone (the other ranks' manifests list
it with no shards), a sharded one by its replica-0 holders, each its own
boxes, and ``merge_manifests`` unions the per-rank manifests. Nothing is
gathered: a save makes no collective of its own.

A restore gives each array whole unless ``shardings`` places it: then
each rank gets its block of the placement as a ``ShardedTensor`` (the
block and the ``NamedSharding`` of the port's mesh it belongs to,
``segments`` honoured; ``restore_array``), read from the shard files that
overlap the block, whether the save wrote whole arrays (the port's) or
per-device shards (the JAX package's). With ``validate`` (the default)
each such file is read whole once and its CRC32 checked, as the JAX
package's ``read_index`` does: the manifest's CRC32 covers a whole file.
Without it only the byte ranges the block needs are read, and nothing
else (``tools/ckpt_inspect.py --verify`` checks the files on their own).
``read_stats()`` counts the bytes and ranges this process read.
``live_state`` (``load_tree``) moves a leaf that a live ``ShardedTensor``
still holds device to device through the resharding executor instead of
reading it, as the JAX package's ``_live_reshard`` does; a leaf whose live
block does not match the checkpoint, or whose move the planner cannot
plan, is read from the files.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

MANIFEST_NAME = "manifest.json"
FORMAT = "paddle_tpu.ckpt.v1"

_SEP = "/"
_ARRAY_KEY = "__array__"

#: dtype names of the manifest <-> torch dtypes
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

_READ = {"bytes": 0, "ranges": 0, "live": 0, "files": 0}
_READ_LOCK = threading.Lock()


def read_stats() -> dict:
    """Bytes and byte ranges this process read from shard files since
    ``reset_read_stats()``, and the leaves ``load_tree`` moved live and
    read from files."""
    with _READ_LOCK:
        return dict(_READ)


def reset_read_stats():
    with _READ_LOCK:
        for k in _READ:
            _READ[k] = 0


def _count(**kw):
    with _READ_LOCK:
        for k, v in kw.items():
            _READ[k] += v


def map_files(fn: Callable, items) -> list:
    """``[fn(item) for item in items]`` on up to 8 threads: file reads and
    writes and zlib's CRC32 release the GIL, so one file's I/O overlaps
    another's checksum."""
    items = list(items)
    if len(items) < 2:
        return [fn(item) for item in items]
    with ThreadPoolExecutor(min(8, len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _world() -> tuple:
    """(rank, world size) of ``torch.distributed`` when it is initialised,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"checkpoint dtype {name!r} has no torch "
                        "counterpart") from None


def _is_array_leaf(v) -> bool:
    from ..distributed.resharding import ShardedTensor

    return isinstance(v, (torch.Tensor, np.ndarray, np.generic,
                          ShardedTensor))


def flatten_tree(state) -> Dict[str, Any]:
    """Nested containers -> {path: leaf} with '/'-joined string paths."""
    out: Dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                k = str(k)
                if _SEP in k:
                    raise ValueError(f"state key may not contain '{_SEP}': "
                                     f"{k!r}")
                walk(f"{prefix}{_SEP}{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{_SEP}{i}" if prefix else str(i), v)
        else:
            out[prefix] = node

    walk("", state)
    return out


def _structure(state, arrays: Dict[str, Any], prefix: str = ""):
    """Nesting skeleton for the manifest: array leaves become
    {"__array__": path} markers, scalars stay inline JSON."""
    if isinstance(state, dict):
        return {str(k): _structure(v, arrays,
                                   f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_structure(v, arrays,
                           f"{prefix}{_SEP}{i}" if prefix else str(i))
                for i, v in enumerate(state)]
    if _is_array_leaf(state):
        return {_ARRAY_KEY: prefix}
    if state is None or isinstance(state, (bool, int, float, str)):
        return state
    raise TypeError(
        f"unsupported checkpoint leaf at {prefix!r}: {type(state).__name__} "
        "(tensors, arrays, numbers, strings, bools, None, and nested "
        "dict/list/tuple containers are checkpointable)")


def _unstructure(node, resolve_array):
    if isinstance(node, dict):
        if _ARRAY_KEY in node and len(node) == 1:
            return resolve_array(node[_ARRAY_KEY])
        return {k: _unstructure(v, resolve_array) for k, v in node.items()}
    if isinstance(node, list):
        return [_unstructure(v, resolve_array) for v in node]
    return node


def _file_name(path: str, offsets) -> str:
    """Shard file name: the leaf's path with '/' as '__', then its global
    offsets (``.scalar.bin`` for a 0-d array)."""
    base = path.replace(_SEP, "__")
    if not offsets:
        return f"{base}.scalar.bin"
    return f"{base}.o{'_'.join(str(o) for o in offsets)}.bin"


def _sharding_desc(sharding) -> dict:
    """The JAX package's ``_sharding_desc`` of a ``NamedSharding``."""
    def ent(e):
        if e is None:
            return None
        return list(e) if isinstance(e, tuple) else e

    return {"mesh_axes": list(sharding.mesh.axis_names),
            "mesh_shape": [int(d) for d in sharding.mesh.devices.shape],
            "spec": [ent(e) for e in sharding.spec]}


def replica_zero(sharding, rank: int) -> bool:
    """Whether ``rank`` writes its block of ``sharding``: it is on the
    mesh, at coordinate 0 of every axis the placement does not split."""
    from ..distributed.mesh import spec_axes

    flat = [int(r) for r in sharding.mesh.devices.reshape(-1)]
    if rank not in flat:
        return False
    split = set(spec_axes(sharding.spec))
    return all(c == 0 for a, c in sharding.mesh.coords(rank).items()
               if a not in split)


def _snapshot_sharded(st) -> dict:
    """``snapshot_array`` of a ``ShardedTensor``: this rank's boxes
    (``block_pieces``: one per segment of a segmented dimension) at their
    global offsets, copied to the host, when it is the block's replica
    0; else none."""
    from ..distributed.resharding import block_pieces

    if st.dtype not in _DTYPE_NAMES:
        raise TypeError(f"no checkpoint dtype name for {st.dtype}")
    sh, rank = st.sharding, _world()[0]
    shards = []
    if st.block is not None and replica_zero(sh, rank):
        flat = [int(r) for r in sh.mesh.devices.reshape(-1)]
        block = st.block.detach()
        for gs, ls in block_pieces(st.shape, sh, flat.index(rank)):
            shards.append(([int(g.start) for g in gs],
                           block[ls].to("cpu", copy=True).contiguous()))
    return {"global_shape": [int(d) for d in st.shape],
            "dtype": _DTYPE_NAMES[st.dtype], "sharding": _sharding_desc(sh),
            "shards": shards}


def snapshot_array(arr) -> dict:
    """Host snapshot of one leaf, the only step-blocking part of a save:
    ``{"global_shape", "dtype", "sharding", "shards": [(offsets, host)]}``
    with ``host`` a CPU tensor (or a numpy array) that the training step
    can no longer change; ``write_snapshot`` writes it later. A CUDA
    tensor is copied to the host here. A tensor or array leaf is
    replicated across the ranks, so only rank 0 snapshots it (the
    replica-0 rule); the other ranks' snapshots hold no shard. A
    ``ShardedTensor`` snapshots this rank's boxes where it is the block's
    replica 0 (``replica_zero``)."""
    from ..distributed.resharding import ShardedTensor

    if isinstance(arr, ShardedTensor):
        return _snapshot_sharded(arr)
    first = _world()[0] == 0
    host = None
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"no checkpoint dtype name for {t.dtype}")
        shape, dtype = tuple(t.shape), _DTYPE_NAMES[t.dtype]
        if first:  # a CPU tensor may still be written to by its owner: copy
            host = t.to("cpu", copy=True).contiguous()
    else:
        a = np.asarray(arr)
        shape, dtype = a.shape, str(a.dtype)
        if first:  # ascontiguousarray promotes 0-d to (1,): keep the shape
            host = np.ascontiguousarray(a).reshape(a.shape).copy()
    shards = [([0] * len(shape), host)] if first else []
    return {"global_shape": [int(d) for d in shape], "dtype": dtype,
            "sharding": None, "shards": shards}


def _raw(host) -> np.ndarray:
    """The leaf's bytes as a flat uint8 view (no copy): the file write and
    the CRC32 read it in place."""
    if isinstance(host, torch.Tensor):
        return host.reshape(-1).view(torch.uint8).numpy()
    return host.reshape(-1).view(np.uint8)


def write_snapshot(directory: str, path: str, snap: dict) -> dict:
    """Write one snapshotted array's shard files; return its manifest
    entry (with ``_bytes_written``, which the caller strips)."""
    entries = []
    total = 0
    for offsets, data in snap["shards"]:
        fname = _file_name(path, offsets)
        raw = _raw(data)
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(raw)
        total += raw.nbytes
        entries.append({
            "file": fname,
            "offset": offsets,
            "shape": [int(d) for d in data.shape],
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            "bytes": raw.nbytes,
        })
    return {
        "global_shape": snap["global_shape"],
        "dtype": snap["dtype"],
        "sharding": snap["sharding"],
        "shards": entries,
        "_bytes_written": total,
    }


def save_array(directory: str, path: str, arr) -> dict:
    """Snapshot + write in one call (the synchronous path)."""
    return write_snapshot(directory, path, snapshot_array(arr))


def save_tree(directory: str, state, step: Optional[int] = None,
              manifest_name: str = MANIFEST_NAME) -> dict:
    """Write every array leaf of ``state`` under ``directory`` and return
    the manifest dict, published under ``manifest_name`` unless that is
    empty (the manager publishes its own, then COMMIT). Across ranks each
    rank writes its files (``snapshot_array``'s replica-0 rule); the
    manifest under the default name is rank 0's alone, and under another
    name (a per-rank part, which ``merge_manifests`` joins) every
    rank's."""
    os.makedirs(directory, exist_ok=True)
    leaves = [(path, leaf) for path, leaf in flatten_tree(state).items()
              if _is_array_leaf(leaf)]
    arrays = dict(zip((path for path, _ in leaves), map_files(
        lambda pl: save_array(directory, *pl), leaves)))
    total = sum(e.pop("_bytes_written") for e in arrays.values())
    manifest = {
        "format": FORMAT,
        "step": step,
        "structure": _structure(state, arrays),
        "arrays": arrays,
        "bytes_written": total,
    }
    if manifest_name and (_world()[0] == 0
                          or manifest_name != MANIFEST_NAME):
        write_manifest(directory, manifest, manifest_name)
    return manifest


def write_manifest(directory: str, manifest: dict,
                   manifest_name: str = MANIFEST_NAME):
    tmp = os.path.join(directory, manifest_name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(directory, manifest_name))


def read_manifest(directory: str, manifest_name: str = MANIFEST_NAME) -> dict:
    with open(os.path.join(directory, manifest_name)) as f:
        m = json.load(f)
    if m.get("format") != FORMAT:
        raise ValueError(f"{directory}: not a {FORMAT} checkpoint "
                         f"(format={m.get('format')!r})")
    return m


def merge_manifests(parts) -> dict:
    """Union per-rank manifests (same structure and metadata, disjoint
    shard lists) into the publishable one."""
    merged = None
    for part in parts:
        if merged is None:
            merged = json.loads(json.dumps(part))
            continue
        merged["bytes_written"] += part.get("bytes_written", 0)
        for path, entry in part["arrays"].items():
            if path in merged["arrays"]:
                have = {s["file"] for s in merged["arrays"][path]["shards"]}
                merged["arrays"][path]["shards"] += [
                    s for s in entry["shards"] if s["file"] not in have]
            else:
                merged["arrays"][path] = entry
    return merged


def _whole(sharding) -> bool:
    """Whether ``sharding`` places the array whole on every rank (None, or
    a replicated ``NamedSharding``)."""
    from ..distributed.mesh import NamedSharding

    if sharding is None:
        return True
    if not isinstance(sharding, NamedSharding):
        raise TypeError(f"a restore places arrays by the port's "
                        f"NamedSharding, got {type(sharding).__name__}")
    return sharding.is_replicated


# transient-I/O policy for restore reads: a flaky network filesystem fails
# reads that succeed moments later; exhaustion re-raises with the shard's
# path. Tests monkeypatch these.
RESTORE_READ_RETRIES = 2         # extra attempts after the first failure
RESTORE_RETRY_BACKOFF_S = 0.05   # doubles per attempt


class _ShardReader:
    """Access to one array's saved shards: a whole shard file is read once
    into a buffer, its CRC32 checked (with ``validate``), and viewed as a
    CPU tensor of the entry's dtype; without ``validate`` a box of a file
    is read by its byte ranges alone."""

    def __init__(self, directory: str, path: str, entry: dict,
                 validate: bool = True):
        self.directory = directory
        self.path = path
        self.entry = entry
        self.validate = validate
        self.dtype = torch_dtype(entry["dtype"])
        self.global_shape = tuple(entry["global_shape"])
        self._cache: Dict[str, torch.Tensor] = {}

    def _read_validated(self, fpath: str, shard: dict) -> bytearray:
        with open(fpath, "rb") as f:
            raw = bytearray(os.fstat(f.fileno()).st_size)
            f.readinto(raw)
        if self.validate:
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            if crc != shard["crc32"]:
                raise IOError(
                    f"checksum mismatch for {self.path!r} shard "
                    f"{shard['file']}: manifest {shard['crc32']:#x}, "
                    f"file {crc:#x} — checkpoint is corrupt")
        return raw

    def _load(self, shard: dict) -> torch.Tensor:
        if shard["file"] in self._cache:
            return self._cache[shard["file"]]
        fpath = os.path.join(self.directory, shard["file"])
        retries = max(0, int(RESTORE_READ_RETRIES))
        for attempt in range(retries + 1):
            try:
                raw = self._read_validated(fpath, shard)
                break
            except (OSError, IOError) as e:
                # the syscall failing or a checksum mismatch (a torn
                # page-cache read heals the same way)
                if attempt == retries:
                    raise IOError(
                        f"restore of {self.path!r} failed after "
                        f"{retries + 1} attempt(s) on shard file {fpath}: "
                        f"{e}") from e
                time.sleep(RESTORE_RETRY_BACKOFF_S * (2.0 ** attempt))
        shape = tuple(shard["shape"])
        _count(bytes=len(raw), ranges=1)
        out = torch.empty(shape, dtype=self.dtype) if not raw else \
            torch.frombuffer(raw, dtype=self.dtype).reshape(shape)
        self._cache[shard["file"]] = out
        return out

    def _read_ranges(self, shard: dict, lo, hi) -> torch.Tensor:
        """The box ``[lo, hi)`` (the shard's own coordinates) of one shard
        file. With ``validate``, or for the whole file, the file through
        ``_load`` (read once, its CRC32 checked); else the box's C-order
        runs of contiguous bytes and nothing else: one run by one read,
        several copied out of a read-only map of the file (the page cache
        pages in what they touch)."""
        shape = list(shard["shape"])
        if self.validate or (list(lo) == [0] * len(shape)
                             and list(hi) == shape):
            return self._load(shard)[tuple(slice(a, b)
                                           for a, b in zip(lo, hi))]
        item = torch.empty((), dtype=self.dtype).element_size()
        box = [b - a for a, b in zip(lo, hi)]
        k = len(shape) - 1  # the runs: dims k.. contiguous in the file
        while k > 0 and lo[k] == 0 and hi[k] == shape[k]:
            k -= 1
        runs = math.prod(box[:k])
        fpath = os.path.join(self.directory, shard["file"])
        if runs == 1:
            buf = np.empty(math.prod(box) * item, dtype=np.uint8)
            off = sum(a * math.prod(shape[j + 1:]) for j, a in enumerate(lo))
            with open(fpath, "rb") as f:
                got = 0
                while got < buf.nbytes:
                    n = os.preadv(f.fileno(), [memoryview(buf)[got:]],
                                  off * item + got)
                    if n <= 0:
                        raise IOError(f"short read of {fpath} for "
                                      f"{self.path!r}")
                    got += n
        else:
            mm = np.memmap(fpath, dtype=np.uint8, mode="r",
                           shape=(math.prod(shape) * item,))
            rows = mm.reshape(shape[:-1] + [shape[-1] * item])
            buf = rows[tuple(slice(a, b) for a, b in zip(lo[:-1], hi[:-1]))
                       + (slice(lo[-1] * item, hi[-1] * item),)].copy()
            del rows, mm
        _count(bytes=buf.nbytes, ranges=runs if buf.size else 0)
        return torch.from_numpy(buf).view(-1).view(self.dtype).reshape(box)

    def read_box(self, index) -> torch.Tensor:
        """The global slice ``index`` (a tuple of slices), from the byte
        ranges of the shard files that overlap it (``read_index``'s
        contract in the JAX package, at the granularity of ranges)."""
        starts = [sl.start for sl in index]
        stops = [sl.stop for sl in index]
        out = torch.empty([b - a for a, b in zip(starts, stops)],
                          dtype=self.dtype)
        covered = 0
        for shard in self.entry["shards"]:
            off, shp = shard["offset"], shard["shape"]
            lo = [max(a, o) for a, o in zip(starts, off)]
            hi = [min(b, o + n) for b, o, n in zip(stops, off, shp)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            piece = self._read_ranges(shard, [a - o for a, o in zip(lo, off)],
                                      [b - o for b, o in zip(hi, off)])
            out[tuple(slice(a - s, b - s) for a, b, s in
                      zip(lo, hi, starts))] = piece
            covered += math.prod(b - a for a, b in zip(lo, hi))
        if covered != out.numel():
            raise IOError(f"checkpoint for {self.path!r} is missing shard "
                          f"data for {index} (torn or foreign-topology save "
                          "without a merged manifest?)")
        return out

    def read_full(self) -> torch.Tensor:
        shards = self.entry["shards"]
        whole = [s for s in shards if not any(s["offset"])
                 and tuple(s["shape"]) == self.global_shape]
        if whole:
            return self._load(whole[0])
        out = torch.empty(self.global_shape, dtype=self.dtype)
        filled = torch.zeros(self.global_shape, dtype=torch.bool)
        for shard in shards:
            dst = tuple(slice(o, o + n)
                        for o, n in zip(shard["offset"], shard["shape"]))
            out[dst] = self._load(shard)
            filled[dst] = True
        if not bool(filled.all()):
            raise IOError(f"checkpoint for {self.path!r} is missing shard "
                          "data (torn or foreign-topology save without a "
                          "merged manifest?)")
        return out


def restore_array(directory: str, path: str, entry: dict, sharding=None,
                  validate: bool = True):
    """One array back as a CPU tensor, whole (assembled from its shards
    when a save wrote several), for no ``sharding`` or a replicated one;
    else this rank's block of the placement as a ``ShardedTensor``, read
    from the shard files it overlaps (from their byte ranges alone without
    ``validate``)."""
    reader = _ShardReader(directory, path, entry, validate=validate)
    if _whole(sharding):
        return reader.read_full()
    from ..distributed.resharding import ShardedTensor, block_of

    rank = _world()[0]
    flat = [int(r) for r in sharding.mesh.devices.reshape(-1)]
    if rank not in flat:
        raise ValueError(f"restore of {path!r} onto {sharding!r}: rank "
                         f"{rank} is not on its mesh")
    return ShardedTensor(block_of(reader.read_box, reader.global_shape,
                                  sharding, flat.index(rank)),
                         sharding, reader.global_shape)


def _live_reshard(leaf, entry: dict, sharding):
    """The resharding executor's device-to-device move of one live leaf
    (collective), or None when the leaf is not a ``ShardedTensor`` that
    matches the checkpoint's shape and dtype, or its move is not
    plannable: the caller then reads files."""
    from ..distributed import resharding as _rs
    from ..distributed.mesh import NamedSharding

    if not (isinstance(leaf, _rs.ShardedTensor)
            and isinstance(sharding, NamedSharding)):
        return None
    if list(leaf.shape) != list(entry["global_shape"]) \
            or _DTYPE_NAMES.get(leaf.dtype) != entry["dtype"]:
        return None
    try:
        plan = _rs.plan_for(leaf, sharding)
    except _rs.Unplannable:
        return None
    out = _rs.reshard(leaf, sharding, plan=plan)
    return out.block if sharding.is_replicated else out


def load_tree(directory: str, shardings=None, validate: bool = True,
              manifest: Optional[dict] = None, live_state=None):
    """Restore the full state tree: array leaves as CPU tensors (whole),
    or where ``shardings`` splits them this rank's block as a
    ``ShardedTensor``; JSON scalars as they were. ``shardings`` is a flat
    ``{path: NamedSharding}`` dict or a tree mirroring the state (None
    leaves: whole).

    ``live_state`` (a tree of the same structure, such as a train step's
    ``live_state()``) holds leaves still live on the ranks as
    ``ShardedTensor`` blocks: each one the checkpoint matches moves device
    to device through the resharding executor onto its placement, bitwise
    the file read (collective: every rank passes the same structure); any
    other leaf is read from the files."""
    m = manifest if manifest is not None else read_manifest(directory)
    flat_sh = {p: s for p, s in flatten_tree(shardings or {}).items()
               if s is not None}
    flat_live = flatten_tree(live_state) if live_state is not None else {}
    paths = []
    _unstructure(m["structure"], paths.append)
    missing = [p for p in paths if p not in m["arrays"]]
    if missing:
        raise KeyError(f"array {missing[0]!r} not present in checkpoint")
    arrays = {}
    for p in paths:  # collectives: one leaf at a time, in path order
        if p in flat_live and p in flat_sh:
            out = _live_reshard(flat_live[p], m["arrays"][p], flat_sh[p])
            if out is not None:
                arrays[p] = out
    _count(live=len(arrays), files=len(paths) - len(arrays))
    rest = [p for p in paths if p not in arrays]
    arrays.update(zip(rest, map_files(
        lambda p: restore_array(directory, p, m["arrays"][p],
                                sharding=flat_sh.get(p), validate=validate),
        rest)))
    return _unstructure(m["structure"], arrays.__getitem__)
