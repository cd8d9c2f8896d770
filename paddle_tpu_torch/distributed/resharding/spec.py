"""Pure-python mesh/sharding descriptions for the resharding planner
(``paddle_tpu/distributed/resharding/spec.py``, kept as the port's own
copy: the same classes, chunking and errors).

The conversion from the port's ``NamedSharding`` (``distributed.mesh``)
to these specs lives in executor.py.

Device identity is a LINEAR index into the mesh's flat device list
(C-order over the axis grid, the same enumeration ``DeviceMesh.devices.flat``
uses: there, the ranks). Two meshes over the same ranks may enumerate them
differently; the planner reconciles that with an explicit device map, not
here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["Unplannable", "MeshSpec", "ShardingSpec", "normalize_entries",
           "shard_index_map"]

SpecEntry = Union[None, str, Tuple[str, ...]]


class Unplannable(ValueError):
    """This move has no portable collective decomposition here (uneven
    chunking, incompatible mesh factorizations, foreign device sets...).
    Callers take the counted gather-and-slice path or read files."""


@dataclass(frozen=True)
class MeshSpec:
    """Ordered (axis name, size) pairs; linear device index is C-order."""
    axes: Tuple[Tuple[str, int], ...]

    def __post_init__(self):
        seen = set()
        for name, size in self.axes:
            if not isinstance(name, str) or not name:
                raise ValueError(f"bad mesh axis name {name!r}")
            if name in seen:
                raise ValueError(f"duplicate mesh axis {name!r}")
            seen.add(name)
            if int(size) < 1:
                raise ValueError(f"mesh axis {name}={size}: size must be >= 1")

    @classmethod
    def make(cls, axes) -> "MeshSpec":
        """From {name: size} (ordered) or [(name, size)]."""
        items = axes.items() if isinstance(axes, dict) else axes
        return cls(tuple((str(n), int(s)) for n, s in items))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def world(self) -> int:
        return math.prod(self.sizes) if self.axes else 1

    def size_of(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        raise KeyError(name)

    def coords(self, linear: int) -> Tuple[int, ...]:
        """C-order unravel of a linear device index."""
        out: List[int] = []
        for size in reversed(self.sizes):
            out.append(linear % size)
            linear //= size
        return tuple(reversed(out))


def normalize_entries(spec: Sequence[SpecEntry], ndim: int,
                      mesh: MeshSpec) -> Tuple[Tuple[str, ...], ...]:
    """Per-dim axis tuples, padded to ndim: None -> (), "a" -> ("a",).
    Validates axis existence and the use-each-axis-at-most-once rule."""
    entries: List[Tuple[str, ...]] = []
    for e in spec:
        if e is None:
            entries.append(())
        elif isinstance(e, str):
            entries.append((e,))
        elif isinstance(e, (tuple, list)):
            entries.append(tuple(str(a) for a in e))
        else:
            raise ValueError(f"bad partition-spec entry {e!r}")
    if len(entries) > ndim:
        raise ValueError(f"spec has {len(entries)} entries for rank {ndim}")
    entries += [()] * (ndim - len(entries))
    names = set(mesh.names)
    used = set()
    for ent in entries:
        for a in ent:
            if a not in names:
                raise ValueError(f"spec axis {a!r} not in mesh {mesh.names}")
            if a in used:
                raise ValueError(f"spec uses mesh axis {a!r} twice")
            used.add(a)
    return tuple(entries)


@dataclass(frozen=True)
class ShardingSpec:
    """A NamedSharding as plain data: mesh + per-dim axis tuples."""
    mesh: MeshSpec
    spec: Tuple[Tuple[str, ...], ...]

    @classmethod
    def make(cls, mesh: MeshSpec, spec: Sequence[SpecEntry],
             ndim: Optional[int] = None) -> "ShardingSpec":
        if ndim is None:
            ndim = len(spec)
        return cls(mesh, normalize_entries(spec, ndim, mesh))

    def chunks(self, dim: int) -> int:
        """How many ways dimension `dim` is chunked."""
        return math.prod(self.mesh.size_of(a) for a in self.spec[dim]) or 1

    def chunk_counts(self) -> Tuple[int, ...]:
        return tuple(self.chunks(d) for d in range(len(self.spec)))

    def check_divisible(self, shape: Sequence[int]):
        if len(shape) != len(self.spec):
            raise ValueError(f"shape rank {len(shape)} != spec rank "
                             f"{len(self.spec)}")
        for d, n in enumerate(shape):
            c = self.chunks(d)
            if int(n) % c:
                raise Unplannable(
                    f"dim {d} of size {n} is not divisible by its chunk "
                    f"count {c} (axes {self.spec[d]}); uneven shardings are "
                    "not plannable — use the gather-and-slice path")


def shard_index_map(shape: Sequence[int], sharding: ShardingSpec
                    ) -> List[Tuple[Tuple[int, int], ...]]:
    """linear device index -> per-dim (start, stop) half-open intervals,
    implementing the NamedSharding chunking: dim d is split into
    prod(sizes of spec[d]) equal chunks; a device's chunk index is the
    mixed-radix fold of its coordinates on those axes, first axis major."""
    sharding.check_divisible(shape)
    mesh = sharding.mesh
    axis_pos = {n: i for i, n in enumerate(mesh.names)}
    out = []
    for lin in range(mesh.world):
        coords = mesh.coords(lin)
        idx: List[Tuple[int, int]] = []
        for d, n in enumerate(shape):
            c = sharding.chunks(d)
            k = 0
            for a in sharding.spec[d]:
                k = k * mesh.size_of(a) + coords[axis_pos[a]]
            step = int(n) // c
            idx.append((k * step, (k + 1) * step))
        out.append(tuple(idx))
    return out


def describe_sharding(shape: Sequence[int], sharding: ShardingSpec) -> Dict:
    """JSON-friendly summary of a placement."""
    return {
        "mesh": {n: s for n, s in sharding.mesh.axes},
        "spec": [list(e) if e else None for e in sharding.spec],
        "chunk_counts": list(sharding.chunk_counts()),
        "shard_shape": [int(n) // c for n, c in
                        zip(shape, sharding.chunk_counts())],
    }
