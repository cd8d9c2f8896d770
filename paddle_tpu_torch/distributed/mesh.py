"""The process-global device mesh (``paddle_tpu/distributed/mesh.py``
analog), over ``torch.distributed`` ranks.

The JAX package's mesh is a ``jax.sharding.Mesh`` over devices, all driven
by one controller. Here every rank is a process with one device of its
own, so a ``DeviceMesh`` names axes over the world's *ranks*, laid out in
C order as the JAX package lays devices out (``HYBRID_AXES``: the
innermost axis varies fastest). Placements over it are the port's own
``PartitionSpec`` (axis names per dimension) and ``NamedSharding(mesh,
spec)``: plain records that the train step, the feeder and the checkpoint
read; nothing here moves data.

``init_distributed_runtime`` forms the process group from the launcher's
environment, the same contract as the JAX package's (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER`` or ``MASTER_ADDR``). The master
is ``host:port`` (a TCP store, ``tcp://`` optional) or a ``file://`` path
(a file store: no port to pick). The backend is NCCL for a CUDA device and
gloo for the CPU unless ``PADDLE_DISTRI_BACKEND`` names one; it is never
switched when the group fails to form.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_global_mesh: Optional["DeviceMesh"] = None

# Canonical hybrid axis order, outermost -> innermost; the innermost axis
# varies fastest over the ranks (the JAX package's rank-assignment rule)
HYBRID_AXES = ("dp", "pp", "sharding", "mp")


class DeviceMesh:
    """Named axes over ranks: ``devices`` is an integer array of global
    ranks shaped by the axes (the JAX ``Mesh``'s device grid, each entry a
    process and its one device); ``shape`` maps each axis to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """The rank's coordinate on each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def groups_along(self, axes: Sequence[str]):
        """The rank lists that vary only along ``axes`` (all of them, in a
        fixed order every rank computes alike: one per coordinate of the
        other axes)."""
        axes = [a for a in self.axis_names if a in set(axes)]
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in idx]
        grid = np.transpose(self.devices, rest + idx)
        n = int(np.prod([self.devices.shape[i] for i in idx])) if idx else 1
        return [sorted(int(r) for r in row) for row in grid.reshape(-1, n)]

    def __eq__(self, other):
        return (isinstance(other, DeviceMesh)
                and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __repr__(self):
        return f"DeviceMesh({self.shape}, ranks={self.devices.tolist()})"


class PartitionSpec(tuple):
    """Per dimension, the mesh axis (a name, a tuple of names, or None)
    that dimension is split over: ``PartitionSpec(("dp", "sharding"))``
    splits dim 0 over both axes."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class NamedSharding:
    """A placement: ``spec`` over ``mesh``. ``is_replicated`` when no
    dimension is split over an axis of more than one rank.

    ``segments`` (``{dim: sizes}``) marks a dimension made of segments
    that are split each on their own (the fused qkv projection's q | k | v
    columns under mp): a rank's block of that dimension is its chunk of
    every segment, side by side (``sharding_utils.local_block``), not one
    contiguous chunk."""

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec, *,
                 segments=None):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.segments = tuple(sorted(
            (int(d), tuple(int(n) for n in sizes))
            for d, sizes in dict(segments or {}).items()
            if sizes is not None and len(sizes) > 1))

    @property
    def is_replicated(self) -> bool:
        sizes = self.mesh.shape
        return all(sizes.get(a, 1) == 1 for a in spec_axes(self.spec))

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec
                and self.segments == other.segments)

    def __repr__(self):
        seg = f", segments={dict(self.segments)}" if self.segments else ""
        return f"NamedSharding({self.mesh!r}, {self.spec!r}{seg})"


def spec_axes(spec) -> tuple:
    """Every axis name a spec entry or a whole spec mentions, in order."""
    out = []
    for e in spec if isinstance(spec, tuple) else (spec,):
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return tuple(out)


def build_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None
               ) -> DeviceMesh:
    """A named mesh from ``{axis_name: size}``, C order over the ranks
    (``devices``: the ranks to use, by default the whole world)."""
    devices = list(devices) if devices is not None \
        else list(range(device_count()))
    sizes = list(axes.values())
    n = int(np.prod(sizes)) if sizes else 1
    if n > len(devices):
        raise ValueError(f"mesh {axes} needs {n} ranks, only {len(devices)} "
                         "available")
    return DeviceMesh(np.array(devices[:n]).reshape(sizes), tuple(axes))


def set_global_mesh(mesh: DeviceMesh) -> DeviceMesh:
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_global_mesh() -> DeviceMesh:
    """The process-global mesh; lazily a 1-D ``world`` mesh over every
    rank."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh({"world": device_count()})
    return _global_mesh


def current_mesh() -> Optional[DeviceMesh]:
    """The process-global mesh if one was set, else None (never builds
    one)."""
    return _global_mesh


def reset_global_mesh():
    global _global_mesh
    _global_mesh = None


def device_count() -> int:
    """The world's devices: one per rank, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_for(device: torch.device) -> str:
    """``PADDLE_DISTRI_BACKEND`` when set, else NCCL for a CUDA device and
    gloo for the CPU."""
    name = os.environ.get("PADDLE_DISTRI_BACKEND")
    if name:
        return name.lower()
    return "nccl" if device.type == "cuda" else "gloo"


def _init_method(master: str) -> str:
    if master.startswith(("file://", "tcp://", "env://")):
        return master
    if ":" not in master and os.environ.get("MASTER_PORT"):
        master = f"{master}:{os.environ['MASTER_PORT']}"
    return f"tcp://{master}"


def init_distributed_runtime(*, device=None):
    """Form the default process group from the launcher's environment, once:
    when ``PADDLE_TRAINERS_NUM`` is above 1 or a master is named (a group
    of one rank, which NCCL and gloo run as well). ``device`` (default
    ``cuda``, which must exist) picks the backend; a CUDA device with an
    index becomes the current device first. Without a master and at one
    trainer there is nothing to form."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = os.environ.get("PADDLE_MASTER") or os.environ.get("MASTER_ADDR")
    if world <= 1 and not master:
        return
    if not master:
        raise ValueError(f"PADDLE_TRAINERS_NUM={world} but neither "
                         "PADDLE_MASTER nor MASTER_ADDR names a place to "
                         "meet (host:port or file:///path)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend_for(dev), init_method=_init_method(master),
        world_size=world, rank=int(os.environ.get("PADDLE_TRAINER_ID", "0")))
