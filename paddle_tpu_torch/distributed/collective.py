"""Process groups (``paddle_tpu/distributed/collective.py`` analog) over
``torch.distributed``.

A ``Group`` is a set of global ranks, the mesh and axis it was cut from,
and the ``torch.distributed`` process group its collectives run on. A
group of one rank needs no process group (``process_group`` None: its
collectives are the identity), and a group of the whole world uses the
default one (at a world of one rank too). ``new_group`` is collective, as
``torch.distributed``'s is: every rank calls it for every group, in the
same order.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch.distributed as dist

from .mesh import DeviceMesh, get_global_mesh, reset_global_mesh

_group_counter = itertools.count(1)
_groups = {}
_default_group: Optional["Group"] = None


class Group:
    """A set of ranks with a mesh axis and a process group to communicate
    over (``process_group``: the ``torch.distributed`` group, or None for a
    group of one rank)."""

    def __init__(self, ranks: Sequence[int], mesh: Optional[DeviceMesh] = None,
                 axis_name: Optional[str] = None, gid: Optional[int] = None,
                 name: Optional[str] = None, *, process_group=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.mesh = mesh
        self.axis_name = axis_name
        self.id = gid if gid is not None else next(_group_counter)
        self.name = name or f"_default_pg{self.id}"
        self._pg = process_group

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def process_group(self):
        return self._pg

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank) if global_rank in self.ranks \
            else -1

    @property
    def rank(self) -> int:
        from .parallel import get_rank

        return self.get_group_rank(get_rank())

    def is_member(self) -> bool:
        from .parallel import get_rank

        return get_rank() in self.ranks

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis_name!r}, "
                f"ranks={self.ranks})")


def _get_global_group() -> Group:
    global _default_group
    if _default_group is None:
        mesh = get_global_mesh()
        _default_group = Group(
            list(range(mesh.size)), mesh, mesh.axis_names[0], gid=0,
            name="_default_pg",
            process_group=dist.group.WORLD if dist.is_initialized() else None)
        _groups[0] = _default_group
    return _default_group


def _resolve_group(group) -> Group:
    if group is None:
        return _get_global_group()
    if isinstance(group, int):
        return _groups[group]
    return group


def group_of(ranks: Sequence[int], mesh=None, axis_name=None, name=None,
             backend=None) -> Group:
    """A group over ``ranks``: the world's default process group when they
    are the whole world (and no other backend is asked for), none for any
    other single rank, else a new one. Collective: every rank calls it for
    every group in the same order."""
    ranks = sorted(int(r) for r in ranks)
    if not dist.is_initialized():
        if len(ranks) > 1:
            raise RuntimeError(f"a group of ranks {ranks} needs "
                               "torch.distributed: call init_parallel_env()")
        pg = None
    elif ranks == list(range(dist.get_world_size())) and (
            backend is None or backend == dist.get_backend()):
        pg = dist.group.WORLD
    elif len(ranks) == 1 and backend is None:
        pg = None
    else:
        pg = dist.new_group(ranks, backend=backend)
    g = Group(ranks, mesh, axis_name, name=name, process_group=pg)
    _groups[g.id] = g
    return g


def new_group(ranks: Optional[List[int]] = None, backend: str = None,
              timeout=None) -> Group:
    """paddle.distributed.new_group: a group of ``ranks`` (default every
    rank) on a new process group of ``backend`` (default the world's)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = sorted(range(world) if ranks is None else ranks)
    if not dist.is_initialized():
        return group_of(ranks, name=None)
    pg = dist.new_group(ranks, timeout=timeout, backend=backend)
    g = Group(ranks, process_group=pg)
    _groups[g.id] = g
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _get_global_group()
    return _groups.get(gid)


def destroy_process_group(group=None):
    """Forget ``group``; with None, leave the distributed world: every
    group, the global mesh and the hybrid topology built on them, and the
    ``torch.distributed`` default group."""
    global _default_group
    if group is not None:
        _groups.pop(_resolve_group(group).id, None)
        return
    from . import parallel, topology

    _groups.clear()
    _alone.clear()
    _default_group = None
    reset_global_mesh()
    topology.set_hybrid_communicate_group(None)
    parallel._parallel_env = None
    if dist.is_initialized():
        dist.destroy_process_group()


_alone = {}


def axis_group(axis) -> Group:
    """This rank's group along mesh axis ``axis`` (a ``Group`` is returned
    as it is): the hybrid topology's group for that axis (``"model"`` and
    the other paddle names alias the mesh's), else a group of this rank
    alone, whose collectives change nothing. An axis of more than one rank
    on the global mesh without a hybrid topology raises: its groups come
    from ``fleet.init``."""
    if isinstance(axis, Group):
        return axis
    from .mesh import current_mesh
    from .topology import _AXIS_ALIAS, get_hybrid_communicate_group

    axis = _AXIS_ALIAS.get(axis, axis)
    hcg = get_hybrid_communicate_group()
    if hcg is not None and axis in hcg._groups:
        return hcg._groups[axis]
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get(axis, 1) > 1:
        raise ValueError(f"mesh axis {axis!r} of {mesh.shape[axis]} ranks "
                         "has no groups: build them with fleet.init")
    from .parallel import get_rank

    key = (axis, get_rank())
    if key not in _alone:
        _alone[key] = Group([get_rank()], axis_name=axis, name=f"{axis}_self")
    return _alone[key]


def is_initialized() -> bool:
    return _default_group is not None
