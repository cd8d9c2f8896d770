"""Placement records and the block arithmetic of sharded parameters
(``paddle_tpu/distributed/sharding_utils.py`` analog).

The JAX package annotates a parameter with a ``PartitionSpec`` and lets
GSPMD partition the program. The port keeps the same annotation
(``annotate_parameter``: ``dist_spec`` and ``is_distributed`` on the
``nn.Parameter``) but the tensor a rank holds is already its block, so
the annotation here records what the block is a piece of. A dimension
split over an axis of ``n`` ranks gives rank ``r`` chunk ``r`` of it; a
dimension made of several ``segments`` (the fused qkv projection's
columns: q | k | v) gives rank ``r`` chunk ``r`` of each segment, side by
side (``local_block``, and ``assemble`` its inverse over every rank's
block).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mesh import NamedSharding, PartitionSpec, spec_axes

#: the expert-parallel mesh axis: it splits the experts and carries data
EP_AXIS = "ep"
#: the mesh axes that carry the global batch on dim 0, in the train step's
#: ``batch_spec`` order: dp, the ZeRO axis (a sharded optimizer is data
#: parallelism for activations) and ep
DATA_AXES = ("dp", "sharding", EP_AXIS)


def data_axes(*, mesh=None):
    """The axes of ``mesh`` (default: the hybrid topology's, else the
    global mesh) that carry the batch."""
    if mesh is None:
        from .mesh import current_mesh
        from .topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        mesh = hcg.get_mesh() if hcg is not None else current_mesh()
    names = () if mesh is None else mesh.axis_names
    return tuple(a for a in DATA_AXES if a in names)


def annotate_parameter(param, spec):
    """Record the placement ``spec`` on ``param`` (``dist_spec``) and
    whether any dimension is split (``is_distributed``)."""
    param.dist_spec = PartitionSpec(*spec)
    param.is_distributed = any(s is not None for s in spec)
    return param


def resolve_spec(spec, mesh) -> PartitionSpec:
    """Drop spec axes the mesh does not have (an mp spec on a dp-only mesh
    is replicated), as the JAX step resolves its specs."""
    if spec is None:
        return PartitionSpec()
    if not isinstance(spec, tuple):
        raise TypeError(f"a spec must be a PartitionSpec, got "
                        f"{type(spec).__name__}")
    out = []
    for e in spec:
        kept = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a in mesh.axis_names)
        out.append(None if not kept else kept if isinstance(e, tuple)
                   else kept[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placement(param, mesh, extra: Optional[Sequence] = None
              ) -> NamedSharding:
    """The placement of the block ``param`` holds on ``mesh``: its
    ``dist_spec`` resolved on the mesh, with ``extra`` (a spec that adds
    an axis to a dimension, such as ZeRO's slice) merged in, and the qkv
    projection's segments when it is split over an ``mp`` axis of more
    than one rank."""
    spec = list(resolve_spec(getattr(param, "dist_spec", None), mesh))
    for d, e in enumerate(extra or ()):
        if e is not None:
            spec += [None] * (d + 1 - len(spec))
            spec[d] = e
    segments = getattr(param, "mp_segments", None)
    split = getattr(param, "mp_dim", None) is not None and "mp" in spec_axes(
        PartitionSpec(*spec)) and mesh.shape.get("mp", 1) > 1
    return NamedSharding(mesh, resolve_spec(PartitionSpec(*spec), mesh),
                         segments={param.mp_dim: segments}
                         if split and segments else None)


def spec_dim(spec, axis: str) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis``, or None."""
    for i, e in enumerate(spec or ()):
        if axis in spec_axes(e):
            return i
    return None


def _pieces(size: int, segments: Optional[Sequence[int]]):
    segments = tuple(segments) if segments else (size,)
    if sum(segments) != size:
        raise ValueError(f"segments {segments} do not tile a dimension of "
                         f"{size}")
    return segments


def local_block(t: torch.Tensor, dim: int, rank: int, n: int,
                segments: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` split ``n`` ways along ``dim``: chunk
    ``rank`` of each segment, side by side (a view when there is one
    segment)."""
    if n == 1:
        return t
    out, start = [], 0
    for s in _pieces(t.shape[dim], segments):
        if s % n:
            raise ValueError(f"a segment of {s} along dim {dim} does not "
                             f"split over {n} ranks")
        out.append(t.narrow(dim, start + rank * (s // n), s // n))
        start += s
    return out[0] if len(out) == 1 else torch.cat(out, dim)


def assemble(blocks: Sequence[torch.Tensor], dim: int,
             segments: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The whole tensor from every rank's block, in rank order (the
    inverse of ``local_block``). ``segments`` are the whole tensor's."""
    n = len(blocks)
    if n == 1:
        return blocks[0]
    size = blocks[0].shape[dim] * n
    out, start = [], 0
    for s in _pieces(size, segments):
        out += [b.narrow(dim, start, s // n) for b in blocks]
        start += s // n
    return torch.cat(out, dim)
