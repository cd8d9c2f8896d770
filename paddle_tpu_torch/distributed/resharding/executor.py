"""Execute ReshardPlans on ``torch.distributed``
(``paddle_tpu/distributed/resharding/executor.py`` analog).

A rank holds its block of a global array: a ``ShardedTensor``, the block
and its ``NamedSharding`` (the port's counterpart of a ``jax.Array`` on a
mesh). The planner's steps run over a REFINED mesh, the common
factorization of the source and destination rank grids laid over the
source mesh's flat rank order, and each step replays on the ranks that
vary along the refined axes it names:

- ``all_gather``: the group's blocks joined along ``dim`` in coordinate
  order (``communication.gather_blocks``);
- ``all_to_all``: the block cut along ``split_dim`` into one chunk per
  member, chunk ``j`` to the member at coordinate ``j``, what arrives
  joined along ``dim`` (``communication.all_to_all_blocks``);
- ``dynamic_slice``: this rank's chunk by its coordinates, no
  communication;
- ``reindex``: a local slice, then a ``ppermute``;
- ``ppermute``: matched ``isend``/``irecv`` pairs over the default group,
  no self-sends.

Payloads travel as their bytes (a plan moves values and computes
nothing), so every dtype crosses gloo and the result is bitwise the
global array's slice; a CUDA block on gloo passes through pinned host
memory, as every gloo collective of the port does. Nothing keeps a
collective's output past the step that reads it.

``reshard`` is collective: every rank of the world calls it for the same
leaves in the same order, and the source mesh spans the world. Groups are
made on first use, every rank making every group of an axis set in one
order, and cached. On gloo a rank that leaves the world while a peer's
receive is still in flight aborts that peer: a job that reshards ends
with a barrier before it destroys its process group.

A segmented dimension (``NamedSharding(segments=)``: the qkv projection
under mp) is planned segment by segment when each side has the same
segments there or does not split that dimension. Every other move, and
every one the planner cannot express (``Unplannable``: uneven chunks,
meshes with no common refinement, a growing rank set), takes the
gather-and-slice path: every block all-gathered over the world, the
global array assembled, this rank's destination block cut from it.
``reshard`` counts that path (``stats()["assembled"]`` and the reason);
``plan_for`` raises ``Unplannable`` for it, which the checkpoint's live
restore answers with file reads, as the JAX package's does.

``gather`` (and ``gather_tree`` over a tree) is the explicit way to the
whole array: every rank's block all-gathered over the world and
assembled on every rank, counted in ``stats()["gathered"]``. Nothing
else in the port turns a block into the whole array.

``stats()`` holds this rank's counters since ``reset_stats()``: the plans
run and their steps, the bytes this rank received from other ranks
(summed over the ranks they equal the plans' ``bytes_wire``), the plans'
``bytes_wire`` and ``bytes_naive`` (totals over all ranks, counted once
per plan on each rank), the seconds spent, the assembled leaves with
the bytes they received, and the explicit gathers with theirs.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..collective import group_of
from ..communication import _pinned, all_to_all_blocks, gather_blocks
from ..mesh import DeviceMesh, NamedSharding, spec_axes
from .planner import ReshardPlan, plan_reshard
from .spec import MeshSpec, ShardingSpec, Unplannable, shard_index_map

__all__ = ["ShardedTensor", "SegmentedPlan", "from_named_sharding",
           "plan_for", "reshard", "reshard_tree", "gather", "gather_tree",
           "block_pieces", "block_of", "clear_caches", "stats",
           "reset_stats"]

_plan_cache: Dict[Tuple, object] = {}
_group_cache: Dict[Tuple, object] = {}
_STATS: Dict[str, object] = {}


def reset_stats():
    _STATS.clear()
    _STATS.update(plans=0, steps=0, bytes_received=0, bytes_wire=0,
                  bytes_naive=0, seconds=0.0, assembled=0,
                  assembled_bytes_received=0, gathered=0,
                  gathered_bytes_received=0, reasons={})


reset_stats()


def stats() -> dict:
    """This rank's resharding counters (module docstring)."""
    return {**_STATS, "reasons": dict(_STATS["reasons"])}


def clear_caches():
    _plan_cache.clear()
    _group_cache.clear()


class ShardedTensor:
    """This rank's ``block`` of a global array that ``sharding`` places
    over a mesh of ranks; ``shape`` is the global array's (from the block
    and the chunk counts when not given). ``block`` is None on a rank
    the placement's mesh leaves out, which then gives ``shape`` and
    ``dtype``."""

    def __init__(self, block: Optional[torch.Tensor], sharding: NamedSharding,
                 shape: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None):
        self.block = block
        self.sharding = sharding
        if shape is None:
            counts = _chunk_counts(sharding, block.dim())
            shape = [n * c for n, c in zip(block.shape, counts)]
        self.shape = tuple(int(n) for n in shape)
        self._dtype = dtype

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype if self.block is not None else self._dtype

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, block="
                f"{None if self.block is None else tuple(self.block.shape)}, "
                f"{self.sharding!r})")


def _chunk_counts(sharding: NamedSharding, ndim: int) -> Tuple[int, ...]:
    sizes = sharding.mesh.shape
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return tuple(math.prod(sizes.get(a, 1) for a in spec_axes(e)) or 1
                 for e in spec[:ndim])


def from_named_sharding(sharding: NamedSharding, ndim: int) -> ShardingSpec:
    """The port's ``NamedSharding`` -> the planner's ``ShardingSpec``
    (its segments aside)."""
    mesh = MeshSpec(tuple(zip(sharding.mesh.axis_names,
                              (int(d) for d in sharding.mesh.devices.shape))))
    return ShardingSpec.make(mesh, list(sharding.spec), ndim=ndim)


def _flat(mesh: DeviceMesh) -> List[int]:
    return [int(r) for r in mesh.devices.reshape(-1)]


def _device_map(src_mesh: DeviceMesh, dst_mesh: DeviceMesh
                ) -> Tuple[int, ...]:
    """dst-extended linear position -> src linear index (phantom replica
    slots filled with the leftover source ranks, in order)."""
    src, dst = _flat(src_mesh), _flat(dst_mesh)
    pos = {r: i for i, r in enumerate(src)}
    try:
        base = [pos[r] for r in dst]
    except KeyError:
        raise Unplannable(
            "dst mesh uses ranks outside the src mesh — data cannot "
            "originate there; gather and slice") from None
    if len(set(base)) != len(base):
        raise Unplannable("dst mesh repeats a rank")
    if len(src) % len(dst):
        raise Unplannable(f"src world {len(src)} not a multiple of dst "
                          f"world {len(dst)}")
    taken = set(base)
    return tuple(base + [i for i in range(len(src)) if i not in taken])


def block_pieces(shape: Sequence[int], sharding: NamedSharding,
                 position: int):
    """The block of the rank at linear ``position`` of ``sharding``'s mesh:
    ``[(global slices, block slices)]``, one piece per segment of a
    segmented dimension (one piece without segments)."""
    shape = tuple(int(n) for n in shape)
    spec = from_named_sharding(sharding, len(shape))
    segs = dict(sharding.segments)
    if len(segs) > 1:
        raise ValueError(f"{sharding!r}: one segmented dimension at most")
    if not segs:
        box = shard_index_map(shape, spec)[position]
        return [(tuple(slice(a, b) for a, b in box),
                 tuple(slice(0, b - a) for a, b in box))]
    (d, sizes), = segs.items()
    if sum(sizes) != shape[d]:
        raise ValueError(f"segments {sizes} do not tile dim {d} of {shape}")
    n = spec.chunks(d)
    plain = list(shape)
    plain[d] = n  # the other dims' intervals; dim d's chunk index below
    box = shard_index_map(tuple(plain), spec)[position]
    k = box[d][0]
    out, start, local = [], 0, 0
    for s in sizes:
        if s % n:
            raise Unplannable(f"a segment of {s} along dim {d} does not "
                              f"split over {n} ranks")
        g = list(slice(a, b) for a, b in box)
        loc = list(slice(0, b - a) for a, b in box)
        g[d] = slice(start + k * (s // n), start + (k + 1) * (s // n))
        loc[d] = slice(local, local + s // n)
        out.append((tuple(g), tuple(loc)))
        start += s
        local += s // n
    return out


def block_of(read, shape: Sequence[int], sharding: NamedSharding,
             position: int) -> torch.Tensor:
    """The block of the rank at ``position``: ``read(global slices)`` of
    each piece (``block_pieces``), joined along the segmented dimension."""
    pieces = block_pieces(shape, sharding, position)
    if len(pieces) == 1:
        return read(pieces[0][0])
    return torch.cat([read(g) for g, _ in pieces],
                     dict(sharding.segments).popitem()[0])


@dataclass(frozen=True)
class SegmentedPlan:
    """One ``ReshardPlan`` per segment of dimension ``dim`` (``sizes``,
    whole), each over that segment as an array of its own."""
    dim: int
    sizes: Tuple[int, ...]
    plans: Tuple[ReshardPlan, ...]

    @property
    def steps(self):
        return tuple(s for p in self.plans for s in p.steps)

    @property
    def bytes_wire(self) -> int:
        return sum(p.bytes_wire for p in self.plans)

    @property
    def bytes_naive(self) -> int:
        return sum(p.bytes_naive for p in self.plans)


def _segmented(shape, src: NamedSharding, dst: NamedSharding):
    """``(dim, sizes)`` of the one segmented dimension both sides can
    plan segment by segment, None without segments; Unplannable when a
    side splits it contiguously or the sides' segments differ."""
    a, b = dict(src.segments), dict(dst.segments)
    dims = set(a) | set(b)
    if not dims:
        return None
    if len(dims) > 1:
        raise Unplannable(f"segments on dims {sorted(dims)}")
    d = dims.pop()
    if d in a and d in b and a[d] != b[d]:
        raise Unplannable(f"dim {d}: segments {a[d]} -> {b[d]}")
    for side, segs in ((src, a), (dst, b)):
        if d not in segs and _chunk_counts(side, len(shape))[d] > 1:
            raise Unplannable(
                f"dim {d} is segments {a.get(d, b.get(d))} on one side and "
                "one contiguous split on the other")
    return d, a.get(d, b.get(d))


def plan_for(arr: ShardedTensor, dst_sharding: NamedSharding):
    """Compile (and cache) the redistribution plan of one block: a
    ``ReshardPlan``, or a ``SegmentedPlan`` over a segmented dimension.
    Raises Unplannable when no portable decomposition exists."""
    if not isinstance(dst_sharding, NamedSharding):
        raise Unplannable(f"dst sharding {type(dst_sharding).__name__} is "
                          "not a NamedSharding")
    src = arr.sharding
    shape = arr.shape
    dtype = _dtype_name(arr.dtype)
    key = (shape, dtype, _key(src), _key(dst_sharding))
    plan = _plan_cache.get(key)
    if plan is not None:
        return plan
    itemsize = torch.empty((), dtype=arr.dtype).element_size()
    dmap = _device_map(src.mesh, dst_sharding.mesh)
    spec_s = from_named_sharding(src, len(shape))
    spec_d = from_named_sharding(dst_sharding, len(shape))
    seg = _segmented(shape, src, dst_sharding)
    if seg is None:
        plan = plan_reshard(shape, itemsize, spec_s, spec_d,
                            dst_device_map=dmap, dtype=dtype)
    else:
        d, sizes = seg
        plans = []
        for s in sizes:
            piece = shape[:d] + (s,) + shape[d + 1:]
            plans.append(plan_reshard(piece, itemsize, spec_s, spec_d,
                                      dst_device_map=dmap, dtype=dtype))
        plan = SegmentedPlan(d, tuple(sizes), tuple(plans))
    _plan_cache[key] = plan
    return plan


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _key(sh: NamedSharding) -> Tuple:
    return (sh.mesh.axis_names, tuple(sh.mesh.devices.shape),
            tuple(_flat(sh.mesh)), tuple(sh.spec), sh.segments)


# ---------------- the refined grid and its groups ----------------------
def _rows(sizes, names, axes) -> np.ndarray:
    """Linear positions of the refined grid, one row per group along
    ``axes`` (the other coordinates fixed, in row-major order), each row
    row-major over ``axes`` in their given order."""
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    idx = [names.index(a) for a in axes]
    rest = [i for i in range(len(sizes)) if i not in idx]
    n = math.prod(sizes[i] for i in idx)
    return np.transpose(grid, rest + idx).reshape(-1, n)


def _members(flat, sizes, names, axes, me) -> List[int]:
    """The ranks of this rank's group along ``axes``, in coordinate
    order."""
    for row in _rows(sizes, names, axes):
        ranks = [flat[p] for p in row]
        if me in ranks:
            return ranks
    raise ValueError(f"rank {me} is not on the refined grid")


def _group(flat, sizes, names, axes, me):
    """This rank's process group along ``axes`` (collective on first use:
    every rank makes every group of the axes, in one order) and its
    members in coordinate order."""
    world = id(dist.distributed_c10d._get_default_group()) \
        if dist.is_initialized() else None
    key = (world, tuple(flat), tuple(sizes), tuple(axes))
    groups = _group_cache.get(key)
    if groups is None:
        groups = []
        for row in _rows(sizes, names, axes):
            ranks = [flat[p] for p in row]
            groups.append((group_of(ranks), ranks))
        _group_cache[key] = groups
    for g, ranks in groups:
        if me in ranks:
            return g, ranks
    raise ValueError(f"rank {me} is not on the refined grid")


def _coord_index(coords: Dict[str, int], sizes: Dict[str, int], axes):
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    return b.view(dtype).view(shape)


def _me() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _on_gloo() -> bool:
    return dist.is_initialized() and str(dist.get_backend()) == "gloo"


def _ppermute(x, ranks, perm, me):
    """``x`` sent along ``perm`` (``(source, destination)`` positions over
    ``ranks``): returns what this rank receives, and the bytes received."""
    f = ranks.index(me)
    dst = [r for s, r in perm if s == f]
    src = [s for s, r in perm if r == f]
    if not dst or not src:
        raise ValueError(f"position {f} is not in the permutation {perm}")
    if dst[0] == f:
        return x, 0
    payload = _bytes(x)
    staged = payload.is_cuda and _on_gloo()
    send = _pinned(payload) if staged else payload
    recv = torch.empty(send.shape, dtype=torch.uint8, device=send.device,
                       pin_memory=staged)
    works = [dist.isend(send, ranks[dst[0]]), dist.irecv(recv, ranks[src[0]])]
    for w in works:
        w.wait()
    if staged:
        recv = recv.to(payload.device)
    return _from_bytes(recv, x.dtype, x.shape), recv.numel()


def _execute(plan: ReshardPlan, x: torch.Tensor, src_mesh: DeviceMesh):
    """Replay ``plan`` on this rank's block ``x``; returns this rank's
    block of the destination layout (as placed by the plan's device map)
    and the bytes received."""
    flat = _flat(src_mesh)
    me = _me()
    names = [n for n, _ in plan.refined_axes] or ["r0"]
    sizes = [s for _, s in plan.refined_axes] or [1]
    size_of = dict(zip(names, sizes))
    pos = flat.index(me)
    coords = dict(zip(names, np.unravel_index(pos, sizes)))
    coords = {k: int(v) for k, v in coords.items()}
    received = 0
    for st in plan.steps:
        if st.op == "all_gather":
            g, ranks = _group(flat, sizes, names, st.axes, me)
            blocks = gather_blocks(_bytes(x), g)
            parts = [_from_bytes(blocks[g.ranks.index(r)], x.dtype, x.shape)
                     for r in ranks]
            received += (len(ranks) - 1) * x.numel() * x.element_size()
            x = torch.cat(parts, st.dim)
        elif st.op == "all_to_all":
            g, ranks = _group(flat, sizes, names, st.axes, me)
            chunks = x.chunk(len(ranks), st.split_dim)
            stacked = torch.stack([_bytes(chunks[ranks.index(r)])
                                   for r in g.ranks])
            got = all_to_all_blocks(stacked, g)
            shape = chunks[0].shape
            parts = [_from_bytes(got[g.ranks.index(r)], x.dtype, shape)
                     for r in ranks]
            received += (len(ranks) - 1) * chunks[0].numel() \
                * x.element_size()
            x = torch.cat(parts, st.dim)
        elif st.op == "dynamic_slice":
            chunk = x.shape[st.dim] // st.parts
            x = x.narrow(st.dim, _coord_index(coords, size_of, st.axes)
                         * chunk, chunk)
        elif st.op in ("reindex", "ppermute"):
            if st.op == "reindex":
                sub = x.shape[st.dim] // st.parts
                x = x.narrow(st.dim, _coord_index(coords, size_of,
                                                  st.sub_axes) * sub, sub)
            ranks = _members(flat, sizes, names, st.axes, me)
            x, got = _ppermute(x, ranks, st.perm, me)
            received += got
        else:  # pragma: no cover - the planner emits only the ops above
            raise ValueError(f"unknown reshard step {st.op!r}")
    return x.contiguous(), received


def _assemble(arr: ShardedTensor, dst: NamedSharding, reason: str):
    """The gather-and-slice path: every rank's block all-gathered over the
    source mesh (the world), the global array assembled, this rank's block
    of ``dst`` cut from it (None off ``dst``'s mesh). Counted."""
    src = arr.sharding
    flat = _flat(src.mesh)
    x = arr.block
    g = group_of(flat)
    blocks = gather_blocks(_bytes(x), g)
    whole = torch.empty(arr.shape, dtype=x.dtype, device=x.device)
    for p, r in enumerate(flat):
        b = _from_bytes(blocks[g.ranks.index(r)], x.dtype, x.shape)
        for gs, ls in block_pieces(arr.shape, src, p):
            whole[gs] = b[ls]
    got = (len(flat) - 1) * x.numel() * x.element_size()
    _STATS["assembled"] += 1
    _STATS["assembled_bytes_received"] += got
    _STATS["reasons"][reason] = _STATS["reasons"].get(reason, 0) + 1
    return _cut(whole, dst)


def _cut(whole: torch.Tensor, dst: NamedSharding) -> Optional[torch.Tensor]:
    """This rank's block of ``dst`` from the global array (None off its
    mesh)."""
    dflat = _flat(dst.mesh)
    me = _me()
    if me not in dflat:
        return None
    return block_of(whole.__getitem__, whole.shape, dst,
                    dflat.index(me)).contiguous()


def _check_world(mesh: DeviceMesh):
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sorted(_flat(mesh)) != list(range(world)):
        raise ValueError(f"reshard runs over the whole world of {world} "
                         f"ranks; the source mesh holds {_flat(mesh)}")


def reshard(arr: ShardedTensor, dst_sharding: NamedSharding, *,
            plan=None) -> ShardedTensor:
    """Move ``arr`` onto ``dst_sharding`` through the planner's collectives
    (collective over the world): this rank's block of the destination,
    bitwise the global array's slice. A move ``plan_for`` cannot plan
    takes the counted gather-and-slice path. A rank off the destination's
    mesh gets a ``ShardedTensor`` whose block is None."""
    if not isinstance(arr, ShardedTensor):
        raise TypeError(f"reshard takes a ShardedTensor (a block and its "
                        f"NamedSharding), got {type(arr).__name__}")
    _check_world(arr.sharding.mesh)
    t0 = time.perf_counter()
    me = _me()
    dflat = _flat(dst_sharding.mesh)
    try:
        if plan is None:
            plan = plan_for(arr, dst_sharding)
    except Unplannable as e:
        block = _assemble(arr, dst_sharding, str(e).split(":")[0])
        _STATS["seconds"] += time.perf_counter() - t0
        return ShardedTensor(block, dst_sharding, arr.shape, arr.dtype)
    x = arr.block
    received = 0
    if isinstance(plan, SegmentedPlan):
        d = plan.dim
        n = _chunk_counts(arr.sharding, x.dim())[d]
        outs, start = [], 0
        for s, sub in zip(plan.sizes, plan.plans):
            piece = x.narrow(d, start, s // n)
            start += s // n
            y, got = _execute(sub, piece, arr.sharding.mesh)
            outs.append(y)
            received += got
        block = torch.cat(outs, d)
    elif plan.steps:
        block, received = _execute(plan, x, arr.sharding.mesh)
    else:
        block = x  # the layouts already agree rank for rank
    _STATS["plans"] += 1
    _STATS["steps"] += len(plan.steps)
    _STATS["bytes_received"] += received
    _STATS["bytes_wire"] += plan.bytes_wire
    _STATS["bytes_naive"] += plan.bytes_naive
    _STATS["seconds"] += time.perf_counter() - t0
    return ShardedTensor(block if me in dflat else None, dst_sharding,
                         arr.shape, arr.dtype)


def gather(arr: ShardedTensor) -> torch.Tensor:
    """The whole array of ``arr`` on every rank: each rank's block (zeros
    on a rank off the placement's mesh, on the CPU when it has no block)
    all-gathered over the world and assembled by the blocks' positions
    (collective: every rank calls it for the same leaves in the same
    order). Counted in ``stats()["gathered"]``; a placement whose mesh is
    the world and that splits nothing moves nothing."""
    sh = arr.sharding
    flat = _flat(sh.mesh)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sh.is_replicated and sorted(flat) == list(range(world)):
        return arr.block
    counts = _chunk_counts(sh, len(arr.shape))
    x = arr.block if arr.block is not None else torch.zeros(
        [n // c for n, c in zip(arr.shape, counts)], dtype=arr.dtype)
    g = group_of(list(range(world)))
    blocks = gather_blocks(_bytes(x), g)
    whole = torch.empty(arr.shape, dtype=x.dtype, device=x.device)
    for p, r in enumerate(flat):
        b = _from_bytes(blocks[r], x.dtype, x.shape)
        for gs, ls in block_pieces(arr.shape, sh, p):
            whole[gs] = b[ls]
    _STATS["gathered"] += 1
    _STATS["gathered_bytes_received"] += (world - 1) * x.numel() \
        * x.element_size()
    return whole


def gather_tree(tree):
    """``tree`` with every ``ShardedTensor`` leaf ``gather``-ed into its
    whole array (collective); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return gather(tree) if isinstance(tree, ShardedTensor) else tree


def reshard_tree(tree, shardings):
    """Leafwise ``reshard`` of a tree of ``ShardedTensor`` leaves onto a
    matching tree of shardings (None leaves, and leaves that are not
    ``ShardedTensor``, pass through)."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, (shardings or {}).get(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        sh = shardings if shardings is not None else [None] * len(tree)
        return type(tree)(reshard_tree(v, s) for v, s in zip(tree, sh))
    if shardings is None or not isinstance(tree, ShardedTensor):
        return tree
    return reshard(tree, shardings)
