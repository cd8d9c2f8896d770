"""NamedSharding -> NamedSharding redistribution compiler, pure Python
(``paddle_tpu/distributed/resharding/planner.py``, kept as the port's own
copy: the same plans, steps and byte counts for the same specs).

Decomposes an arbitrary sharding->sharding move into a short deterministic
sequence of PORTABLE collective steps — all_gather / all_to_all /
dynamic_slice / ppermute per mesh axis (arXiv 2112.01075), planned as a
compiled schedule (GC3, arXiv 2201.11840) rather than discovered at run
time. The executor (executor.py) replays them on ``torch.distributed``
groups over the ranks.

How a plan is built
-------------------
1. Both meshes are factored into one COMMON REFINEMENT of the linear
   device space: merged prefix products of the two axis-size lists, each
   original axis a contiguous run of refined axes (src (2,2) and dst (4,)
   refine to (2,2); (2,3) vs (3,2) has no integer refinement ->
   Unplannable). A dst mesh over FEWER devices is lifted with a leading
   phantom replica axis (the extra source devices compute replicas that
   are simply not consumed). Both PartitionSpecs are rewritten over
   refined axes, and planning happens per array dimension on those axis
   tuples.
2. Greedy step emission, cheapest first, until cur == dst per dim:
     slice    zero-wire: append the next dst axis when it is free
              (replicated) — each device keeps 1/n of its local chunk
     reindex  dst refines a dim this device-set already chunks
              (cur extras are a suffix of dst extras, fresh axes in
              between): one local dynamic_slice + one ppermute moves
              exactly the needed sub-chunk — the big win over
              gather-then-reslice
     all_to_all  one extra axis on dim d that dst wants next on dim e:
              transpose-style move at (n-1)/n of local bytes
     all_gather  fallback: drop the innermost extra axis of some dim
3. If the dst mesh enumerates physical devices in a different order, one
   final whole-shard ppermute rebinds shards to the right devices.

Byte accounting is TOTAL bytes received across all devices (self-sends
and replica hits excluded). `bytes_naive` is the replicate-then-slice
baseline the plan replaces: all_gather everything everywhere, slice
locally = world * full_bytes - sum(per-device source bytes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .spec import MeshSpec, ShardingSpec, Unplannable, shard_index_map

__all__ = ["ReshardStep", "ReshardPlan", "plan_reshard", "plan_sends",
           "describe", "plan_as_dict", "PHANTOM_AXIS"]

PHANTOM_AXIS = "__replica__"  # reserved lift axis for shrinking moves


@dataclass(frozen=True)
class ReshardStep:
    """One portable collective over the refined mesh.

    op: "all_gather" | "all_to_all" | "dynamic_slice" | "reindex"
        | "ppermute"
    axes: refined mesh axes the step runs over (reindex: sub_axes + the
        kept chunk axes, in ppermute linearization order; ppermute: every
        refined axis)
    dim/split_dim: array dims (all_to_all concatenates dim, splits
        split_dim; others use dim only)
    parts: chunk count the step introduces/removes on `dim` (reindex: the
        local split factor |sub_axes|)
    sub_axes: reindex only — the fresh dst axes whose mixed-radix
        coordinate selects each device's local sub-chunk
    perm: (source, destination) pairs over the row-major linearization of
        `axes` (reindex/ppermute)
    bytes_wire: total bytes received from OTHER devices, summed over all
        devices
    """
    op: str
    axes: Tuple[str, ...]
    dim: int = -1
    split_dim: int = -1
    parts: int = 1
    sub_axes: Tuple[str, ...] = ()
    perm: Tuple[Tuple[int, int], ...] = ()
    bytes_wire: int = 0
    detail: str = ""


@dataclass(frozen=True)
class ReshardPlan:
    """A deterministic redistribution schedule for one array."""
    global_shape: Tuple[int, ...]
    dtype: str
    itemsize: int
    src: ShardingSpec
    dst: ShardingSpec
    refined_axes: Tuple[Tuple[str, int], ...]   # (name, size), src order
    src_refined: Tuple[Tuple[str, ...], ...]    # per-dim refined axis runs
    dst_refined: Tuple[Tuple[str, ...], ...]
    dst_device_map: Tuple[int, ...]  # dst-extended linear -> src linear
    replicas: int                    # src world / dst world (phantom lift)
    steps: Tuple[ReshardStep, ...]
    bytes_wire: int
    bytes_naive: int

    @property
    def world(self) -> int:
        return self.src.mesh.world

    @property
    def reduction_ratio(self) -> float:
        """bytes_naive / bytes_wire (inf for zero-wire plans)."""
        if self.bytes_wire == 0:
            return float("inf") if self.bytes_naive else 1.0
        return self.bytes_naive / self.bytes_wire


# ---------------------------------------------------------------------------
# mesh refinement

def _prefix_products(sizes: Sequence[int]) -> List[int]:
    out, p = [], 1
    for s in sizes:
        p *= s
        out.append(p)
    return out


def _refine(src_sizes: Sequence[int], dst_sizes: Sequence[int]
            ) -> List[int]:
    """Common mixed-radix refinement of two factorizations of the same
    world size, major end first. Unplannable when the merged factor
    boundaries don't nest (e.g. (2,3) vs (3,2))."""
    marks = sorted(set(_prefix_products(src_sizes))
                   | set(_prefix_products(dst_sizes)))
    factors, prev = [], 1
    for m in marks:
        if m % prev:
            raise Unplannable(
                f"mesh factorizations {tuple(src_sizes)} and "
                f"{tuple(dst_sizes)} have no common integer refinement")
        if m // prev > 1:
            factors.append(m // prev)
        prev = m
    return factors


def _axis_runs(sizes: Sequence[int], names: Sequence[str],
               refined: Sequence[int]) -> Dict[str, Tuple[int, ...]]:
    """original axis name -> indices of its contiguous refined-axis run."""
    runs: Dict[str, Tuple[int, ...]] = {}
    marks = _prefix_products(sizes)
    rmarks = _prefix_products(refined)
    prev = 1
    for name, mark in zip(names, marks):
        runs[name] = tuple(i for i, rm in enumerate(rmarks)
                           if prev < rm <= mark)
        prev = mark
    return runs


# ---------------------------------------------------------------------------
# planning

def _common_prefix(a: Sequence, b: Sequence) -> int:
    k = 0
    while k < len(a) and k < len(b) and a[k] == b[k]:
        k += 1
    return k


def plan_reshard(global_shape: Sequence[int], itemsize: int,
                 src: ShardingSpec, dst: ShardingSpec,
                 dst_device_map: Optional[Sequence[int]] = None,
                 dtype: str = "") -> ReshardPlan:
    """Compile the (src -> dst) redistribution schedule for one array.

    `dst_device_map[h]` is the src-linear index of the physical device at
    dst-extended-linear position h (identity when omitted — both meshes
    enumerate the same devices in the same flat order). Raises Unplannable
    when no portable decomposition exists; callers take the counted
    gather-and-slice path (or read files).
    """
    shape = tuple(int(n) for n in global_shape)
    itemsize = int(itemsize)
    src.check_divisible(shape)
    dst.check_divisible(shape)
    W, Wd = src.mesh.world, dst.mesh.world
    if Wd > W:
        raise Unplannable(
            f"dst mesh has {Wd} devices but src has {W}: growing moves "
            "need data to originate off-mesh — gather and slice")
    if W % Wd:
        raise Unplannable(
            f"src world {W} is not a multiple of dst world {Wd}")
    replicas = W // Wd

    # lift a smaller dst mesh with a leading phantom replica axis so both
    # factorizations cover the same linear device space
    dst_mesh_ext = dst.mesh if replicas == 1 else MeshSpec(
        ((PHANTOM_AXIS, replicas),) + dst.mesh.axes)

    if dst_device_map is None:
        dmap = tuple(range(W))
    else:
        dmap = tuple(int(i) for i in dst_device_map)
        if sorted(dmap) != list(range(W)):
            raise Unplannable(
                "dst_device_map must be a bijection over the source "
                f"devices (got {len(dmap)} entries over world {W})")

    # drop size-1 axes (they chunk nothing) before refining
    src_ax = [(n, s) for n, s in src.mesh.axes if s > 1]
    dst_ax = [(n, s) for n, s in dst_mesh_ext.axes if s > 1]
    refined_sizes = _refine([s for _, s in src_ax], [s for _, s in dst_ax])
    refined_names = tuple(f"r{i}" for i in range(len(refined_sizes)))
    refined_axes = tuple(zip(refined_names, refined_sizes))
    src_runs = _axis_runs([s for _, s in src_ax], [n for n, _ in src_ax],
                          refined_sizes)
    dst_runs = _axis_runs([s for _, s in dst_ax], [n for n, _ in dst_ax],
                          refined_sizes)

    def rewrite(entries, runs):
        out = []
        for ent in entries:
            axes: List[str] = []
            for a in ent:
                axes.extend(refined_names[i] for i in runs.get(a, ()))
            out.append(tuple(axes))
        return out

    cur = [list(e) for e in rewrite(src.spec, src_runs)]
    tgt = [list(e) for e in rewrite(dst.spec, dst_runs)]
    src_refined = tuple(tuple(e) for e in cur)
    dst_refined = tuple(tuple(e) for e in tgt)

    size_of = dict(refined_axes)
    full_elems = math.prod(shape) if shape else 1
    ndim = len(shape)

    def local_elems() -> int:
        c = math.prod(size_of[a] for e in cur for a in e) or 1
        return full_elems // c

    used = lambda: {a for e in cur for a in e}
    steps: List[ReshardStep] = []

    for _ in range(4 * (len(refined_sizes) + 1) * (ndim + 1) + 4):
        # 1. free slices: append next dst axes that are not held anywhere
        progressed = False
        for d in range(ndim):
            while (len(cur[d]) < len(tgt[d])
                   and cur[d] == tgt[d][:len(cur[d])]
                   and tgt[d][len(cur[d])] not in used()):
                u = tgt[d][len(cur[d])]
                n = size_of[u]
                steps.append(ReshardStep(
                    op="dynamic_slice", axes=(u,), dim=d, parts=n,
                    detail=f"slice dim {d} into {n} chunks over {u}"))
                cur[d].append(u)
                progressed = True
        if cur == tgt:
            break

        # 2. reindex-in-place: tgt[d] = keep + A + T with T = cur extras
        for d in range(ndim):
            keep = _common_prefix(cur[d], tgt[d])
            T = cur[d][keep:]
            if not T or len(tgt[d]) < keep + len(T):
                continue
            if tgt[d][len(tgt[d]) - len(T):] != T:
                continue
            A = tgt[d][keep:len(tgt[d]) - len(T)]
            if not A or any(a in used() for a in A):
                continue
            nA = math.prod(size_of[a] for a in A)
            nT = math.prod(size_of[a] for a in T)
            pairs = tuple(((f % nA) * nT + f // nA, f)
                          for f in range(nA * nT))
            moved = sum(1 for s, r in pairs if s != r)
            new_local = local_elems() // nA
            steps.append(ReshardStep(
                op="reindex", axes=tuple(A) + tuple(T), dim=d,
                parts=nA, sub_axes=tuple(A), perm=pairs,
                bytes_wire=(W // (nA * nT)) * moved * new_local * itemsize,
                detail=f"re-chunk dim {d}: split {nA}-way by own "
                       f"({'+'.join(A)}) coord + ppermute over "
                       f"({'+'.join(tuple(A) + tuple(T))})"))
            cur[d] = tgt[d][:keep + len(A) + len(T)]
            progressed = True
            break
        if progressed:
            continue

        # 3. all_to_all: one extra axis on dim d that some dim e wants next
        for d in range(ndim):
            keep = _common_prefix(cur[d], tgt[d])
            if len(cur[d]) != keep + 1:
                continue
            u = cur[d][-1]
            for e in range(ndim):
                if e == d or len(tgt[e]) <= len(cur[e]):
                    continue
                if (cur[e] == tgt[e][:len(cur[e])]
                        and tgt[e][len(cur[e])] == u):
                    n = size_of[u]
                    steps.append(ReshardStep(
                        op="all_to_all", axes=(u,), dim=d, split_dim=e,
                        parts=n,
                        bytes_wire=W * (n - 1) * (local_elems() // n)
                        * itemsize,
                        detail=f"all_to_all over {u}: gather dim {d}, "
                               f"split dim {e} ({n} parts)"))
                    cur[d].pop()
                    cur[e].append(u)
                    progressed = True
                    break
            if progressed:
                break
        if progressed:
            continue

        # 4. gather the innermost extra axis of the first mismatched dim
        for d in range(ndim):
            keep = _common_prefix(cur[d], tgt[d])
            if len(cur[d]) > keep:
                u = cur[d][-1]
                n = size_of[u]
                steps.append(ReshardStep(
                    op="all_gather", axes=(u,), dim=d, parts=n,
                    bytes_wire=W * (n - 1) * local_elems() * itemsize,
                    detail=f"all_gather dim {d} over {u} ({n} chunks)"))
                cur[d].pop()
                progressed = True
                break
        if not progressed:
            raise Unplannable(
                f"planner stuck at {cur} -> {tgt} "
                "(internal invariant violation)")
    else:
        raise Unplannable("planner exceeded its step budget "
                          f"({cur} -> {tgt})")

    # 5. device-order fixup: rebind shards onto the dst enumeration
    if dmap != tuple(range(W)):
        loc = local_elems()
        moved = sum(1 for h in range(W) if dmap[h] != h)
        steps.append(ReshardStep(
            op="ppermute", axes=refined_names, parts=W,
            perm=tuple((h, dmap[h]) for h in range(W)),
            bytes_wire=moved * loc * itemsize,
            detail=f"device-order ppermute ({moved}/{W} shards move)"))

    src_chunks = math.prod(src.chunk_counts()) or 1
    full_bytes = full_elems * itemsize
    bytes_naive = W * full_bytes - W * (full_bytes // src_chunks)
    return ReshardPlan(
        global_shape=shape, dtype=str(dtype), itemsize=itemsize,
        src=src, dst=dst, refined_axes=refined_axes,
        src_refined=src_refined, dst_refined=dst_refined,
        dst_device_map=dmap, replicas=replicas, steps=tuple(steps),
        bytes_wire=sum(s.bytes_wire for s in steps),
        bytes_naive=bytes_naive)


# ---------------------------------------------------------------------------
# coverage table + rendering

def plan_sends(plan: ReshardPlan) -> Tuple[Tuple[int, int, Tuple[Tuple[int,
               int], ...]], ...]:
    """(src_device, dst_device, global interval) cover of every dst shard.

    src/dst devices are linear indices into their OWN meshes. Each dst
    shard is partitioned among the canonical holders of the overlapping
    source shards (replica groups collapse to their lowest-index member),
    so the table is disjoint and covers each dst shard exactly once —
    the properties the plan tests assert.
    """
    src_map = shard_index_map(plan.global_shape, plan.src)
    dst_map = shard_index_map(plan.global_shape, plan.dst)
    canon: Dict[Tuple, int] = {}
    for i, idx in enumerate(src_map):
        canon.setdefault(idx, i)
    sends = []
    for j, dj in enumerate(dst_map):
        for idx, i in sorted(canon.items(), key=lambda kv: kv[1]):
            inter = tuple((max(a, c), min(b, d))
                          for (a, b), (c, d) in zip(dj, idx))
            if all(a < b for a, b in inter) or not inter:
                sends.append((i, j, inter))
    return tuple(sends)


def describe(plan: ReshardPlan) -> str:
    """Human-readable schedule."""
    lines = []
    shape = "x".join(str(n) for n in plan.global_shape) or "scalar"
    lines.append(f"reshard: {shape} ({plan.dtype or 'bytes'} "
                 f"itemsize={plan.itemsize})")
    mesh = lambda s: " x ".join(f"{n}={v}" for n, v in s.mesh.axes)
    ent = lambda e: "+".join(e) if e else "-"
    lines.append(f"  src: mesh [{mesh(plan.src)}]  "
                 f"spec ({', '.join(ent(e) for e in plan.src.spec)})")
    lines.append(f"  dst: mesh [{mesh(plan.dst)}]  "
                 f"spec ({', '.join(ent(e) for e in plan.dst.spec)})")
    lines.append(f"  refined device factorization: "
                 f"{' x '.join(f'{n}={s}' for n, s in plan.refined_axes) or '1'}"
                 + (f"  (+{plan.replicas}x replica lift)"
                    if plan.replicas > 1 else ""))
    if not plan.steps:
        lines.append("  steps: none (layouts already agree)")
    else:
        lines.append(f"  steps ({len(plan.steps)}):")
        for i, s in enumerate(plan.steps):
            lines.append(f"    {i}: {s.op:<13} {s.detail}  "
                         f"[{s.bytes_wire / 2**20:.3f} MiB wire]")
    lines.append(f"  total wire: {plan.bytes_wire / 2**20:.3f} MiB  "
                 f"naive replicate+slice: {plan.bytes_naive / 2**20:.3f} "
                 f"MiB  reduction: {plan.reduction_ratio:.2f}x")
    return "\n".join(lines)


def plan_as_dict(plan: ReshardPlan) -> dict:
    """JSON form (the JAX package's ``plan_as_dict``, key for key)."""
    return {
        "global_shape": list(plan.global_shape),
        "dtype": plan.dtype,
        "itemsize": plan.itemsize,
        "src": {"mesh": {n: s for n, s in plan.src.mesh.axes},
                "spec": [list(e) if e else None for e in plan.src.spec]},
        "dst": {"mesh": {n: s for n, s in plan.dst.mesh.axes},
                "spec": [list(e) if e else None for e in plan.dst.spec]},
        "refined_axes": [[n, s] for n, s in plan.refined_axes],
        "replicas": plan.replicas,
        "steps": [
            {"op": s.op, "axes": list(s.axes), "dim": s.dim,
             "split_dim": s.split_dim, "parts": s.parts,
             "bytes_wire": s.bytes_wire, "detail": s.detail}
            for s in plan.steps
        ],
        "bytes_wire": plan.bytes_wire,
        "bytes_naive": plan.bytes_naive,
        "reduction_ratio": (round(plan.reduction_ratio, 4)
                            if math.isfinite(plan.reduction_ratio)
                            else plan.reduction_ratio),
    }
