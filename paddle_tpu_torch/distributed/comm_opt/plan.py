"""Reduction planning: bucketing and per-stage byte accounting
(``paddle_tpu/distributed/comm_opt/plan.py`` analog; pure Python, the same
layout bit for bit).

``reduce.GradReducer`` lays out its flat buckets from this plan, and the
bucket layout is the error-feedback residuals' layout in a checkpoint, so
it must be the JAX package's exactly.

All byte counts are PER RANK PER REDUCTION, on the receive side. The fp32
baseline uses the same stage structure at 4 B/value, so
`compression_ratio` is exactly the wire-format ratio (~3.88x for int8
block 128, 2x for bf16).

On hybrid meshes the reduction runs independently inside each model
shard's data-axis group (compress within the dp group, leave mp traffic
untouched). The caller then passes the LOCAL (model-shard) leaf shapes
plus ``groups`` = the number of concurrent groups; per-rank numbers keep
their meaning and the group/global aggregates come from the
``bytes_*_group/global`` properties.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

from .config import GradReduceConfig

__all__ = ["LeafSlot", "Bucket", "Stage", "ReducePlan", "build_plan"]


@dataclass(frozen=True)
class LeafSlot:
    """One gradient leaf's position inside its bucket's flat vector."""
    name: str
    shape: Tuple[int, ...]
    size: int
    offset: int


@dataclass(frozen=True)
class Bucket:
    index: int
    leaves: Tuple[LeafSlot, ...]
    length: int         # packed length (leaf sizes + alignment gaps)
    padded_length: int  # rounded up to world * granule


@dataclass(frozen=True)
class Stage:
    """One collective stage, aggregated over all buckets."""
    phase: str                           # "reduce_scatter" | "all_gather"
    axis: Union[str, Tuple[str, ...]]    # mesh axis (tuple when flat)
    size: int                            # devices in the stage's group
    elems: int                           # values received per device
    bytes_raw: int                       # at 4 B/value (fp32 baseline)
    bytes_wire: int                      # at the configured wire format


@dataclass(frozen=True)
class ReducePlan:
    config: GradReduceConfig
    axes: Tuple[Tuple[str, int], ...]    # reduction axes (name, size)
    world: int                           # prod of axis sizes
    granule: int                         # per-shard alignment unit
    buckets: Tuple[Bucket, ...]
    stages: Tuple[Stage, ...]
    bytes_raw_per_step: int
    bytes_wire_per_step: int
    compression_ratio: float
    #: independent reduction groups running this schedule concurrently
    #: (one per model shard on hybrid meshes); 1 on pure-data meshes
    groups: int = 1
    #: the model axes that slice the mesh into groups, (name, size)
    group_axes: Tuple[Tuple[str, int], ...] = ()

    @property
    def total_elements(self) -> int:
        return sum(b.length for b in self.buckets)

    @property
    def padded_elements(self) -> int:
        return sum(b.padded_length for b in self.buckets)

    @property
    def bytes_wire_group_per_step(self) -> int:
        """Wire bytes summed over ONE group's devices per reduction."""
        return self.bytes_wire_per_step * self.world

    @property
    def bytes_raw_group_per_step(self) -> int:
        return self.bytes_raw_per_step * self.world

    @property
    def bytes_wire_global_per_step(self) -> int:
        """Wire bytes summed over every device on the mesh (all groups)."""
        return self.bytes_wire_group_per_step * self.groups

    @property
    def bytes_raw_global_per_step(self) -> int:
        return self.bytes_raw_group_per_step * self.groups


def _build_buckets(leaves, world: int, granule: int, bucket_bytes: int,
                   leaf_align: int = 1) -> Tuple[Bucket, ...]:
    """Name-sorted greedy packing: deterministic across processes (every
    rank must flatten identically) and insensitive to dict order.

    ``leaf_align`` > 1 starts every leaf on that boundary (zero-filled
    gaps). Hybrid quantized plans NEED block-aligned leaves: each model
    shard's group quantizes its own bucket, and a scale block spanning a
    group-REPLICATED leaf and a group-local (model-sharded) one would get
    group-dependent scales — the "replicated" reduced grad then differs
    per group and the replicas silently drift apart over steps.
    """
    align = max(world, 1) * max(granule, 1)
    la = max(int(leaf_align), 1)
    items = sorted((str(n), tuple(int(d) for d in shape))
                   for n, shape in leaves)
    buckets: List[Bucket] = []
    cur: List[LeafSlot] = []
    cur_len = 0

    def flush():
        nonlocal cur, cur_len
        if not cur:
            return
        padded = -(-cur_len // align) * align
        buckets.append(Bucket(len(buckets), tuple(cur), cur_len, padded))
        cur, cur_len = [], 0

    for name, shape in items:
        size = int(math.prod(shape)) if shape else 1
        offset = -(-cur_len // la) * la
        if cur and (offset + size) * 4 > bucket_bytes:
            flush()
            offset = 0
        cur.append(LeafSlot(name, shape, size, offset))
        cur_len = offset + size
    flush()
    return tuple(buckets)


def _stage_volumes(padded_lengths: Sequence[int],
                   axes: Sequence[Tuple[str, int]], hierarchical: bool):
    """[(phase, axis, size, elems-received-per-device)] over all buckets.

    Reduce-scatter over axis of size n on a length-L vector moves
    (n-1)/n * L values per device; the reverse all-gather the same. The
    hierarchical schedule reduce-scatters axis by axis (each stage on the
    previous stage's shard) then gathers back in reverse; the flat
    schedule is one stage over the combined axis tuple.
    """
    sizes = [n for _, n in axes]
    if not hierarchical and len(axes) > 1:
        axes = [(tuple(a for a, _ in axes), math.prod(sizes))]
        sizes = [axes[0][1]]
    out = []
    # phase 1: reduce-scatter, axis by axis
    shard = list(padded_lengths)
    rs = []
    for (axis, n) in axes:
        elems = sum((n - 1) * (L // n) for L in shard)
        rs.append((axis, n, elems))
        shard = [L // n for L in shard]
    out.extend(("reduce_scatter", axis, n, e) for axis, n, e in rs)
    # phase 2: all-gather, reverse order (shard grows back)
    for (axis, n) in reversed(list(axes)):
        elems = sum((n - 1) * L for L in shard)
        out.append(("all_gather", axis, n, elems))
        shard = [L * n for L in shard]
    return out


def build_plan(leaves, mesh_axes: Dict[str, int],
               config: GradReduceConfig,
               group_axes: Dict[str, int] = None) -> ReducePlan:
    """leaves: {name: shape} or [(name, shape)]; mesh_axes: {axis: size}
    restricted by the caller to the data axes the reduction runs over.
    group_axes: {axis: size} of the model axes slicing the mesh into
    independent reduction groups (hybrid meshes) — leaves must then be
    the LOCAL per-model-shard shapes."""
    if isinstance(leaves, dict):
        leaves = list(leaves.items())
    order = config.resolved_axis_order(tuple(mesh_axes))
    axes = tuple((a, int(mesh_axes[a])) for a in order
                 if int(mesh_axes.get(a, 1)) > 1)
    world = math.prod(n for _, n in axes) if axes else 1
    granule = config.block_size if config.quantized and config.dtype == "int8" else 1
    gaxes = tuple((a, int(n)) for a, n in (group_axes or {}).items()
                  if int(n) > 1)
    # hybrid + block-scaled: leaves must own whole scale blocks (see
    # _build_buckets) so group-replicated leaves quantize identically
    # in every group
    buckets = _build_buckets(leaves, world, granule, config.bucket_bytes,
                             leaf_align=granule if gaxes else 1)

    wire_cost = config.wire_bytes_per_value
    stages = tuple(
        Stage(phase, axis, n, elems, bytes_raw=elems * 4,
              bytes_wire=int(math.ceil(elems * wire_cost)))
        for phase, axis, n, elems in _stage_volumes(
            [b.padded_length for b in buckets], axes, config.hierarchical)
    )
    raw = sum(s.bytes_raw for s in stages)
    wire = sum(s.bytes_wire for s in stages)
    return ReducePlan(
        config=config, axes=axes, world=world, granule=granule,
        buckets=buckets, stages=stages,
        bytes_raw_per_step=raw, bytes_wire_per_step=wire,
        compression_ratio=4.0 / wire_cost,
        groups=math.prod(n for _, n in gaxes) if gaxes else 1,
        group_axes=gaxes,
    )


def describe(plan: ReducePlan) -> str:
    """Human-readable plan, as the JAX package prints it."""
    cfg = plan.config
    lines = []
    lines.append(f"grad_reduce: mode={cfg.mode} dtype={cfg.dtype} "
                 f"block={cfg.block_size} ef={cfg.error_feedback} "
                 f"hierarchical={cfg.hierarchical} overlap={cfg.overlap}")
    ax = " x ".join(f"{a}={n}" for a, n in plan.axes) or "(single device)"
    lines.append(f"reduction axes: {ax}  (world={plan.world})")
    if plan.groups > 1:
        gx = " x ".join(f"{a}={n}" for a, n in plan.group_axes)
        lines.append(f"hybrid groups: {plan.groups} independent "
                     f"{plan.world}-device groups (model axes {gx}); "
                     "leaf shapes below are per-model-shard LOCAL shapes")
    lines.append(f"buckets: {len(plan.buckets)} "
                 f"(<= {cfg.bucket_bytes / 2**20:.1f} MiB raw each, "
                 f"align {plan.world}*{plan.granule})")
    for b in plan.buckets:
        pad = b.padded_length - b.length
        lines.append(f"  bucket {b.index}: {len(b.leaves)} leaves, "
                     f"{b.length} elems (+{pad} pad) = "
                     f"{b.padded_length * 4 / 2**20:.2f} MiB raw")
    if plan.stages:
        lines.append("stages (per device, per reduction):")
        for s in plan.stages:
            axis = "+".join(s.axis) if isinstance(s.axis, tuple) else s.axis
            lines.append(
                f"  {s.phase:<14} over {axis:<12} n={s.size}  "
                f"{s.bytes_raw / 2**20:8.2f} MiB raw -> "
                f"{s.bytes_wire / 2**20:8.2f} MiB wire")
        lines.append(
            f"total: {plan.bytes_raw_per_step / 2**20:.2f} MiB raw -> "
            f"{plan.bytes_wire_per_step / 2**20:.2f} MiB wire  "
            f"(compression {plan.compression_ratio:.2f}x)")
        if plan.groups > 1:
            lines.append(
                f"group-local wire: "
                f"{plan.bytes_wire_group_per_step / 2**20:.2f} MiB "
                f"({plan.world} devices/group); global wire: "
                f"{plan.bytes_wire_global_per_step / 2**20:.2f} MiB "
                f"over {plan.groups} groups")
    else:
        lines.append("no collective stages (world=1); format compression "
                     f"{plan.compression_ratio:.2f}x")
    return "\n".join(lines)


def plan_as_dict(plan: ReducePlan) -> dict:
    """JSON-friendly form, the JAX package's keys."""
    return {
        "config": {
            "mode": plan.config.mode, "dtype": plan.config.dtype,
            "block_size": plan.config.block_size,
            "error_feedback": plan.config.error_feedback,
            "hierarchical": plan.config.hierarchical,
            "overlap": plan.config.overlap,
            "bucket_bytes": plan.config.bucket_bytes,
        },
        "axes": [[a, n] for a, n in plan.axes],
        "world": plan.world,
        "buckets": [
            {"index": b.index, "leaves": len(b.leaves), "length": b.length,
             "padded_length": b.padded_length}
            for b in plan.buckets
        ],
        "stages": [
            {"phase": s.phase,
             "axis": list(s.axis) if isinstance(s.axis, tuple) else s.axis,
             "size": s.size, "elems": s.elems, "bytes_raw": s.bytes_raw,
             "bytes_wire": s.bytes_wire}
            for s in plan.stages
        ],
        "bytes_raw_per_step": plan.bytes_raw_per_step,
        "bytes_wire_per_step": plan.bytes_wire_per_step,
        "compression_ratio": round(plan.compression_ratio, 4),
        "groups": plan.groups,
        "group_axes": [[a, n] for a, n in plan.group_axes],
        "bytes_wire_group_per_step": plan.bytes_wire_group_per_step,
        "bytes_wire_global_per_step": plan.bytes_wire_global_per_step,
    }
