"""Compressed MoE token dispatch: block-scaled int8 exchanges
(``paddle_tpu/incubate/distributed/models/moe/dispatch.py`` analog).

The ``moe_dispatch="quant"`` path: the routing of ``moe_route`` (gate
logits, capacity, positions and the aux loss stay full precision, so the
routing is the dense path's bit for bit), with the two exchanges over
``ep`` in ``kernels/quant.py``'s wire format: an int8 payload and one fp32
scale per ``block`` trailing elements, ``1 + 4/block`` bytes a value.

Forward exchanges:
  dispatch: each rank gathers its own tokens into a partial ``[E, C, d]``
    fp32 stack (zeros in every other rank's slots), splits ``E`` into
    ``[ep, E/ep]`` and all-to-alls the int8 payload over ``ep``; the sum
    of the received partials is this rank's ``[E/ep, C, d]`` (a
    compressed reduce-scatter), then summed in fp32 over the replicas
    along the other data axes (dp, sharding), as the JAX package sums
    them under GSPMD;
  combine: each rank quantizes its experts' outputs and all-gathers them
    over ``ep``; the combine then runs on its own tokens.

Backward is the transposed exchange, also compressed: the all-to-all of
blocks is its own transpose, and the all-gather's is the compressed
reduce-scatter above. The rounding uses the straight-through estimator:
cotangents pass through the wire format but not the quantizer's
derivative (zero almost everywhere).

The JAX package also records the ``comm.*``/``moe.dispatch.*`` metrics
(ROADMAP queue A item A6 here) and, inside a region manual over some mesh
axes only (a pipeline stage), falls back to dense routing and records a
``moe-dispatch-downgrade`` finding; the port has no such regions until
pipeline parallelism (A5.6) brings them, which adds its case to
``plan_quant_dispatch``'s downgrades.
"""

from __future__ import annotations

import warnings
from dataclasses import KW_ONLY, dataclass
from typing import Optional, Tuple

import torch

from .....distributed.collective import axis_group
from .....distributed.communication import (all_to_all_blocks,
                                            gather_along, sum_over)
from .....distributed.sharding_utils import EP_AXIS
from .....kernels.quant import (dequantize_block_scaled, fit_block_size,
                                quantize_block_scaled)

#: Below this block size the f32 scale sidecar eats the compression
#: (wire = 1 + 4/block bytes per value; block 8 is the 1.5x break-even
#: territory) — plan_quant_dispatch downgrades instead.
MIN_BLOCK = 8


# ---------------------------------------------------------------------------
# quantized exchange primitives (both directions compressed)
# ---------------------------------------------------------------------------

def _quant_a2a(x, group, block_size: int):
    """dequant(all_to_all(quant(x))) over dim 0; ``x [n, ..., C]`` with n
    the group's size, C a block multiple. Returns fp32, source-major."""
    q, s = quantize_block_scaled(x, block_size)
    return dequantize_block_scaled(all_to_all_blocks(q, group),
                                   all_to_all_blocks(s, group), block_size)


def _quant_ag(x, group, block_size: int):
    q, s = quantize_block_scaled(x, block_size)
    return dequantize_block_scaled(gather_along(q, group, 0),
                                   gather_along(s, group, 0), block_size)


class _QuantAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, block_size):
        ctx.args = (group, block_size)
        return _quant_a2a(x, group, block_size)

    @staticmethod
    def backward(ctx, ct):
        # the (split 0, concat 0) all-to-all is its own transpose;
        # straight through the quantizer, compressed as the forward
        return _quant_a2a(ct.contiguous(), *ctx.args), None, None


class _QuantAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, block_size):
        ctx.args = (group, block_size)
        return _quant_ag(x.contiguous(), group, block_size)

    @staticmethod
    def backward(ctx, ct):
        # the transpose of a tiled all-gather is a reduce-scatter: the
        # compressed all-to-all and a sum over the sources
        group, block_size = ctx.args
        n = group.nranks
        cr = ct.contiguous().reshape((n, ct.shape[0] // n)
                                     + tuple(ct.shape[1:]))
        return _quant_a2a(cr, group, block_size).sum(dim=0), None, None


def quant_all_to_all(x, axis_name, block_size: int):
    """Compressed all-to-all over the group along ``axis_name`` (a mesh
    axis of the hybrid topology, or a ``Group``): int8 payload and fp32
    scales on the wire, fp32 out; dim 0 of ``x`` has the group's size."""
    g = axis_group(axis_name)
    if g.nranks == 1:
        return dequantize_block_scaled(
            *quantize_block_scaled(x, block_size), block_size)
    return _QuantAllToAll.apply(x, g, block_size)


def quant_all_gather(x, axis_name, block_size: int):
    """Compressed tiled all-gather over dim 0: local ``[m, ..., C]`` ->
    fp32 ``[n*m, ..., C]``. Its transpose is the compressed
    reduce-scatter."""
    g = axis_group(axis_name)
    if g.nranks == 1:
        return dequantize_block_scaled(
            *quantize_block_scaled(x, block_size), block_size)
    return _QuantAllGather.apply(x, g, block_size)


# ---------------------------------------------------------------------------
# plan: the exchange's groups and its static wire accounting
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DispatchPlan:
    """Resolved quant-dispatch schedule for one MoE layer call."""
    mesh: object                  # the hybrid topology's mesh, if any
    # each rank holds its own rows and runs the exchange directly, as the
    # JAX package does in a fully manual region
    manual_direct: bool
    axis_names: Tuple[str, ...]   # the data axes
    data_axes: Tuple[str, ...]    # batch-carrying axes, DATA_AXES order
    nep: int
    block: int
    # per-rank RECEIVE-side bytes of the two forward exchanges (payload +
    # scale sidecar) and what the same exchanges move at fp32 (the
    # JAX package's rules.wire_bytes convention)
    bytes_wire: int
    bytes_raw: int
    #: the port's own (keyword-only): the groups the exchanges run over,
    #: and the stack's expert count and capacity
    _: KW_ONLY
    groups: object = None
    num_experts: int = 0
    capacity: int = 0

    @property
    def other_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.data_axes if a != EP_AXIS)

    @property
    def bytes_wire_train_step(self) -> int:
        """Forward and transposed backward exchanges of one train-step MoE
        call: the backward mirrors the forward byte for byte (the
        all-gather's transpose is the compressed reduce-scatter of the
        same buffer), so a step moves twice the forward wire."""
        return 2 * self.bytes_wire

    @property
    def compression_ratio(self) -> float:
        return self.bytes_raw / self.bytes_wire if self.bytes_wire else 0.0


def _downgrade(site: str, message: str):
    warnings.warn("moe_dispatch='quant' falling back to dense routing: "
                  + message, stacklevel=4)
    return None


def plan_quant_dispatch(T: int, E: int, capacity: int, d: int,
                        block: int = 128, site: str = "moe.moe_route", *,
                        groups=None) -> Optional[DispatchPlan]:
    """The exchange plan over ``groups`` (a ``topology.MoEGroups``), or
    None meaning "route dense".

    None is silent when there is nothing to compress (no groups, or an
    ``ep`` group of one rank: no exchange exists). It is a downgrade, with
    a warning, when an exchange exists but cannot run compressed: experts
    indivisible by the ep degree, or a model dim whose best block (gcd
    with ``block``) is below ``MIN_BLOCK``. ``T`` is this rank's token
    count (each rank holds its own rows, so it need not divide the data
    world)."""
    nep = groups.ep.nranks if groups is not None else 1
    if nep <= 1:
        return None  # no exchange to compress; dense is exact, not a downgrade
    if E % nep:
        return _downgrade(site, f"{E} experts do not divide the ep degree "
                          f"{nep}")
    blk = fit_block_size(d, block)
    if blk < MIN_BLOCK:
        return _downgrade(site, f"model dim {d} admits no quantization "
                          f"block >= {MIN_BLOCK} under block {block}")
    e_loc = E // nep

    # receive-side accounting: the dispatch all-to-all moves the
    # [nep, E_loc, C, d] partial ((nep-1)/nep of it arrives from peers),
    # the combine all-gather receives every peer's local [E_loc, C, d]
    def _recv_a2a(nbytes: int) -> int:
        return (nep - 1) * nbytes // nep

    disp_payload = E * capacity * d                 # int8: 1 byte/value
    disp_scales = 4 * E * capacity * (d // blk)     # f32 sidecar
    wire = (_recv_a2a(disp_payload) + _recv_a2a(disp_scales)
            + (nep - 1) * e_loc * capacity * (d + 4 * (d // blk)))
    raw = _recv_a2a(4 * disp_payload) + (nep - 1) * 4 * e_loc * capacity * d
    from .....distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return DispatchPlan(
        mesh=hcg.get_mesh() if hcg is not None else None, manual_direct=True,
        axis_names=tuple(groups.data_axes), data_axes=tuple(groups.data_axes),
        nep=nep, block=blk, bytes_wire=wire, bytes_raw=raw, groups=groups,
        num_experts=int(E), capacity=int(capacity))


# ---------------------------------------------------------------------------
# the routed exchanges
# ---------------------------------------------------------------------------

def quant_dispatch(plan: DispatchPlan, dv, xv):
    """This rank's tokens ``xv [T, d]`` routed by ``dv`` (the index form
    ``(slots, choice)`` of ``moe_layer._slot_choices``) -> this ep rank's
    expert inputs ``[E/ep, C, d]`` in ``xv``'s dtype."""
    from .moe_layer import _Dispatch

    slots, choice = dv
    E, C, n = plan.num_experts, plan.capacity, plan.nep
    part = _Dispatch.apply(xv.float(), slots, choice)  # [E * C, d] fp32
    p4 = part.view(n, E // n, C, xv.shape[-1])
    ein = quant_all_to_all(p4, plan.groups.ep, plan.block).sum(dim=0)
    return sum_over(ein, plan.groups.replica).to(xv.dtype)


def quant_combine(plan: DispatchPlan, cv, ev):
    """Combine weights in index form ``(weights, slots, choice)`` and this
    ep rank's expert outputs ``ev [E/ep, C, d]`` -> its tokens ``[T, d]``
    in ``ev``'s dtype."""
    from .moe_layer import _Combine

    weights, slots, choice = cv
    full = quant_all_gather(ev.float(), plan.groups.ep, plan.block)
    out = _Combine.apply(full.reshape(plan.num_experts * plan.capacity, -1),
                         weights, slots, choice)
    return out.to(ev.dtype)
