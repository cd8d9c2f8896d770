"""Collective communication (``paddle_tpu/distributed/communication.py``
analog) on ``torch.distributed``, on per-process tensors as Paddle defines
them.

The JAX package is single-controller: its "per-rank" tensor stacks every
rank's value on a leading axis (``to_per_rank``) and a collective
transforms the stack. Here each rank is a process holding its own tensor,
and a collective's result on rank r is slice r of the JAX package's result
on the same values: ``to_per_rank(values)`` returns this rank's entry, so a
script written against the JAX package computes the same thing on every
rank, and ``rank_slices(t)`` is ``[t]``.

``reduce`` and ``gather`` leave their result on every rank, as the JAX
package's do (a superset of paddle's, which guarantees it at ``dst``
only). ``ReduceOp.AVG`` is a SUM followed by a division by the group's
size (gloo has no AVG). Groups of one rank have no process group: their
collectives are the identity. Every call returns a ``Task``; with
``sync_op=False`` its ``wait()`` waits for the ``torch.distributed`` work.

The collectives the JAX package runs inside ``shard_map`` (``psum``,
``pmean``, ``pmax``, ``pmin``, ``axis_index``, ``all_gather_in_trace``,
``reduce_scatter_in_trace``) are differentiable calls here on this rank's
tensor over its group along a mesh axis (``fleet.meta_parallel.mp_ops``).
``all_to_all_in_trace`` (the token exchange of expert parallelism) is
one as well, whose backward is the inverse exchange; ``ppermute`` (ring
attention, ROADMAP queue A item A5.7) raises. ``gather_rows`` and
``sum_over`` are the all-gather and all-reduce of the MoE token exchange
(its reduce-scatter is ``reduce_scatter_in_trace``), each with its
transpose as its backward (a reduce-scatter, an all-reduce): the
cotangents of a gathered or replicated value differ from rank to rank
there, so each backward sums them.
``gather_blocks``, ``gather_along``, ``reduce_scatter_blocks`` and
``all_to_all_blocks`` are the block collectives of the mp, ZeRO and
gradient-reduction paths; on a gloo group, ops other than all-reduce and
broadcast on CUDA tensors go through pinned host memory (``staged_ops``
counts them), since gloo runs only those two on the card's tensors for
certain. ``p2p_exchange`` is the pipeline's point-to-point transfers of
one tick, posted together and then waited on (staged the same way on
gloo; ``p2p_counts`` counts them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .collective import Group, _resolve_group

class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Task:
    """A collective's handle (``ProcessGroup``'s task): ``wait()`` blocks
    until the ``torch.distributed`` work (if any) is done, then runs
    ``after``. ``tensor``, the one the collective writes, is the JAX
    package's argument; the work carries it here."""

    def __init__(self, tensor=None, *, work=None, after=None):
        self._work = work
        self._after = after

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._after is not None:
                self._after()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _pg(g: Group):
    return g.process_group


def _src(g: Group, rank: int) -> int:
    if rank not in g.ranks:
        raise ValueError(f"rank {rank} is not in {g}")
    return rank


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def to_per_rank(values, group=None, stop_gradient: bool = True):
    """This rank's entry of ``values`` (a list of per-rank values or an
    ``[N, ...]`` array): its value under the JAX package's stack."""
    g = _resolve_group(group)
    if len(values) != g.nranks:
        raise ValueError(f"per-rank values need {g.nranks} entries, got "
                         f"{len(values)}")
    return _as_tensor(values[max(g.rank, 0)]).clone()


def rank_slices(t):
    """The list-of-per-rank-tensors view: this rank holds its own only."""
    return [t]


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True) -> Task:
    """Reduce ``tensor`` over the group, in place on every rank."""
    g = _resolve_group(group)
    if _pg(g) is None:
        return Task()
    work = dist.all_reduce(tensor, op=_TORCH_OPS[op], group=_pg(g),
                           async_op=True)
    after = (lambda: tensor.div_(g.nranks)) if op == ReduceOp.AVG else None
    task = Task(tensor, work=work, after=after)
    if sync_op:
        task.wait()
    return task


def reduce(tensor: torch.Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group=None, sync_op: bool = True) -> Task:
    """The reduction, on every rank (the JAX package's superset of
    paddle's dst-only result)."""
    return all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def all_gather(tensor_list: list, tensor: torch.Tensor, group=None,
               sync_op: bool = True) -> Task:
    """Extend ``tensor_list`` with every rank's ``tensor``, in rank order."""
    g = _resolve_group(group)
    if _pg(g) is None:
        tensor_list.append(tensor.clone())
        return Task()
    out = [torch.empty_like(tensor) for _ in range(g.nranks)]
    dist.all_gather(out, tensor.contiguous(), group=_pg(g))
    tensor_list.extend(out)
    return Task()


def all_gather_object(object_list: list, obj, group=None) -> Task:
    g = _resolve_group(group)
    if _pg(g) is None:
        object_list.append(obj)
        return Task()
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=_pg(g))
    object_list.extend(out)
    return Task()


def broadcast_object_list(object_list, src: int = 0, group=None) -> Task:
    """Every rank's ``object_list`` becomes global rank ``src``'s (pickled:
    only for objects of this job)."""
    g = _resolve_group(group)
    if _pg(g) is not None:
        dist.broadcast_object_list(object_list, src=_src(g, src),
                                   group=_pg(g))
    return Task()


def scatter_object_list(out_object_list, in_object_list=None, src: int = 0,
                        group=None) -> Task:
    """Rank i's ``out_object_list`` is extended with entry i of rank
    ``src``'s ``in_object_list``."""
    g = _resolve_group(group)
    if _pg(g) is None:
        out_object_list.extend((in_object_list or [])[:1])
        return Task()
    got = [None]
    mine = in_object_list if dist.get_rank() == src else None
    dist.scatter_object_list(got, mine, src=_src(g, src), group=_pg(g))
    out_object_list.extend(got)
    return Task()


def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              sync_op: bool = True) -> Task:
    """Every rank's ``tensor`` becomes global rank ``src``'s."""
    g = _resolve_group(group)
    if _pg(g) is None:
        return Task()
    task = Task(tensor, work=dist.broadcast(
        tensor, src=_src(g, src), group=_pg(g), async_op=True))
    if sync_op:
        task.wait()
    return task


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group=None, sync_op: bool = True) -> Task:
    """Rank i's ``tensor`` becomes ``tensor_list[i]`` of rank ``src``."""
    g = _resolve_group(group)
    if _pg(g) is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return Task()
    mine = tensor_list if dist.get_rank() == src else None
    dist.scatter(tensor, [t.contiguous() for t in mine] if mine else None,
                 src=_src(g, src), group=_pg(g))
    return Task()


def gather(tensor, gather_list=None, dst: int = 0, group=None,
           sync_op: bool = True) -> Task:
    """Every rank's ``tensor`` collected into ``gather_list`` on every rank
    (the JAX package's superset of paddle's dst-only result)."""
    return all_gather([] if gather_list is None else gather_list, tensor,
                      group=group, sync_op=sync_op)


def alltoall(in_tensor_list, out_tensor_list, group=None,
             sync_op: bool = True) -> Task:
    """Rank i's j-th tensor goes to rank j's i-th slot: ``out_tensor_list``
    is extended with the tensors this rank receives, in rank order."""
    g = _resolve_group(group)
    ins = [t.contiguous() for t in in_tensor_list]
    if len(ins) != g.nranks:
        raise ValueError(f"alltoall needs {g.nranks} tensors, got {len(ins)}")
    if _pg(g) is None:
        out_tensor_list.extend(t.clone() for t in ins)
        return Task()
    out = [torch.empty_like(t) for t in ins]
    dist.all_to_all(out, ins, group=_pg(g))
    out_tensor_list.extend(out)
    return Task()


def all_to_all(in_tensor_list, out_tensor_list, group=None,
               sync_op: bool = True) -> Task:
    return alltoall(in_tensor_list, out_tensor_list, group=group,
                    sync_op=sync_op)


def alltoall_single(in_tensor, out_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None,
                    sync_op: bool = True) -> Task:
    """Single-tensor all-to-all: dim 0 is cut into the group's size of
    chunks (or ``in_split_sizes``), chunk j going to rank j, and
    ``out_tensor`` holds what each rank sent this one, in rank order."""
    g = _resolve_group(group)
    if _pg(g) is None:
        out_tensor.copy_(in_tensor)
        return Task()
    if in_split_sizes is None and in_tensor.shape[0] % g.nranks:
        raise ValueError(f"alltoall_single needs rows ({in_tensor.shape[0]})"
                         f" divisible by nranks ({g.nranks})")
    if _through_host(_pg(g), in_tensor, "all_to_all_single"):
        host = torch.empty(out_tensor.shape, dtype=out_tensor.dtype,
                           pin_memory=True)
        dist.all_to_all_single(host, _pinned(in_tensor.contiguous()),
                               output_split_sizes=out_split_sizes,
                               input_split_sizes=in_split_sizes,
                               group=_pg(g))
        out_tensor.copy_(host)
        return Task()
    task = Task(out_tensor, work=dist.all_to_all_single(
        out_tensor, in_tensor.contiguous(), output_split_sizes=out_split_sizes,
        input_split_sizes=in_split_sizes, group=_pg(g), async_op=True))
    if sync_op:
        task.wait()
    return task


def reduce_scatter(tensor: torch.Tensor, tensor_list, op: str = ReduceOp.SUM,
                   group=None, sync_op: bool = True) -> Task:
    """Rank i's ``tensor`` becomes the reduction over ranks of each rank's
    ``tensor_list[i]``."""
    g = _resolve_group(group)
    ins = [t.contiguous() for t in tensor_list]
    if _pg(g) is None:
        tensor.copy_(ins[0])
        return Task()
    dist.reduce_scatter(tensor, ins, op=_TORCH_OPS[op], group=_pg(g))
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return Task()


def send(tensor: torch.Tensor, dst: int = 0, group=None,
         sync_op: bool = True) -> Task:
    g = _resolve_group(group)
    task = Task(tensor, work=dist.isend(tensor.contiguous(),
                                        dst=_src(g, dst), group=_pg(g)))
    if sync_op:
        task.wait()
    return task


def recv(tensor: torch.Tensor, src: int = 0, group=None,
         sync_op: bool = True) -> Task:
    g = _resolve_group(group)
    task = Task(tensor, work=dist.irecv(tensor, src=_src(g, src),
                                        group=_pg(g)))
    if sync_op:
        task.wait()
    return task


def isend(tensor: torch.Tensor, dst: int = 0, group=None,
          sync_op: bool = False) -> Task:
    return send(tensor, dst=dst, group=group, sync_op=sync_op)


def irecv(tensor: torch.Tensor, src: int = 0, group=None,
          sync_op: bool = False) -> Task:
    return recv(tensor, src=src, group=group, sync_op=sync_op)


def barrier(group=None) -> Task:
    g = _resolve_group(group)
    if _pg(g) is not None:
        dist.barrier(group=_pg(g))
    return Task()


def wait(tensor, group=None, use_calc_stream: bool = True) -> None:
    """Order communication against computation (paddle's ``c_wait_*``):
    the collectives here run on the calling stream, so this waits for the
    tensor's device to finish its queued work."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def is_available() -> bool:
    """Whether ``torch.distributed`` is built in."""
    return dist.is_available()


def get_backend(group=None) -> str:
    """The group's backend name, upper case (``NCCL``, ``GLOO``); ``NONE``
    for a group of one rank without a process group."""
    pg = _pg(_resolve_group(group))
    return "NONE" if pg is None else str(dist.get_backend(pg)).upper()


class ParallelMode:
    """Parallelism mode enum (reference: distributed/parallel.py)."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


# ---- the collectives of the tensor-parallel and ZeRO paths ---------------
#: the ops gloo runs on CUDA tensors itself (all-reduce and broadcast ran
#: that way on the card); on a gloo group every other op of this section on
#: CUDA tensors goes through pinned host memory, every time, never as a
#: fallback. NCCL takes every op on the device
GLOO_CUDA_NATIVE = ("all_reduce", "broadcast")
#: ``{op: calls}`` staged through the host, for the record
staged_ops = {}


def _through_host(pg, t: torch.Tensor, op: str) -> bool:
    if not t.is_cuda or op in GLOO_CUDA_NATIVE \
            or str(dist.get_backend(pg)) != "gloo":
        return False
    staged_ops[op] = staged_ops.get(op, 0) + 1
    return True


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


#: the pipeline's point-to-point exchanges: ``calls`` (one a tick that moves
#: anything), tensors and bytes sent and received, by this process
p2p_counts = {"calls": 0, "sent": 0, "received": 0, "bytes_sent": 0,
              "bytes_received": 0}


def p2p_exchange(sends, recvs, group) -> None:
    """One batch of point-to-point transfers over ``group``: ``sends`` are
    ``(dst, tensor, tag)`` and ``recvs`` ``(src, tensor, tag)`` (global
    ranks; each received tensor is written in place), all posted together
    (``batch_isend_irecv``) and then waited on, so two ranks that send to
    each other in one batch cannot deadlock. Each side of a pair posts its
    transfers in one order, which matches them; the tags keep kinds
    apart. On a gloo group CUDA tensors go through pinned host memory
    (gloo's send and recv take CPU tensors), counted in ``staged_ops``."""
    g = _resolve_group(group)
    pg = _pg(g)
    if pg is None:
        raise ValueError(f"p2p_exchange: {g} has no process group")
    gloo = str(dist.get_backend(pg)) == "gloo"
    ops, after = [], []
    for dst, t, tag in sends:
        src = t.contiguous()
        if gloo and src.is_cuda:
            staged_ops["send"] = staged_ops.get("send", 0) + 1
            src = _pinned(src)
        ops.append(dist.P2POp(dist.isend, src, _src(g, dst), group=pg,
                              tag=tag))
        p2p_counts["sent"] += 1
        p2p_counts["bytes_sent"] += t.numel() * t.element_size()
    for src_rank, t, tag in recvs:
        dst = t
        if gloo and t.is_cuda:
            staged_ops["recv"] = staged_ops.get("recv", 0) + 1
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            after.append((t, dst))
        ops.append(dist.P2POp(dist.irecv, dst, _src(g, src_rank), group=pg,
                              tag=tag))
        p2p_counts["received"] += 1
        p2p_counts["bytes_received"] += t.numel() * t.element_size()
    if not ops:
        return
    p2p_counts["calls"] += 1
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for t, host in after:
        t.copy_(host)


def gather_blocks(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (equal shapes), in rank order: one
    ``all_gather_into_tensor``. A group of one rank returns ``[t]``."""
    g = _resolve_group(group)
    if g.nranks == 1 or _pg(g) is None:
        return [t]
    src = t.reshape(-1)  # flat: gloo takes no stacked output
    out = torch.empty(g.nranks * src.numel(), dtype=src.dtype,
                      device=src.device)
    if _through_host(_pg(g), src, "all_gather_into_tensor"):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(host, _pinned(src), group=_pg(g))
        out.copy_(host)
    else:
        dist.all_gather_into_tensor(out, src, group=_pg(g))
    return list(out.view((g.nranks,) + tuple(t.shape)).unbind(0))


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in rank order: one
    ``all_gather_into_tensor``, whose buffer is the result itself for
    ``dim`` 0 (no copy). A group of one rank returns ``t``."""
    g = _resolve_group(group)
    if g.nranks == 1 or _pg(g) is None:
        return t
    moved = t.movedim(dim, 0) if dim else t
    blocks = gather_blocks(moved.contiguous(), g)
    if dim == 0:  # the blocks are consecutive views of one buffer
        base = blocks[0]._base if blocks[0]._base is not None else blocks[0]
        return base.view((g.nranks * t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat(blocks, 0).movedim(0, dim).contiguous()


def reduce_scatter_blocks(stacked: torch.Tensor, group) -> torch.Tensor:
    """``stacked`` is ``[n, ...]``, entry ``i`` meant for rank ``i``: rank
    ``r`` gets the SUM over ranks of their entry ``r`` (one
    ``reduce_scatter_tensor``)."""
    g = _resolve_group(group)
    if g.nranks == 1 or _pg(g) is None:
        return stacked[0]
    if stacked.shape[0] != g.nranks:
        raise ValueError(f"reduce_scatter_blocks: {stacked.shape[0]} "
                         f"entries for a group of {g.nranks}")
    src = stacked.reshape(-1)
    out = torch.empty(stacked.shape[1:], dtype=src.dtype, device=src.device)
    if _through_host(_pg(g), src, "reduce_scatter_tensor"):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(host.view(-1), _pinned(src),
                                   group=_pg(g))
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out.view(-1), src, group=_pg(g))
    return out


#: dtypes every gloo build moves as they are; any other goes as its raw
#: bytes (an exchange computes nothing, so the bytes are the values)
_GLOO_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int8,
                torch.uint8, torch.int32, torch.int64)


def all_to_all_blocks(stacked: torch.Tensor, group) -> torch.Tensor:
    """``stacked`` is ``[n, ...]``, entry ``j`` meant for rank ``j`` of the
    group (in its rank order): returns ``[n, ...]`` whose entry ``i`` is
    what rank ``i`` sent this one (one ``all_to_all_single``). A group of
    one rank returns ``stacked``."""
    g = _resolve_group(group)
    if g.nranks == 1 or _pg(g) is None:
        return stacked
    if stacked.shape[0] != g.nranks:
        raise ValueError(f"all_to_all_blocks: {stacked.shape[0]} entries "
                         f"for a group of {g.nranks}")
    src = stacked.contiguous()
    if src.dtype not in _GLOO_DTYPES and \
            str(dist.get_backend(_pg(g))) == "gloo":
        # bf16 (and any dtype this gloo build may lack) as its bytes
        return all_to_all_blocks(src.view(torch.uint8), g).view(src.dtype)
    flat = src.reshape(g.nranks, -1)
    out = torch.empty_like(flat)
    if _through_host(_pg(g), flat, "all_to_all_single"):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_to_all_single(host, _pinned(flat), group=_pg(g))
        out.copy_(host)
    else:
        dist.all_to_all_single(out, flat, group=_pg(g))
    return out.view(stacked.shape)


# ---- collectives inside the step, on the group along a mesh axis --------
# The JAX package's run inside ``shard_map`` over a mesh axis; here each
# is a differentiable call on this rank's tensor over its group along
# ``axis_name`` (a name of the hybrid topology's axes, or a ``Group``),
# built on ``fleet.meta_parallel.mp_ops``. A group of one rank changes
# nothing.
_A57 = "ROADMAP queue A item A5.7 (ring attention)"


def _mp_ops():
    from .fleet.meta_parallel import mp_ops

    return mp_ops


def psum(x, axis_name):
    """The SUM over the axis (backward: the identity, as ``mp_allreduce``)."""
    return _mp_ops().mp_allreduce(x, axis_name)


def pmean(x, axis_name):
    from .collective import axis_group

    return psum(x, axis_name) / axis_group(axis_name).nranks


def _pextreme(x, axis_name, op):
    from .collective import axis_group

    g = axis_group(axis_name)
    out = x.detach().clone()
    if g.nranks > 1:
        all_reduce(out, op, group=g)
    return out


def pmax(x, axis_name):
    """The MAX over the axis; not differentiable (the JAX package's pmax
    has no VJP either: callers stop the gradient first)."""
    return _pextreme(x, axis_name, ReduceOp.MAX)


def pmin(x, axis_name):
    """The MIN over the axis; not differentiable, as ``pmax``."""
    return _pextreme(x, axis_name, ReduceOp.MIN)


def ppermute(x, axis_name, perm):
    raise NotImplementedError(
        f"ppermute: point-to-point rings belong to ring attention, not "
        f"ported yet ({_A57})")


def axis_index(axis_name) -> int:
    """This rank's index along the axis."""
    from .collective import axis_group

    return max(axis_group(axis_name).rank, 0)


def all_gather_in_trace(x, axis_name, axis: int = 0, tiled: bool = False):
    """Every rank's ``x`` along ``axis``: stacked on a new ``axis`` or, with
    ``tiled``, concatenated along it. Backward keeps this rank's part."""
    if not tiled:
        x = x.unsqueeze(axis)
    return _mp_ops().c_concat(x, axis_name, dim=axis)


def reduce_scatter_in_trace(x, axis_name, scatter_dimension: int = 0,
                            tiled: bool = True):
    """The SUM over the axis, of which this rank keeps chunk ``rank`` of
    ``scatter_dimension`` (without ``tiled``, that dimension's size is
    the group's and is dropped). Backward gathers the chunks."""
    out = _mp_ops().reduce_scatter(x, axis_name, dim=scatter_dimension)
    return out if tiled else out.squeeze(scatter_dimension)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = (group, concat_axis, split_axis, tiled)
        return _all_to_all(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _all_to_all(x, group, split_axis, concat_axis, tiled):
    n = group.nranks
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all_in_trace: dimension {split_axis} "
                             f"of {tuple(x.shape)} does not split over {n} "
                             "ranks")
        sent = torch.stack(x.chunk(n, dim=split_axis))
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all_in_trace(tiled=False): dimension "
                             f"{split_axis} of {tuple(x.shape)} must be the "
                             f"group's size {n}")
        sent = x.movedim(split_axis, 0)
    got = all_to_all_blocks(sent, group)
    if tiled:
        return torch.cat(got.unbind(0), dim=concat_axis)
    return got.movedim(0, concat_axis)


def all_to_all_in_trace(x, axis_name, split_axis: int, concat_axis: int,
                        tiled: bool = True):
    """``lax.all_to_all`` on this rank's ``x``: chunk ``j`` of
    ``split_axis`` goes to rank ``j``, and what each rank sent this one is
    joined along ``concat_axis`` in rank order (without ``tiled``,
    ``split_axis`` has the group's size and is dropped, and the received
    pieces stack on a new ``concat_axis``). Backward is the inverse
    exchange."""
    from .collective import axis_group

    g = axis_group(axis_name)
    if g.nranks == 1:
        return x if tiled else x.movedim(split_axis, concat_axis)
    return _AllToAll.apply(x, g, split_axis % x.dim(),
                           concat_axis % x.dim(), tiled)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_along(x.contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        n = ctx.group.nranks
        rows = g.contiguous().view((n, g.shape[0] // n) + tuple(g.shape[1:]))
        return reduce_scatter_blocks(rows, ctx.group), None


def gather_rows(x, group):
    """Every rank's ``x`` joined along dimension 0 (an all-gather);
    backward is its transpose: the SUM over the group of the cotangents,
    block ``rank`` kept (a reduce-scatter). ``all_gather_in_trace``'s
    backward keeps this rank's block alone, which is right only where
    every rank's cotangent is the same."""
    return x if group.nranks == 1 else _GatherRows.apply(x, group)


def sum_over(x, group):
    """The SUM over ``group`` (an all-reduce) whose result each rank uses
    on its own: backward sums the ranks' cotangents (an all-reduce)."""
    mp_ops = _mp_ops()
    return mp_ops.mp_allreduce(mp_ops.c_identity(x, group), group)
