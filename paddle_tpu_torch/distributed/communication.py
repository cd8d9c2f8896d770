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

The in-trace collectives (``psum``, ``pmean``, ``pmax``, ``pmin``,
``ppermute``, ``axis_index``, ``*_in_trace``) belong to the tensor-parallel
layers' ``shard_map`` and raise ``NotImplementedError`` (ROADMAP queue A
item A5.3).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .collective import Group, _resolve_group

_A53 = "ROADMAP queue A item A5.3 (tensor and sharding parallelism)"


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


def _in_trace(name):
    raise NotImplementedError(
        f"{name}: collectives inside a traced step belong to the "
        f"tensor-parallel layers' shard_map, not ported yet ({_A53})")


def psum(x, axis_name):
    _in_trace("psum")


def pmean(x, axis_name):
    _in_trace("pmean")


def pmax(x, axis_name):
    _in_trace("pmax")


def pmin(x, axis_name):
    _in_trace("pmin")


def ppermute(x, axis_name, perm):
    _in_trace("ppermute")


def axis_index(axis_name):
    _in_trace("axis_index")


def all_gather_in_trace(x, axis_name, axis: int = 0, tiled: bool = False):
    _in_trace("all_gather_in_trace")


def reduce_scatter_in_trace(x, axis_name, scatter_dimension: int = 0,
                            tiled: bool = True):
    _in_trace("reduce_scatter_in_trace")


def all_to_all_in_trace(x, axis_name, split_axis: int, concat_axis: int,
                        tiled: bool = True):
    _in_trace("all_to_all_in_trace")
