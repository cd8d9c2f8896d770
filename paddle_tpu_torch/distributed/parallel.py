"""Parallel environment and ``DataParallel`` (``paddle_tpu/distributed/
parallel.py`` analog) over ``torch.distributed``.

``init_parallel_env`` forms the default process group from the launcher's
environment (``mesh.init_distributed_runtime``), builds the world mesh and
registers the default ``Group``. Each rank is a process with one device:
``cuda:FLAGS_selected_gpus`` (the launcher sets it to the local rank modulo
the visible cards), or the CPU when the caller asks for it.

``GradBuffers`` hold the gradients of a model in persistent flat buffers,
one per dtype and device: each gradient is a view into them, so that the
average over a group is a SUM all-reduce of each buffer (or of each of its
buckets) in place and ``1/nranks`` per buffer, with nothing packed or
copied back.
The train step points the gradients at their views before its backward
and reduces each buffer in one call once the backward is done;
``DataParallel`` wraps a model for a user's own loop: ``scale_loss``
leaves the loss as it is and ``apply_collective_grads`` averages every
gradient over the group through such buffers (a gradient the loop made
anew is copied in once), so the gradients after it are the global
batch's, as the JAX package's are when its compiled step returns them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from .collective import Group, _get_global_group, _resolve_group
from .mesh import get_global_mesh, init_distributed_runtime

class ParallelEnv:
    """Env-derived rank info (the PaddleCloudRoleMaker / ParallelEnv
    analog)."""

    def __init__(self):
        dflt_rank = dist.get_rank() if dist.is_initialized() else 0
        dflt_world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", dflt_rank))
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                             dflt_world))
        self.device_id = int(os.environ.get("FLAGS_selected_gpus", "0")
                             .split(",")[0])
        self.trainer_endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self.rank

    @property
    def dev_id(self):
        return self.device_id


_parallel_env: Optional[ParallelEnv] = None


def init_parallel_env(*, device=None) -> ParallelEnv:
    """Join the world: the process group (when the environment names more
    than one trainer or a master), the world mesh and the default group.
    ``device`` is the rank's device, ``cuda`` by default (its index
    ``FLAGS_selected_gpus``); ``"cpu"`` runs gloo on the CPU."""
    global _parallel_env
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", ParallelEnv().device_id)
    init_distributed_runtime(device=dev)
    get_global_mesh()
    _get_global_group()
    if _parallel_env is None:
        _parallel_env = ParallelEnv()
    return _parallel_env


def get_rank(group: Group = None) -> int:
    if group is not None:
        return group.get_group_rank(get_rank())
    if dist.is_initialized():
        return dist.get_rank()
    return _parallel_env.rank if _parallel_env is not None else 0


def get_world_size(group: Group = None) -> int:
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return _parallel_env.world_size if _parallel_env is not None else 1


class GradBuffers:
    """Persistent flat gradient buffers averaged over ``group``. Per dtype
    and device, one flat buffer holds every
    gradient of ``params`` as a view, each slot starting on a 64-byte
    boundary so that a kernel's vector loads stay aligned. Each buffer is
    one all-reduce, or with ``bucket_bytes`` the runs of up to that many
    bytes (a larger gradient is a bucket alone): ``DataParallel``'s
    ``comm_buffer_size``. ``divisor`` replaces the group's size as what
    the sums are divided by (an expert stack's gradients are summed over
    its ep rank's replicas and divided by the whole data group's size).
    Every rank must build it over the same shapes in the same order."""

    def __init__(self, params, group: Group,
                 bucket_bytes: Optional[int] = None, *,
                 divisor: Optional[int] = None):
        self.group = group
        self.divisor = group.nranks if divisor is None else int(divisor)
        keyed = {}
        for p in params:
            if p.requires_grad:
                keyed.setdefault((p.dtype, p.device), []).append(p)
        self.params, self.views, self.buffers, self.buckets = [], [], [], []
        for (dtype, device), ps in keyed.items():
            size = torch.empty((), dtype=dtype).element_size()
            align = max(64 // size, 1)
            offsets, n, start, cuts = [], 0, 0, []
            for p in ps:
                if bucket_bytes is not None and n > start \
                        and (n - start + p.numel()) * size > bucket_bytes:
                    cuts.append((start, n))
                    start = n
                offsets.append(n)
                n += -(-p.numel() // align) * align
            cuts.append((start, n))
            flat = torch.zeros(n, dtype=dtype, device=device)
            self.buffers.append(flat)
            self.buckets += [flat[a:b] for a, b in cuts]
            self.params += ps
            self.views += [flat[o:o + p.numel()].view_as(p)
                           for o, p in zip(offsets, ps)]

    @property
    def nbytes(self) -> int:
        return sum(f.numel() * f.element_size() for f in self.buffers)

    @torch.no_grad()
    def attach(self):
        """Zero the buffers and make each gradient its view: the backward
        then accumulates into them in place."""
        for flat in self.buffers:
            flat.zero_()
        for p, v in zip(self.params, self.views):
            if p.grad is not v:
                p.grad = v

    @torch.no_grad()
    def reduce(self):
        """Average the gradients over the group in place: a gradient that
        is not its view (a loop that set ``.grad`` to None or to a new
        tensor) is copied in first, None as zeros, and the view becomes
        its ``.grad``; then a SUM all-reduce of each bucket and
        ``1/divisor`` over each buffer in its dtype (not at all for a
        divisor of one)."""
        from .communication import all_reduce

        for p, v in zip(self.params, self.views):
            g = p.grad
            if g is None:
                v.zero_()
            elif g.data_ptr() != v.data_ptr():
                v.copy_(g)
            else:
                continue
            p.grad = v
        for bucket in self.buckets:
            all_reduce(bucket, group=self.group)
        if self.divisor > 1:
            for flat in self.buffers:
                flat.mul_(1.0 / self.divisor)


def grad_buffers(params, group: Group, bucket_bytes: Optional[int] = None
                 ) -> Optional[GradBuffers]:
    """``GradBuffers`` over ``group``, or None when it has no process group
    (a rank alone: nothing to average)."""
    if group.process_group is None:
        return None
    return GradBuffers(params, group, bucket_bytes)


class DataParallel(nn.Module):
    """paddle.DataParallel: the wrapped model's forward, with
    ``apply_collective_grads`` averaging its gradients over ``group``
    (default: the world) after ``loss.backward()``. ``comm_buffer_size``
    is the bucket size in MB."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group: Group = None):
        super().__init__()
        self._layers = layers
        self.group = _resolve_group(group)
        self.find_unused_parameters = find_unused_parameters
        self._bucket_bytes = int(comm_buffer_size) * 2 ** 20
        self._grads = None  # built at the first reduction

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The loss as it is: ``apply_collective_grads`` averages."""
        return loss

    def apply_collective_grads(self):
        if self._grads is None:
            self._grads = grad_buffers(self._layers.parameters(), self.group,
                                       self._bucket_bytes)
        if self._grads is not None:
            self._grads.reduce()

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)
