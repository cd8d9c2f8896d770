"""MoELayer (``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``
analog).

``moe_route`` is the shared routing core of ``MoELayer`` and
``models.gpt.GPTMoEMLP``: the gate product, the gate (``gate._route``:
each token's slots and fp32 combine weights), the experts' input
``[E, C, d]`` as a gather of token rows (empty slots zero), the experts,
and each token's output as the fp32 weighted sum of its at most two slots,
cast to the experts' dtype. These are the values of the JAX package's
``tec,td->ecd`` and ``tec,ecd->td`` fp32 einsums against its one-hot
``[T, E, C]`` tensors, which the port never builds. Nothing is read on the
host, so a CUDA graph can capture the route. The dispatch and the combine
are gathers forward and backward (no atomic adds: the same bits every
run); the dispatch's backward sums each token's two slot gradients in
fp32, as the einsum's transpose does.

Expert parallelism (``groups``, a ``MoEGroups``: the data axes' group,
the ``ep`` group and the ep rank's replicas along the other data axes)
runs the JAX package's dataflow, which GSPMD derives from its ``ep``
placement: each rank routes its own tokens at their places in the global
batch (``gate._route`` over the data group), gathers them into a partial
``[E, C, d]`` stack (zeros in every other rank's slots), reduce-scatters
it over ``ep`` into its ``[E/ep, C, d]`` and sums that over the replicas,
runs its experts, all-gathers their outputs over ``ep`` and combines its
own tokens. Each slot holds one token of the whole batch, so every sum
has one non-zero term: the values are the one-hot einsums' bit for bit.
Each collective's backward is its transpose (``communication``'s
``reduce_scatter_in_trace``, ``sum_over``, ``gather_rows``): a replica receives the
cotangents of its own tokens only, and the sum over the replicas in the
dispatch's backward gives every token the whole gradient of its slots.
``dispatch_mode="quant"`` runs the two exchanges block-scaled int8
(``dispatch.py``); without an ``ep`` group of more than one rank it
routes as ``"dense"``, as the JAX package's ``plan_quant_dispatch``
returns None without an ``ep`` axis. ``global_scatter`` and
``global_gather`` are the reference's count-routed exchange across the
ranks of a group.

``replicated`` (an ep group) is the routing of rows that are the same on
every rank of the group, as a served model's are: each rank routes them
as one process does (``capacity`` that of their own ``T``, the dispatch
local), runs its ``E/ep`` experts on their slots and all-gathers the
experts' outputs over ep, then combines locally. The values are one
process's, bit for bit, and the only exchange is the gather.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .....distributed.collective import Group, _resolve_group, group_of
from .....distributed.communication import (alltoall_single, gather_along,
                                            gather_rows,
                                            reduce_scatter_in_trace, sum_over)
from .....distributed.fleet.meta_parallel.mp_layers import _Linear
from .....distributed.sharding_utils import local_block
from .....distributed.topology import MoEGroups
from .....nn import functional as F
from .gate import _route


def moe_groups(group=None) -> Optional[MoEGroups]:
    """The groups of a MoE block: those of ``group`` (an expert-parallel
    group, which alone carries the data unless it is the hybrid
    topology's ``ep`` group), else the hybrid topology's; None (one rank's
    routing) without a topology or when its data axes hold one rank."""
    from .....distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if group is None:
        return hcg.moe_groups() if hcg is not None else None
    g = _resolve_group(group)
    if not isinstance(g, Group):
        raise TypeError(f"group must be a Group (a fleet topology's "
                        f"get_expert_parallel_group()), got "
                        f"{type(group).__name__}")
    if hcg is not None and g is hcg.get_expert_parallel_group():
        return hcg.moe_groups()
    if g.nranks == 1:
        return None
    from .....distributed.parallel import get_rank

    return MoEGroups(g, g, group_of([get_rank()], axis_name="replica"))


class _WholeStack(torch.autograd.Function):
    """An ep rank's block of an expert stack -> the whole stack, gathered
    over the ep group. The backward adds the whole stack's gradient into
    ``sink[key]`` (the explicit reduction's input) and hands the block its
    rows of it."""

    @staticmethod
    def forward(ctx, w, group, sink, key):
        ctx.group, ctx.sink, ctx.key = group, sink, key
        return gather_along(w.contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        prev = ctx.sink.get(ctx.key)
        ctx.sink[ctx.key] = g if prev is None else prev + g
        return (local_block(g, 0, ctx.group.rank, ctx.group.nranks),
                None, None, None)


def _slot_choices(slots, n_slots: int):
    """The inverse of ``slots`` ``[T, k]``: for each of the ``n_slots``
    slots, the flat index ``t * k + j`` of the choice routed there, or
    ``T * k`` where none is. Dropped choices all point at the extra slot
    ``n_slots``, which is cut off (a scatter with no sum: no atomics)."""
    T, k = slots.shape
    src = torch.full((n_slots + 1,), T * k, dtype=torch.long,
                     device=slots.device)
    src.scatter_(0, slots.reshape(-1), torch.arange(T * k,
                                                    device=slots.device))
    return src[:n_slots]


def _pad_row(t):
    """``t`` with one zero row (or element) appended along dim 0."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


class _Dispatch(torch.autograd.Function):
    """``[T, d]`` token rows -> ``[E * C, d]`` expert slots: slot ``s``
    holds the row of the token routed there, or zeros. The backward
    gathers each token's slot gradients and sums them in fp32."""

    @staticmethod
    def forward(ctx, xt, slots, choice):
        k = slots.shape[1]
        ctx.save_for_backward(slots)
        token = torch.div(choice, k, rounding_mode="floor")  # T: none
        return _pad_row(xt).index_select(0, token)

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        T, k = slots.shape
        rows = _pad_row(g).index_select(0, slots.reshape(-1)).view(
            T, k, g.shape[-1])
        if k == 1:
            return rows[:, 0], None, None
        return rows.float().sum(dim=1).to(g.dtype), None, None


class _Combine(torch.autograd.Function):
    """``[E * C, d']`` expert outputs -> ``[T, d']``: each token's slots
    weighted in fp32 and summed, cast to the outputs' dtype; a dropped
    choice reads the zero row past the last slot. The backward is
    gathers as well: a slot's gradient is its one token's output gradient
    times its weight, a weight's the product of the two rows."""

    @staticmethod
    def forward(ctx, eout, weights, slots, choice):
        T, k = slots.shape
        rows = _pad_row(eout).index_select(0, slots.reshape(-1)).view(
            T, k, eout.shape[-1])
        ctx.save_for_backward(rows, weights, slots, choice)
        return (weights[..., None] * rows.float()).sum(dim=1).to(eout.dtype)

    @staticmethod
    def backward(ctx, g):
        rows, weights, slots, choice = ctx.saved_tensors
        k = slots.shape[1]
        gf = g.float()
        d_weights = (gf[:, None, :] * rows.float()).sum(dim=-1)
        token = torch.div(choice, k, rounding_mode="floor")
        w = _pad_row(weights.reshape(-1)).index_select(0, choice)
        d_eout = (w[:, None] * _pad_row(gf).index_select(0, token)).to(
            g.dtype)
        return d_eout, d_weights, None, None


def moe_route(xt, gate_weight, gate_type: str, capacity: int, run_experts,
              dispatch_mode: str = "dense", quant_block: int = 128, *,
              groups: Optional[MoEGroups] = None,
              replicated: Optional[Group] = None):
    """Shared routing core (GShard/Switch): gate -> dispatch ->
    ``run_experts([E, C, d] -> [E, C, d'])`` -> combine. Returns
    ``(out [T, d'], aux)``. ``gate_type`` ``"gshard"`` is top-2, anything
    else top-1 (Switch). With ``groups`` the tokens are this rank's,
    ``capacity`` the global batch's and ``run_experts`` takes this ep
    rank's ``[E/ep, C, d]`` (module docstring). ``dispatch_mode``
    ``"quant"`` runs the exchanges block-scaled int8 at ``quant_block``
    when there is an ``ep`` exchange (``dispatch.plan_quant_dispatch``),
    else routes as ``"dense"``. With ``replicated`` (an ep group, no
    ``groups``) the rows are the same on every rank of it and
    ``run_experts`` takes this rank's ``[E/ep, C, d]`` (module docstring;
    routed ``"dense"``: no dispatch exchange is left to compress)."""
    if dispatch_mode not in ("dense", "quant"):
        raise ValueError(
            f"dispatch_mode must be 'dense' or 'quant', got {dispatch_mode!r}")
    E = gate_weight.shape[-1]
    logits = torch.matmul(xt, gate_weight)  # [T, E]
    slots, weights, aux = _route(logits, capacity,
                                 2 if gate_type == "gshard" else 1,
                                 group=groups.data if groups else None)
    choice = _slot_choices(slots, E * capacity)
    d = xt.shape[-1]
    if groups is None and replicated is not None and replicated.nranks > 1:
        ein = _Dispatch.apply(xt, slots, choice).view(E, capacity, d)
        mine = local_block(ein, 0, replicated.rank, replicated.nranks)
        full = gather_rows(run_experts(mine), replicated)  # [E, C, d']
        out = _Combine.apply(full.reshape(E * capacity, -1), weights, slots,
                             choice)
        return out, aux
    if groups is None:
        ein = _Dispatch.apply(xt, slots, choice)
        eout = run_experts(ein.view(E, capacity, d))
        out = _Combine.apply(eout.reshape(E * capacity, -1), weights, slots,
                             choice)
        return out, aux
    plan = None
    if dispatch_mode == "quant":
        from .dispatch import plan_quant_dispatch

        plan = plan_quant_dispatch(int(xt.shape[0]), int(E), int(capacity),
                                   int(d), block=quant_block, groups=groups)
    if plan is not None:
        from .dispatch import quant_combine, quant_dispatch

        eout = run_experts(quant_dispatch(plan, (slots, choice), xt))
        return quant_combine(plan, (weights, slots, choice), eout), aux
    part = _Dispatch.apply(xt, slots, choice).view(E, capacity, d)
    ein = sum_over(reduce_scatter_in_trace(part, groups.ep, 0),
                   groups.replica)
    full = gather_rows(run_experts(ein), groups.ep)  # [E, C, d']
    out = _Combine.apply(full.reshape(E * capacity, -1), weights, slots,
                         choice)
    return out, aux


#: the stacked ExpertMLP weights the batched expert product takes, and
#: the keys of a MoELayer's ``whole_grads``
STACK_KEYS = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")

#: the activations the batched expert product takes (paddle's gelu is
#: exact, not the tanh form)
_FUSED_ACTS = {"gelu": lambda x: F.gelu(x, approximate=False),
               "relu": torch.relu, "silu": torch.nn.functional.silu,
               "sigmoid": torch.sigmoid, "tanh": torch.tanh}


class MoELayer(nn.Module):
    """Mixture of experts over ``experts`` (a list of modules, each
    ``[n, d_model] -> [n, d']``).

    Capacity follows the reference: ``max(1, int(capacity_factor * T /
    E))`` slots per expert; a choice past it is dropped and its token gets
    nothing from that expert (the residual path carries it). ``aux_loss``
    holds the gate's load-balancing term of the last forward. When every
    expert is an ``ExpertMLP`` of one shape and activation, the experts
    run as one batched fp32 product over their stacked weights; otherwise
    one by one. ``gate_weight [d_model, E]`` is drawn Xavier-uniform.

    With ``group``, an expert-parallel group of ``n`` ranks (the hybrid
    topology's ``get_expert_parallel_group()``, or any group, whose ranks
    then carry the data alone), ``experts`` are this rank's, as in the
    reference: ``E = n * len(experts)`` experts in rank order, the gate
    over all of them, and the tokens this rank's rows of the global batch
    (``moe_route`` over ``moe_groups(group)``). A group of one rank routes
    as no group does.

    ``local_ep`` (set for its own forward by the train step whose explicit
    gradient reduction runs over an ep axis, as the JAX step's
    fully-manual region holds every expert, and None again after it)
    makes each rank route its own rows alone over all ``E`` experts, at
    the capacity of its own ``T``: the experts' stacked weights are
    gathered over that group (same-shaped ``ExpertMLP``s only), and their
    whole gradients collect in ``whole_grads`` under ``"fc1.weight"``,
    ``"fc1.bias"``, ``"fc2.weight"`` and ``"fc2.bias"`` (``[E, ...]``)."""

    def __init__(self, d_model: int, experts: Sequence[nn.Module],
                 gate="gshard", top_k: Optional[int] = None,
                 capacity_factor: float = 1.25, group=None,
                 recompute_interval: int = 0, dispatch: str = "dense",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.groups = moe_groups(group)
        self.dispatch_mode = dispatch
        self.d_model = d_model
        self.num_experts = len(experts) * (self.groups.ep.nranks
                                           if self.groups else 1)
        self.experts = list(experts)
        for i, e in enumerate(self.experts):
            self.add_module(f"expert_{i}", e)
        self.capacity_factor = capacity_factor
        self.recompute_interval = recompute_interval
        if top_k is not None:
            if top_k not in (1, 2):
                raise ValueError(
                    f"top_k must be 1 (switch) or 2 (gshard), got {top_k}")
            self.gate_type = "switch" if top_k == 1 else "gshard"
        elif isinstance(gate, str):
            self.gate_type = gate
        else:
            self.gate_type = ("gshard" if getattr(gate, "top_k", 2) == 2
                              else "switch")
        self.top_k = 1 if self.gate_type == "switch" else 2
        self.gate_weight = nn.Parameter(torch.empty(
            d_model, self.num_experts, device=device, dtype=dtype))
        nn.init.xavier_uniform_(self.gate_weight)
        self.aux_loss = None
        self.local_ep = None
        self.whole_grads = {}

    def fusable(self) -> bool:
        """Whether every expert is a same-shaped ``ExpertMLP`` with a
        batched activation (the experts then run as one batched product
        over their stacked weights)."""
        e0 = self.experts[0]
        if not all(type(e) is ExpertMLP for e in self.experts):
            return False
        shapes = (e0.fc1.weight.shape, e0.fc2.weight.shape)
        return all((e.fc1.weight.shape, e.fc2.weight.shape) == shapes
                   and e._act_name == e0._act_name for e in self.experts) \
            and e0._act_name in _FUSED_ACTS

    def _fused_experts(self):
        """``run_experts`` over the stacked weights when ``fusable``, else
        None; under ``local_ep`` over every expert's, gathered."""
        if not self.fusable():
            return None
        act = _FUSED_ACTS[self.experts[0]._act_name]
        stacks = []
        for key in STACK_KEYS:
            fc, p = key.split(".")
            w = torch.stack([getattr(getattr(e, fc), p)
                             for e in self.experts])
            if self.local_ep is not None:
                w = _WholeStack.apply(w, self.local_ep, self.whole_grads,
                                      key)
            stacks.append(w)
        w1, b1, w2, b2 = stacks

        def run_experts(ein):
            h = act(torch.bmm(ein.float(), w1.float()) + b1.float()[:, None])
            o = torch.bmm(h, w2.float()) + b2.float()[:, None]
            return o.to(ein.dtype)

        return run_experts

    def forward(self, x):
        shape = x.shape
        xt = x.reshape(-1, shape[-1])  # [T, d]
        groups = self.groups if self.local_ep is None else None
        T = xt.shape[0] * (groups.data.nranks if groups else 1)
        capacity = max(1, int(self.capacity_factor * T / self.num_experts))
        run_experts = self._fused_experts()
        if run_experts is None:
            def run_experts(ein):
                return torch.stack([e(ein[i])
                                    for i, e in enumerate(self.experts)])
        out, aux = moe_route(xt, self.gate_weight, self.gate_type, capacity,
                             run_experts, dispatch_mode=self.dispatch_mode,
                             groups=groups)
        self.aux_loss = aux
        return out.reshape(*shape[:-1], out.shape[-1])


class ExpertMLP(nn.Module):
    """Default FFN expert (the reference's ExpertLayer): ``fc2(act(fc1(x)))``
    with ``fc1 [d_model, d_hidden]`` and ``fc2 [d_hidden, d_model]``
    (weights ``[in, out]``, Xavier-normal; biases zero). ``activation`` is
    one of ``gelu`` (exact), ``relu``, ``silu``, ``sigmoid``, ``tanh``;
    other names wait for the rest of ``nn.functional`` (ROADMAP queue A
    item A8) and raise."""

    def __init__(self, d_model: int, d_hidden: int, activation: str = "gelu",
                 *, device=None, dtype=None):
        super().__init__()
        if activation not in _FUSED_ACTS:
            raise NotImplementedError(
                f"ExpertMLP(activation={activation!r}): only "
                f"{sorted(_FUSED_ACTS)} are ported (ROADMAP queue A item A8)")
        self.fc1 = _Linear(d_model, d_hidden, None, True, False, None,
                           device, dtype)
        self.fc2 = _Linear(d_hidden, d_model, None, True, False, None,
                           device, dtype)
        self._act_name = activation
        self.act = _FUSED_ACTS[activation]

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _host_counts(c):
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    return np.asarray(c).astype(np.int64).reshape(-1)


def _exchange_plan(local_count, global_count, g, device):
    """Each rank's rows: ``local_count[i]`` rows for global expert ``i``
    (rank ``i // n_local``'s local expert ``i % n_local``), and
    ``global_count[s * n_local + e]`` rows received from rank ``s`` for
    local expert ``e``. Returns the send and receive split sizes and the
    received rows' order as the reference lays them out (local-expert
    major, then source rank). Counts left None are exchanged on
    ``device``, the rows' (NCCL takes no host tensor), and read back."""
    lc = _host_counts(local_count)
    n = g.nranks
    n_local = lc.size // n
    if global_count is None:  # what every rank sends this one
        got = torch.empty(lc.size, dtype=torch.int64, device=device)
        alltoall_single(torch.from_numpy(lc).to(device), got, group=g)
        global_count = got
    gc = _host_counts(global_count).reshape(n, n_local)  # [source, e]
    send = lc.reshape(n, n_local).sum(axis=1).tolist()
    recv = gc.sum(axis=1).tolist()
    starts = np.concatenate([[0], np.cumsum(gc.reshape(-1))[:-1]]).reshape(
        n, n_local)
    order = np.concatenate([np.arange(starts[s, e], starts[s, e] + gc[s, e])
                            for e in range(n_local) for s in range(n)]
                           ).astype(np.int64)
    return send, recv, torch.from_numpy(order)


def _exchange_group(group):
    """The group of a count-routed exchange, or None where it is the
    identity (one rank, or no world and no group)."""
    if group is None and not torch.distributed.is_initialized():
        return None
    g = _resolve_group(group)
    return g if g.nranks > 1 and g.process_group is not None else None


def _exchange(x, send, recv, g):
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    alltoall_single(x.contiguous(), out, in_split_sizes=send,
                    out_split_sizes=recv, group=g)
    return out


def global_scatter(x, local_count, global_count, group=None):
    """Count-routed token exchange (``global_scatter_op`` analog): ``x``
    holds this rank's rows in chunks of ``local_count[i]`` rows (``i``
    over ``world * n_local`` global experts, rank-major: chunk ``i`` goes
    to rank ``i // n_local``'s local expert ``i % n_local``);
    ``global_count[s * n_local + e]`` is what rank ``s`` sends this one
    for its expert ``e`` (exchanged when None). The received rows are
    ordered local-expert major, then source rank. One
    ``all_to_all_single`` with split sizes from the counts, which are
    read on the host, as the reference reads them. On one rank the
    identity."""
    g = _exchange_group(group)
    if g is None:
        return x
    send, recv, order = _exchange_plan(local_count, global_count, g,
                                       x.device)
    return _exchange(x, send, recv, g).index_select(0, order.to(x.device))


def global_gather(x, local_count, global_count, group=None):
    """The inverse of ``global_scatter`` with the same counts: each rank's
    rows go back to their source in their original chunk order."""
    g = _exchange_group(group)
    if g is None:
        return x
    send, recv, order = _exchange_plan(local_count, global_count, g,
                                       x.device)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel())
    return _exchange(x.index_select(0, back.to(x.device)), recv, send, g)
