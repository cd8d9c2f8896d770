"""MoE gates (``paddle_tpu/incubate/distributed/models/moe/gate.py``
analog): GShard top-2 and Switch top-1 with capacity.

The JAX package builds one-hot ``dispatch`` and ``combine`` tensors of
shape ``[T, E, C]`` and contracts them with einsums. Every ``(e, c)`` slot
holds at most one token, so the same function has an index form: each
token's ``k`` slots ``e * C + pos`` (``E * C`` for a choice dropped at
capacity) and their fp32 combine weights. ``_route`` computes that form
with the reference's arithmetic (softmax in fp32, first-max ``argmax``,
positions by a cumulative sum over tokens in order, top-2 positions after
every top-1 token of the expert, the aux loss from the pre-capacity top-1
mask, the ``max(w1 + w2, 1e-9)`` renormalisation); ``moe_route`` routes
through it and never builds a ``[T, E, C]`` tensor. ``gshard_gating`` and
``switch_gating`` keep the reference's signature and return its dense
triple, built from the index form.

Over a data group (``group`` of ``W`` ranks, each with its own ``T``
tokens) ``_route`` routes the global batch, the ranks' tokens in rank
order, as the JAX package's gate does under GSPMD: positions count the
earlier ranks' choices of the expert (first choices after every earlier
rank's first choices, second choices after every first choice and every
earlier rank's second choices), ``capacity`` is the global batch's, and
the aux loss comes from the global sums of the pre-capacity mask and of
the probabilities. The counts are one all-gather of a ``[2, E]`` integer
tensor (``[1, E]`` for Switch), the probabilities' sum one all-reduce
whose backward sums the ranks' cotangents: nothing is read on the host.
"""

from __future__ import annotations

import torch

from .....distributed.communication import gather_blocks, sum_over


def _positions_in_expert(mask):
    """mask: ``[T, E]`` 0/1 -> position of each token within its expert's
    queue (0 where the mask is 0). The running sum goes along the
    innermost dimension of the ``[E, T]`` transpose: on CUDA a scan over
    the outer dimension of ``[T, E]`` runs E serial scans of T."""
    run = torch.cumsum(mask.t().contiguous(), dim=1).t()
    return (run - 1) * mask


def _one_hot(index, E):
    """``[T]`` expert ids -> ``[T, E]`` int64 0/1 (no host read, so a CUDA
    graph can capture it)."""
    return (index[:, None] == torch.arange(E, device=index.device)).long()


def _route(logits, capacity: int, top_k: int, *, group=None):
    """Index routing of ``logits`` ``[T, E]`` (any float dtype; the gate
    runs in fp32) into experts of ``capacity`` slots each.

    Returns ``(slots, weights, aux)``: ``slots`` ``[T, top_k]`` int64, the
    flat slot ``e * capacity + pos`` of each choice or ``E * capacity``
    where it was dropped; ``weights`` ``[T, top_k]`` fp32, the combine
    weights (0 for a dropped choice); ``aux`` the load-balancing loss.
    ``top_k`` 2 is GShard, 1 Switch. Gradients reach ``logits`` through
    the weights and ``aux``. With ``group`` (more than one rank) the
    positions and the aux loss are the global batch's (module
    docstring); ``capacity`` is then the global batch's too."""
    T, E = logits.shape
    C = int(capacity)
    probs = torch.softmax(logits.float(), dim=-1)
    g1 = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(g1, E)
    masks = [mask1]
    if top_k != 1:
        g2 = torch.argmax(probs * (1 - mask1), dim=-1)
        masks.append(_one_hot(g2, E))
    before = None  # earlier ranks' choices of each expert
    if group is not None and group.nranks > 1:
        aux, before, used1 = _global_counts(probs, masks, group)
    else:
        # load-balancing aux loss (Switch eq. 4), from the pre-capacity mask
        density = mask1.float().mean(dim=0)
        aux = (density * probs.mean(dim=0)).sum() * E
        used1 = mask1.sum(dim=0) if top_k != 1 else None
    pos1 = _positions_in_expert(mask1).gather(1, g1[:, None])[:, 0]
    if before is not None:
        pos1 = pos1 + before[0][g1]
    keep1 = pos1 < C
    w1 = probs.gather(1, g1[:, None])[:, 0] * keep1
    s1 = torch.where(keep1, g1 * C + pos1, E * C)
    if top_k == 1:
        return s1[:, None], w1[:, None], aux
    # second choices queue after every first choice of their expert
    pos2 = _positions_in_expert(masks[1]).gather(1, g2[:, None])[:, 0] \
        + used1[g2]
    if before is not None:
        pos2 = pos2 + before[1][g2]
    keep2 = pos2 < C
    w2 = probs.gather(1, g2[:, None])[:, 0] * keep2
    s2 = torch.where(keep2, g2 * C + pos2, E * C)
    denom = torch.clamp_min(w1 + w2, 1e-9)
    return (torch.stack([s1, s2], dim=1),
            torch.stack([w1 / denom, w2 / denom], dim=1), aux)


def _global_counts(probs, masks, group):
    """The global batch's aux loss, this rank's offsets (the earlier
    ranks' choices of each expert, ``[k, E]``) and every rank's first
    choices of each expert, from one all-gather of the ``[k, E]`` counts
    and one all-reduce of the probabilities' sum."""
    T, E = probs.shape
    counts = torch.stack(gather_blocks(torch.stack(
        [m.sum(dim=0) for m in masks]), group))  # [W, k, E]
    used1 = counts[:, 0].sum(dim=0)
    Tg = T * group.nranks
    aux = (used1.float() / Tg
           * (sum_over(probs.sum(dim=0), group) / Tg)).sum() * E
    return aux, counts[:group.rank].sum(dim=0), used1


def _dense(slots, weights, E: int, capacity: int):
    """The reference's ``(dispatch, combine)`` ``[T, E, C]`` fp32 from the
    index form (a dropped choice's column, ``E * C``, is cut off)."""
    T = slots.shape[0]
    n = E * capacity
    combine = torch.zeros(T, n + 1, dtype=torch.float32,
                          device=slots.device)
    combine.scatter_add_(1, slots, weights)
    dispatch = torch.zeros_like(combine)
    dispatch.scatter_(1, slots, 1.0)
    return (dispatch[:, :n].reshape(T, E, capacity),
            combine[:, :n].reshape(T, E, capacity))


def switch_gating(logits, capacity: int):
    """Top-1 (Switch) gate. Returns ``(dispatch [T, E, C] fp32, combine
    [T, E, C] fp32, aux_loss)``."""
    slots, weights, aux = _route(logits, capacity, 1)
    return (*_dense(slots, weights, logits.shape[1], int(capacity)), aux)


def gshard_gating(logits, capacity: int):
    """Top-2 (GShard) gate. Returns ``(dispatch [T, E, C] fp32, combine
    [T, E, C] fp32, aux_loss)``."""
    slots, weights, aux = _route(logits, capacity, 2)
    return (*_dense(slots, weights, logits.shape[1], int(capacity)), aux)


class BaseGate:
    def __init__(self, d_model: int, num_experts: int):
        self.d_model = d_model
        self.num_experts = num_experts


class SwitchGate(BaseGate):
    top_k = 1
    gating = staticmethod(switch_gating)


class GShardGate(BaseGate):
    top_k = 2
    gating = staticmethod(gshard_gating)
