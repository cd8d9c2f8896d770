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
"""

from __future__ import annotations

import torch


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


def _route(logits, capacity: int, top_k: int):
    """Index routing of ``logits`` ``[T, E]`` (any float dtype; the gate
    runs in fp32) into experts of ``capacity`` slots each.

    Returns ``(slots, weights, aux)``: ``slots`` ``[T, top_k]`` int64, the
    flat slot ``e * capacity + pos`` of each choice or ``E * capacity``
    where it was dropped; ``weights`` ``[T, top_k]`` fp32, the combine
    weights (0 for a dropped choice); ``aux`` the load-balancing loss.
    ``top_k`` 2 is GShard, 1 Switch. Gradients reach ``logits`` through
    the weights and ``aux``."""
    T, E = logits.shape
    C = int(capacity)
    probs = torch.softmax(logits.float(), dim=-1)
    g1 = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(g1, E)
    # load-balancing aux loss (Switch eq. 4), from the pre-capacity mask
    density = mask1.float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * E
    pos1 = _positions_in_expert(mask1).gather(1, g1[:, None])[:, 0]
    keep1 = pos1 < C
    w1 = probs.gather(1, g1[:, None])[:, 0] * keep1
    s1 = torch.where(keep1, g1 * C + pos1, E * C)
    if top_k == 1:
        return s1[:, None], w1[:, None], aux
    g2 = torch.argmax(probs * (1 - mask1), dim=-1)
    mask2 = _one_hot(g2, E)
    # second choices queue after every first choice of their expert
    used1 = mask1.sum(dim=0)
    pos2 = _positions_in_expert(mask2).gather(1, g2[:, None])[:, 0] \
        + used1[g2]
    keep2 = pos2 < C
    w2 = probs.gather(1, g2[:, None])[:, 0] * keep2
    s2 = torch.where(keep2, g2 * C + pos2, E * C)
    denom = torch.clamp_min(w1 + w2, 1e-9)
    return (torch.stack([s1, s2], dim=1),
            torch.stack([w1 / denom, w2 / denom], dim=1), aux)


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
