"""Activation recomputation (``paddle_tpu/distributed/fleet/recompute.py``
analog).

The JAX package wraps the region in ``jax.checkpoint`` with a policy; here
it is ``torch.utils.checkpoint`` without re-entrance, and a save-some
policy is a selective-checkpoint context that decides per dispatcher op
whether its outputs are kept for the backward or recomputed:

- ``None`` / ``'full'``: nothing inside the region is kept; the backward
  replays its forward, kernels included (a recomputed block launches its
  flash forward twice per step);
- ``'dots_saveable'``: matrix-product outputs (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``) are kept and the replay runs only the rest;
- ``'dots_with_no_batch_dims_saveable'``: only the 2-D products (``mm``,
  ``addmm``; a ``[B, S, H] @ [H, N]`` linear is one of them);
- ``'save_flash'``: only the flash-attention forward's outputs are kept,
  O **and** its LSE (the ``paddle_tpu_torch::flash_fwd`` op), so the
  replay skips the flash forward; the JAX package tags O alone, which on
  this side would still replay the kernel to get the LSE.

The RNG state is stashed and restored, so dropout masks replay
identically.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...kernels.flash_attention import flash_fwd_op  # noqa: F401 (the op)

_aten = torch.ops.aten
_SAVED = {
    "dots_saveable": (_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default),
    "dots_with_no_batch_dims_saveable": (_aten.mm.default,
                                         _aten.addmm.default),
    "save_flash": (torch.ops.paddle_tpu_torch.flash_fwd.default,),
}
POLICIES = (None, "full", *_SAVED)


def _policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def recompute(function, *args, policy=None, **kwargs):
    """Checkpoint ``function(*args, **kwargs)``: keep its inputs and what
    ``policy`` saves, replay the rest of its forward in the backward."""
    if policy not in POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; one of "
                         f"{[p for p in POLICIES if p]}")
    if policy in _SAVED:
        context_fn = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_policy, _SAVED[policy]))
        return checkpoint(function, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
