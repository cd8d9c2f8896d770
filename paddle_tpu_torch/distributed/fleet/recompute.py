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


def recompute(function, *args, use_reentrant: bool = True,
              preserve_rng_state: bool = True, policy=None, **kwargs):
    """Checkpoint ``function(*args, **kwargs)``: keep its inputs and what
    ``policy`` saves, replay the rest of its forward in the backward.

    ``use_reentrant`` is paddle's choice between its two implementations,
    which compute the same values and gradients; the port always runs
    PyTorch's non-reentrant checkpoint (the one that takes a policy and
    inputs that need no gradient), as the JAX package always runs
    ``jax.checkpoint``. ``preserve_rng_state`` passes through: when True
    (the default) the RNG state is stashed and restored for the replay, so
    dropout masks replay identically."""
    if policy not in POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; one of "
                         f"{[p for p in POLICIES if p]}")
    if policy in _SAVED:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_policy, _SAVED[policy]))
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``paddle.incubate.distributed.fleet.recompute_sequential``: each of
    ``functions`` in turn under ``recompute`` (``kwargs`` go to each), the
    output of one the input of the next. ``ctx`` (paddle's segment
    settings) is not read, as in the JAX package: every function is its
    own segment."""
    out = args
    for fn in functions:
        out = (recompute(fn, *out, **kwargs),)
    return out[0]


def recompute_hybrid(ctx, function, *args, **kwargs):
    """The mp-aware variant: on one device it is ``recompute`` (``ctx``,
    paddle's mp group and offload settings, is not read, as in the JAX
    package)."""
    return recompute(function, *args, **kwargs)
