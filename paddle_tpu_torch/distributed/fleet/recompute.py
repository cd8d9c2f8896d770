"""Activation recomputation (``paddle_tpu/distributed/fleet/recompute.py``
analog).

The JAX package wraps the region in ``jax.checkpoint``; here it is
``torch.utils.checkpoint`` without re-entrance: nothing inside the region
is kept for the backward, which replays the forward (kernels included, so
a recomputed block launches its flash forward twice per step). The RNG
state is stashed and restored, so dropout masks replay identically.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

_PENDING = ("dots_saveable", "dots_with_no_batch_dims_saveable", "save_flash")


def recompute(function, *args, policy=None, **kwargs):
    """Checkpoint ``function(*args, **kwargs)``: keep its inputs, replay its
    forward in the backward. ``policy`` None or ``'full'`` replays
    everything; the JAX package's save-some policies are not ported yet."""
    if policy in _PENDING:
        raise NotImplementedError(
            f"recompute policy {policy!r} is not ported yet (ROADMAP queue A "
            "item 3c: the dots_saveable and save_flash policies)")
    if policy not in (None, "full"):
        raise ValueError(f"unknown recompute policy {policy!r}; one of "
                         f"{['full', *_PENDING]}")
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
