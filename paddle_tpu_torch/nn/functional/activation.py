"""Activation functionals (``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch


def gelu(x, approximate: bool = False, name=None):
    """``approximate=True`` is the tanh form, as ``jax.nn.gelu``'s."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")
