"""Mixed precision (``paddle_tpu/amp`` analog): ``GradScaler``,
``decorate`` (O2: the model cast once, fp32 master weights in the
optimizer) and ``is_bfloat16_supported``.

``auto_cast`` at O1 or O2 casts each op's inputs by a white and a black
list, which the JAX package does at its single dispatch seam
(``ops/_dispatch.apply``). Plain PyTorch modules have no such seam in this
package, so an enabled ``auto_cast`` raises instead of running uncast.
"""

from __future__ import annotations

import contextlib

import torch

from ..device import resolve_dtype
from .grad_scaler import GradScaler


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype=None):
    if enable and level != "O0":
        raise NotImplementedError(
            f"auto_cast level {level!r} is not ported yet: it casts each op's "
            "inputs at a dispatch seam the port does not have (ROADMAP queue "
            "A item 3); use decorate(level='O2') to cast the model once")
    return contextlib.nullcontext()


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype=None,
             master_weight=None, save_dtype=None):
    """O2: cast the model(s) to ``dtype`` (bf16 by default) and give the
    optimizer(s) fp32 master weights unless ``master_weight`` is False.
    Returns what it was given, as the JAX package does."""
    dtype = resolve_dtype("bfloat16" if dtype is None else dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dtype)
    models_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return models_out
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if level == "O2" and master_weight is not False:
        for opt in opt_list:
            opt._multi_precision = True
    return models_out, (opt_list[0] if single_opt else opt_list)


def is_bfloat16_supported(device=None):
    """bf16 runs on the CPU (plain versions) and on a card that supports it
    (Ampere and later)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return True
    return torch.cuda.is_available() and torch.cuda.is_bf16_supported()


__all__ = ["GradScaler", "auto_cast", "amp_guard", "decorate",
           "is_bfloat16_supported"]
