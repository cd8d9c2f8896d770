"""Device and dtype resolution.

Every entry point of the port resolves its device here: ``None`` means
``cuda``, and asking for ``cuda`` on a machine without a card raises. The
port never falls back to the CPU on its own; the CPU runs only when the
caller asks for it (as the tests do).
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """A torch dtype from a torch dtype, its name, or ``None`` (float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise ValueError(f"unsupported dtype {dtype}; want one of "
                             f"{sorted(_DTYPES)}")
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; want one of "
                         f"{sorted(_DTYPES)}") from None
