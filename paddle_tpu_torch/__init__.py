"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The package follows ``paddle_tpu``'s layout and names so that each module's
counterpart is easy to find. Plain tensor code is PyTorch; every Pallas TPU
kernel on a ported path is a kernel written by hand for ``sm_90a`` (CUDA C++
under ``kernels/csrc/``, or Triton), built from the sources in this package
at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On
the CPU each kernel wrapper runs its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.

This package imports nothing of JAX and nothing of ``paddle_tpu``.
"""

from . import (checkpoint, data, distributed, framework, io, kernels, models,
               nn, optimizer)
from .device import resolve_device, resolve_dtype
from .framework import load, save

__all__ = ["checkpoint", "data", "distributed", "framework", "io", "kernels",
           "models", "nn", "optimizer", "resolve_device", "resolve_dtype",
           "load", "save"]
