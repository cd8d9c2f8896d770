"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper (``fused_layer_norm``, ``flash_attention_fwd``,
``paged_attention``) runs its plain version on CPU tensors and launches its
kernel on CUDA tensors, counting each launch in its ``launches`` attribute.
Triton and the CUDA libraries are imported and built only inside a launch.
"""

from .flash_attention import flash_attention_fwd, flash_attention_ref
from .norms import fused_layer_norm, layer_norm_ref
from .paged_attention import paged_attention, paged_attention_ref

#: every kernel wrapper of the package, for resetting and reading the counts
WRAPPERS = (fused_layer_norm, flash_attention_fwd, paged_attention)


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts():
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["fused_layer_norm", "layer_norm_ref", "flash_attention_fwd",
           "flash_attention_ref", "paged_attention", "paged_attention_ref",
           "WRAPPERS", "reset_launch_counts", "launch_counts"]
