"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper (``fused_layer_norm``, ``flash_attention_fwd``,
``flash_attention_bwd_dq``, ``flash_attention_bwd_dkv``,
``paged_attention``, ``fused_adamw_update``) runs its plain version on CPU
tensors and launches its kernel on CUDA tensors, counting each launch in
its ``launches`` attribute. ``flash_attention`` and ``fused_layer_norm``
are differentiable through ``torch.autograd.Function``s whose forward and
backward are those wrappers. Triton and the CUDA libraries are imported
and built only inside a launch.
"""

from .flash_attention import (FlashAttention, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_bwd_ref,
                              flash_attention_fwd, flash_attention_ref)
from .fused_optim import adamw_ref, fused_adamw_update
from .norms import (LayerNormFunction, fused_layer_norm, layer_norm_bwd_ref,
                    layer_norm_ref)
from .paged_attention import paged_attention, paged_attention_ref

#: every kernel wrapper of the package, for resetting and reading the counts
WRAPPERS = (fused_layer_norm, flash_attention_fwd, paged_attention,
            flash_attention_bwd_dq, flash_attention_bwd_dkv,
            fused_adamw_update)


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts():
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["fused_layer_norm", "layer_norm_ref", "layer_norm_bwd_ref",
           "LayerNormFunction", "flash_attention", "flash_attention_fwd",
           "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_ref", "FlashAttention", "paged_attention",
           "paged_attention_ref", "fused_adamw_update", "adamw_ref",
           "WRAPPERS", "reset_launch_counts", "launch_counts"]
