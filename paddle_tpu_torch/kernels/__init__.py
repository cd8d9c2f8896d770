"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper (``fused_layer_norm``, ``fused_rms_norm`` and their backwards
``layer_norm_bwd``, ``rms_norm_bwd``, ``flash_attention_fwd``,
``flash_attention_bwd_dq``, ``flash_attention_bwd_dkv``,
``paged_attention``, ``fused_adamw_multi`` (one launch per dtype group of
a list of tensors), its one-tensor form ``fused_adamw_update``, and the
callables made by ``primitive.elementwise_kernel`` and
``primitive.row_reduce_kernel``) runs its plain version on CPU tensors and
launches its kernel on CUDA tensors, counting each launch in a
``launches`` attribute (the two factories count the launches of every
callable they made). ``flash_attention``, ``fused_layer_norm`` and
``fused_rms_norm`` are differentiable: the first through the dispatcher op
``paddle_tpu_torch::flash_fwd``, the norms through
``torch.autograd.Function``s, whose forward and backward are those
wrappers. The three flash wrappers also count their launches by route in
``route_launches`` (``flash_attention.FWD_ROUTES`` and ``BWD_ROUTES``: bf16
on the tensor cores, fp32 on the CUDA cores), and so do the four norm
wrappers (``norms.ROUTES``: a warp per row, or a block per row). Triton
and the CUDA libraries are imported and built only inside a launch.
"""

from . import primitive
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_dkv, flash_attention_bwd_dq,
                              flash_attention_bwd_ref, flash_attention_fwd,
                              flash_attention_ref, flash_fwd_op)
from .fused_optim import adamw_ref, fused_adamw_multi, fused_adamw_update
from .norms import (LayerNormFunction, RMSNormFunction, fused_layer_norm,
                    fused_rms_norm, layer_norm_bwd, layer_norm_bwd_ref,
                    layer_norm_ref, rms_norm_bwd, rms_norm_bwd_ref,
                    rms_norm_ref)
from .paged_attention import paged_attention, paged_attention_ref
from .primitive import elementwise_kernel, row_reduce_kernel
# the gradient reduction's wire format: plain PyTorch, no kernel
from .quant import (dequantize_block_scaled, fit_block_size,
                    quantize_block_scaled)

#: every kernel wrapper of the package, for resetting and reading the counts
WRAPPERS = (fused_layer_norm, layer_norm_bwd, flash_attention_fwd,
            paged_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv,
            fused_adamw_multi, fused_adamw_update, fused_rms_norm,
            rms_norm_bwd, elementwise_kernel, row_reduce_kernel)


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0
        for route in getattr(w, "route_launches", ()):
            w.route_launches[route] = 0


def launch_counts():
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["fused_layer_norm", "layer_norm_ref", "layer_norm_bwd",
           "layer_norm_bwd_ref", "LayerNormFunction", "fused_rms_norm",
           "rms_norm_ref", "rms_norm_bwd", "rms_norm_bwd_ref",
           "RMSNormFunction", "flash_attention",
           "flash_attention_fwd", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_ref", "flash_fwd_op", "paged_attention",
           "paged_attention_ref", "fused_adamw_multi", "fused_adamw_update",
           "adamw_ref",
           "primitive", "elementwise_kernel", "row_reduce_kernel",
           "quantize_block_scaled", "dequantize_block_scaled",
           "fit_block_size", "WRAPPERS", "reset_launch_counts",
           "launch_counts"]
