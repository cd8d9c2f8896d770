from .activation import gelu
from .attention import _sdpa_ref, scaled_dot_product_attention
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "cross_entropy", "layer_norm", "rms_norm",
           "scaled_dot_product_attention", "_sdpa_ref"]
