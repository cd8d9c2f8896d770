from .activation import gelu
from .attention import _sdpa_ref, scaled_dot_product_attention
from .norm import layer_norm

__all__ = ["gelu", "layer_norm", "scaled_dot_product_attention", "_sdpa_ref"]
