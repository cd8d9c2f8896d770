"""``paddle_tpu.incubate`` analog: so far ``nn.functional.fused_rms_norm``
and ``distributed.models.moe`` (the MoE gates and layer)."""

from . import distributed, nn

__all__ = ["distributed", "nn"]
