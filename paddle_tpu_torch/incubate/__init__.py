"""``paddle_tpu.incubate`` analog: so far only ``nn.functional.fused_rms_norm``."""

from . import nn

__all__ = ["nn"]
