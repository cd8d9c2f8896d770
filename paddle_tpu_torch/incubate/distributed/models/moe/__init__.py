"""Mixture of experts (``paddle_tpu.incubate.distributed.models.moe``
analog): the GShard/Switch gates, ``MoELayer`` and the token exchanges,
on one device or over an expert-parallel group (``dispatch``: the int8
exchanges of ``moe_dispatch="quant"``)."""

from .gate import GShardGate, SwitchGate, gshard_gating, switch_gating
from .moe_layer import ExpertMLP, MoELayer, global_gather, global_scatter

__all__ = ["GShardGate", "SwitchGate", "gshard_gating", "switch_gating",
           "ExpertMLP", "MoELayer", "global_gather", "global_scatter"]
