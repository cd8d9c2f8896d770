"""The tensor- and sharding-parallel model wrappers
(``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``
analog).

The JAX package's arrays are born global, so its wrappers carry only the
API. Here every rank builds its own copy of the model, so the wrappers do
what the reference's do at wrap time (``hybrid_parallel_util``): every
parameter that the ranks of a group must hold alike is broadcast from the
group's first rank. ``TensorParallel`` broadcasts the replicated
parameters (those not split over mp) over the mp group and every
parameter over the dp and sharding groups; ``ShardingParallel`` every
parameter over the sharding and dp groups. The forward is the model's.
"""

from __future__ import annotations

import torch
from torch import nn

from ...communication import broadcast


def _broadcast(params, group):
    if group is None or group.nranks == 1:
        return
    with torch.no_grad():
        for p in params:
            broadcast(p.data, src=group.ranks[0], group=group)


class MetaParallelBase(nn.Module):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, sd, *args, **kwargs):
        return self._layers.load_state_dict(sd, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class TensorParallel(MetaParallelBase):
    """mp wrapper: the replicated parameters broadcast over the mp group,
    every parameter over the dp and sharding groups."""

    def _prepare_for_model(self):
        if self._hcg is None:
            return
        params = list(self._layers.parameters())
        _broadcast([p for p in params
                    if not getattr(p, "is_distributed", False)],
                   self._hcg.get_model_parallel_group())
        _broadcast(params, self._hcg.get_sharding_parallel_group())
        _broadcast(params, self._hcg.get_data_parallel_group())


class ShardingParallel(MetaParallelBase):
    """sharding wrapper: every parameter broadcast over the sharding and
    dp groups."""

    def _prepare_for_model(self):
        if self._hcg is None:
            return
        params = list(self._layers.parameters())
        _broadcast(params, self._hcg.get_sharding_parallel_group())
        _broadcast(params, self._hcg.get_data_parallel_group())
