"""``paddle.distributed.split``: an inline tensor-parallel linear or
embedding (``paddle_tpu/distributed/split_api.py`` analog).

Builds the matching mp layer (``VocabParallelEmbedding``,
``RowParallelLinear`` for ``axis=0``, ``ColumnParallelLinear`` for
``axis=1``) on the hybrid topology's mp group and applies it to ``x``; a
call with a ``name`` reuses the layer that name built. The layer is made
on ``x``'s device, with ``x``'s floating dtype.
"""

from __future__ import annotations

_SPLIT_CACHE = {}


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    from .fleet.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                RowParallelLinear,
                                                VocabParallelEmbedding)

    key = (name, operation, tuple(size), axis)
    layer = _SPLIT_CACHE.get(key) if name else None
    if layer is None:
        where = dict(device=x.device, dtype=x.dtype)
        if operation == "embedding":
            layer = VocabParallelEmbedding(size[0], size[1],
                                           weight_attr=weight_attr,
                                           device=x.device)
        elif operation == "linear" and axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False, **where)
        elif operation == "linear" and axis == 1:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out, **where)
        else:
            raise ValueError(f"unsupported split operation={operation!r} "
                             f"axis={axis}")
        if name:
            _SPLIT_CACHE[key] = layer
    return layer(x)
