"""Resharding (``paddle_tpu/distributed/resharding`` analog): moves of a
sharded array from one ``NamedSharding`` to another.

The planner (``planner.py``, pure Python, the JAX package's own plans)
decomposes a move into all_gather / all_to_all / dynamic_slice / ppermute
steps per refined mesh axis; the executor (``executor.py``) replays them
on ``torch.distributed`` groups over the ranks, each rank moving its
block (a ``ShardedTensor``), bitwise the global array's slice. Consumed by
the checkpoint's restore onto another layout (``restore(shardings=,
live_state=)``), the train step's ``restore_from_checkpoint`` and the
serving engine's ``load_weights``; ``gather``/``gather_tree`` are the
explicit, counted way to a whole array.
"""

from .spec import (MeshSpec, ShardingSpec, Unplannable,  # noqa: F401
                   shard_index_map)
from .planner import (ReshardPlan, ReshardStep, describe,  # noqa: F401
                      plan_as_dict, plan_reshard, plan_sends)
from .executor import (SegmentedPlan, ShardedTensor,  # noqa: F401
                       block_of, block_pieces, clear_caches,
                       from_named_sharding, gather, gather_tree,
                       plan_for, reset_stats, reshard, reshard_tree, stats)
