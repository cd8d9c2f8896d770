"""``paddle_tpu.checkpoint`` analog: checkpoints in the JAX package's
on-disk format, saved by one process or by every rank of a
data-parallel job.

    from paddle_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager("/ckpts/run1", keep_last_n=3)   # async
    mgr.save(step, train_step.state_for_checkpoint().to_tree())
    ...
    tree = mgr.restore()                      # latest committed step
    train_step.restore_from_checkpoint(tree)  # bitwise resume

A step either package saved restores in the other (``arrays.py``).
"""

from . import arrays, async_writer, manager, train_state  # noqa: F401
from .arrays import (load_tree, merge_manifests, restore_array,  # noqa: F401
                     save_tree)
from .async_writer import AsyncCheckpointError, AsyncWriter  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
from .train_state import TrainState, is_train_state_tree  # noqa: F401

__all__ = [
    "CheckpointManager", "TrainState", "is_train_state_tree",
    "AsyncWriter", "AsyncCheckpointError",
    "save_tree", "load_tree", "restore_array", "merge_manifests",
]
