from . import meta_parallel
from .recompute import recompute
from .utils import ShardedTrainStep, make_sharded_train_step

__all__ = ["meta_parallel", "recompute", "ShardedTrainStep",
           "make_sharded_train_step"]
