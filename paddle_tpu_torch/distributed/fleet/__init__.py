from . import meta_parallel
from .recompute import recompute, recompute_hybrid, recompute_sequential
from .utils import ShardedTrainStep, make_sharded_train_step

__all__ = ["meta_parallel", "recompute", "recompute_sequential",
           "recompute_hybrid", "ShardedTrainStep",
           "make_sharded_train_step"]
