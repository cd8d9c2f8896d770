from . import mp_ops  # noqa: F401
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pipeline_parallel import (PipelineParallel,
                                PipelineParallelWithInterleave, PipelineSpec,
                                pipeline_schedule, pipeline_schedule_1f1b,
                                pipeline_schedule_interleaved,
                                pipeline_schedule_interleaved_1f1b,
                                spmd_pipeline, stack_block_params,
                                unstack_block_params)
from .pp_layers import (LayerDesc, PipelineLayer, SegmentLayers,
                        SharedLayerDesc)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
from .sharding import (GroupShardedOptimizerStage2, GroupShardedStage2,
                       GroupShardedStage3, group_sharded_parallel,
                       save_group_sharded_model)
from .tensor_parallel import (MetaParallelBase, ShardingParallel,
                              TensorParallel)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "mp_ops",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model",
           "MetaParallelBase", "TensorParallel", "ShardingParallel",
           "PipelineParallel", "PipelineParallelWithInterleave",
           "PipelineSpec", "pipeline_schedule", "pipeline_schedule_1f1b",
           "pipeline_schedule_interleaved",
           "pipeline_schedule_interleaved_1f1b", "spmd_pipeline",
           "stack_block_params", "unstack_block_params", "LayerDesc",
           "PipelineLayer", "SegmentLayers", "SharedLayerDesc"]
