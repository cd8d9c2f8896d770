"""``paddle_tpu.data`` analog: the deterministic input pipeline, one per
process (each rank of a data-parallel job reads its own files).

Stages, each a checkpointable iterator (``get_state``/``set_state``):

  sources   TokenBinSource / JsonlSource / TextLineSource — per-process
            file-shard readers with epoch-seeded deterministic shuffling
  packing   SequencePacker — greedy pack of ragged documents into static
            [B, S] token/segment-id/position buffers
  feed      GlobalBatchFeeder — batches (a rank's local rows) on the
            device, copied ahead of use through io.prefetch.DevicePrefetcher;
            batch_sharding — the batch's placement over a rank mesh
  pipeline  DataPipeline / build_pretrain_pipeline — composition whose
            single state dict plugs into TrainState.data_position for
            exact mid-epoch resume

Sources, packing and pipeline yield the JAX package's batches bit for bit
from the same files and seed.
"""

from .protocol import (  # noqa: F401
    CheckpointableIterator,
    iterator_state,
    mix_seed,
    restore_iterator,
)
from .sources import (  # noqa: F401
    CoverageError,
    JsonlSource,
    ShardedFileSource,
    TextLineSource,
    TokenBinSource,
    expand_files,
    shard_assignment,
    validate_coverage,
)
from .packing import SequencePacker  # noqa: F401
from .feed import GlobalBatchFeeder, batch_sharding  # noqa: F401
from .pipeline import DataPipeline, build_pretrain_pipeline  # noqa: F401

__all__ = [
    "CheckpointableIterator", "iterator_state", "restore_iterator",
    "mix_seed",
    "ShardedFileSource", "TokenBinSource", "JsonlSource", "TextLineSource",
    "expand_files", "shard_assignment", "validate_coverage", "CoverageError",
    "SequencePacker",
    "GlobalBatchFeeder", "batch_sharding",
    "DataPipeline", "build_pretrain_pipeline",
]
