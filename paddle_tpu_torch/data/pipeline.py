"""Composed pipeline: source -> packer -> batch feeder, ONE state
(``paddle_tpu/data/pipeline.py`` analog).

``DataPipeline`` ties the stages together and owns the composite
checkpoint state::

    {"version": 1, "epoch": e, "batches": n,
     "source": {...}, "packer": {...}}

which is exactly what ``TrainState.data_position`` stores. Saving it at
step k and restoring into a freshly-built pipeline replays the identical
packed-batch sequence from step k+1.

``build_pretrain_pipeline`` is the one-call constructor for the GPT
pretraining path: token shards -> per-process assignment -> packed
[B, S] -> batches on the device (``cuda`` unless ``device`` says
otherwise). In a data-parallel job each rank builds its own pipeline: the
files are dealt by the rank's dp index and world (the defaults of
``process_index``/``process_count`` once a group is initialised), and with
``mesh=`` the feeder records ``batch_sharding(mesh, batch_axes)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .feed import GlobalBatchFeeder, batch_sharding
from .packing import SequencePacker
from .protocol import CheckpointableIterator, iterator_state, restore_iterator
from .sources import JsonlSource, TokenBinSource

_STATE_VERSION = 1


class DataPipeline(CheckpointableIterator):
    """source (+ packer) (+ feeder), iterated as one object.

    Iteration yields the outermost stage's batches (device tensors when a
    feeder is attached, host numpy batches otherwise). ``get_state`` is
    positioned at the last batch the CONSUMER received even under
    prefetch — the feeder snapshots per batch (see feed.py).
    """

    def __init__(self, source, packer: Optional[SequencePacker] = None,
                 feeder: Optional[GlobalBatchFeeder] = None):
        self.source = source
        self.packer = packer
        self.feeder = feeder
        self._batches = 0
        if feeder is not None:
            # the feeder snapshots/ restores the WHOLE pipeline, not just
            # its immediate upstream
            feeder._state_of = self._stage_state
            feeder._restore_to = self._restore_stages

    # ---------------- composite state ----------------
    def _stage_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "version": _STATE_VERSION,
            "batches": self._batches,
        }
        src = iterator_state(self.source)
        if src is not None:
            state["source"] = src
            if "epoch" in src:
                state["epoch"] = src["epoch"]
        if self.packer is not None:
            state["packer"] = self.packer.get_state()
        return state

    def _restore_stages(self, state: Dict[str, Any]) -> None:
        if state.get("version", 1) != _STATE_VERSION:
            raise ValueError(
                f"data pipeline state version {state.get('version')!r} is "
                f"not {_STATE_VERSION}")
        self._batches = int(state.get("batches", 0))
        if "source" in state:
            restore_iterator(self.source, state["source"])
        if self.packer is not None and "packer" in state:
            self.packer.set_state(state["packer"])

    def get_state(self) -> Dict[str, Any]:
        if self.feeder is not None:
            return self.feeder.get_state()
        return self._stage_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        if self.feeder is not None:
            self.feeder.set_state(state)
        else:
            self._restore_stages(state)

    # ---------------- elastic re-assignment ----------------
    def reassign(self, process_index: int, process_count: int,
                 peer_progress=None) -> "DataPipeline":
        """Adopt a new fleet identity mid-epoch (elastic shrink/grow):
        delegates to the source's ``reassign`` (exactly-once coverage
        re-validated there). The packer's in-flight carry is kept — those
        records were already drawn from the old assignment. Restart
        iteration (``iter(pipeline)``) after reassigning: any prefetched
        batches in a live feeder generator belong to the old world."""
        if not hasattr(self.source, "reassign"):
            raise TypeError(
                f"source {type(self.source).__name__} does not support "
                "elastic reassignment")
        self.source.reassign(process_index, process_count,
                             peer_progress=peer_progress)
        return self

    def shard_progress(self):
        if not hasattr(self.source, "shard_progress"):
            return None
        return self.source.shard_progress()

    # ---------------- stats passthrough ----------------
    @property
    def packing_efficiency(self) -> float:
        return self.packer.efficiency if self.packer is not None else 1.0

    @property
    def host_wait_ms_mean(self) -> float:
        return (self.feeder.host_wait_ms_mean
                if self.feeder is not None else 0.0)

    # ---------------- iteration ----------------
    def __iter__(self):
        stage = self.feeder or self.packer or self.source
        for batch in stage:
            self._batches += 1
            yield batch

    def __next__(self):  # pragma: no cover - iterate via __iter__
        raise TypeError("iterate DataPipeline with iter(), not next() "
                        "(prefetch state lives in the generator)")


def build_pretrain_pipeline(
        files, batch_size: int, seq_len: int, *,
        source_format: str = "bin", dtype: str = "uint16",
        eos_id: Optional[int] = None, chunk_len: Optional[int] = None,
        seed: int = 0, process_index: Optional[int] = None,
        process_count: Optional[int] = None, shuffle_shards: bool = True,
        shuffle_records: bool = False, repeat: bool = True,
        pad_id: int = 0, split_long_docs: bool = False,
        mesh=None, batch_axes="dp", prefetch_depth: int = 2,
        device_feed: bool = True, device=None) -> DataPipeline:
    """Token shards -> packed, device-fed pipeline in one call.

    ``batch_size`` is the per-process batch: with a mesh over several
    ranks the global batch is ``batch_size`` times the dp world. Set
    ``device_feed=False`` for a host-only pipeline (numpy batches).
    """
    if source_format == "bin":
        source = TokenBinSource(
            files, dtype=dtype, eos_id=eos_id, chunk_len=chunk_len,
            seed=seed, process_index=process_index,
            process_count=process_count, shuffle_shards=shuffle_shards,
            shuffle_records=shuffle_records, repeat=repeat)
    elif source_format == "jsonl":
        source = JsonlSource(
            files, seed=seed, process_index=process_index,
            process_count=process_count, shuffle_shards=shuffle_shards,
            shuffle_records=shuffle_records, repeat=repeat)
    else:
        raise ValueError(f"unknown source_format {source_format!r} "
                         "(expected 'bin' or 'jsonl')")
    packer = SequencePacker(source, batch_size, seq_len, pad_id=pad_id,
                            split_long_docs=split_long_docs)
    feeder = None
    if device_feed:
        sharding = batch_sharding(mesh, batch_axes) if mesh is not None \
            else None
        feeder = GlobalBatchFeeder(packer, sharding=sharding,
                                   prefetch_depth=prefetch_depth,
                                   device=device)
    return DataPipeline(source, packer, feeder)
