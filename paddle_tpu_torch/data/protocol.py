"""Checkpointable-iterator protocol for the input pipeline
(``paddle_tpu/data/protocol.py`` analog, the same functions).

Every stage of the data pipeline (file-shard source, sequence packer,
device feeder, composed pipeline) implements the same two methods:

    get_state() -> dict      # JSON-plain: ints, strings, lists, dicts
    set_state(state) -> None # reposition so iteration resumes EXACTLY

The state a stage returns is everything needed to reproduce its future
output stream bit-for-bit: shard cursor + intra-shard offset + epoch for
sources, the partially-consumed document carry for the packer, the RNG
counter for anything stochastic. The composed pipeline state plugs
directly into ``TrainState.data_position`` and rides through
``checkpoint.CheckpointManager`` under the same atomic COMMIT as params
and optimizer state — a restored run continues the exact batch sequence
the interrupted one would have produced.

States are deliberately JSON-plain (no arrays) so they also survive the
pickle checkpoint path and manifest embedding without array-shard
machinery. ``mix_seed`` gives the JAX package's integers exactly: every
shuffle depends on it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class CheckpointableIterator:
    """Base protocol: an iterator whose position is checkpointable."""

    def __iter__(self):
        return self

    def __next__(self):
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    # paddle-idiom aliases (DataLoader/nn.Layer use state_dict naming)
    def state_dict(self) -> Dict[str, Any]:
        return self.get_state()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.set_state(state)


def iterator_state(obj) -> Optional[Dict[str, Any]]:
    """Best-effort state extraction from any pipeline-ish object: prefers
    the protocol's get_state, falls back to state_dict. None if the object
    carries no position (plain iterables)."""
    for name in ("get_state", "state_dict"):
        fn = getattr(obj, name, None)
        if callable(fn):
            try:
                return fn()
            except (TypeError, NotImplementedError):
                continue
    return None


def restore_iterator(obj, state) -> bool:
    """Counterpart of iterator_state: push `state` into obj via set_state /
    load_state_dict. Returns True if a restore method accepted it."""
    if state is None:
        return False
    for name in ("set_state", "load_state_dict"):
        fn = getattr(obj, name, None)
        if callable(fn):
            fn(state)
            return True
    return False


def mix_seed(*parts: int) -> int:
    """Deterministic seed mixing (splitmix64 finalizer) — decorrelates
    (seed, epoch, shard) tuples without the adjacent-seed correlation of
    plain addition. Pure function: resume recomputes the identical stream."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h ^= (int(p) + 0x9E3779B97F4A7C15 + (h << 6) + (h >> 2)) & 0xFFFFFFFFFFFFFFFF
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0xFFFFFFFF  # np.random.RandomState seed range
