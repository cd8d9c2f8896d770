"""The model-parallel RNG state tracker
(``paddle_tpu/distributed/fleet/meta_parallel/random.py`` analog).

The reference keeps named RNG states and swaps one in for a region, so
that dropout masks agree across mp ranks (the global stream) or differ (a
stream seeded per mp rank). The JAX package keeps a ``{seed, offset}``
state per name; here each name owns a ``torch.Generator`` on the device
(``device=``, default ``cuda``), and ``rng_state(name)`` makes it the
device's default generator inside the region, so every draw there comes
from it and advances it. ``model_parallel_random_seed(seed)`` seeds the
global streams with ``seed`` and a ``model_parallel_rng`` stream with
``seed + 1024 + mp_rank``.
"""

from __future__ import annotations

import contextlib

import torch

from ....device import resolve_device

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.random.default_generator


class RNGStatesTracker:
    """Named generators: ``add(name, seed)`` makes one (seeds and names
    unique), ``rng_state(name)`` draws from it for a region."""

    def __init__(self, *, device=None):
        self.states_ = {}
        self.seeds_ = set()
        self._device = device

    def reset(self):
        self.states_.clear()
        self.seeds_.clear()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        dev = resolve_device(self._device)
        self.states_[name] = torch.Generator(device=dev).manual_seed(
            int(seed))

    def get_states_tracker(self):
        """``{name: generator state}`` (byte tensors)."""
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        for name, st in states.items():
            if name not in self.states_:
                raise ValueError(f"state {name} does not exist")
            self.states_[name].set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        gen = self.states_[name]
        default = _default_generator(gen.device)
        orig = default.get_state()
        default.set_state(gen.get_state())
        try:
            yield
        finally:
            gen.set_state(default.get_state())
            default.set_state(orig)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed: int = None, *, device=None):
    """Seed the global streams with ``seed`` (1024 by default) and the
    tracker's ``model_parallel_rng`` stream, on ``device`` (default
    ``cuda``), with ``seed + 1024 + mp_rank``."""
    from ...topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    seed = seed if seed is not None else 1024
    _RNG_STATE_TRACKER._device = device
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
    torch.manual_seed(seed)


def determinate_seed(rng_name: str) -> int:
    """The reference's per-name seed lookup; the streams here are seeded
    once, so it is 0, as in the JAX package."""
    return 0
