"""``paddle_tpu.framework`` analog: save/load and auto-checkpointing
(``framework/random.py``'s RNG-state helpers come with the long tail,
ROADMAP queue A item A8)."""

from .io import (  # noqa: F401
    auto_checkpoint_step,
    disable_auto_checkpoint,
    enable_auto_checkpoint,
    load,
    load_sharded,
    save,
    save_async,
    save_sharded,
    wait_async_saves,
)

__all__ = ["auto_checkpoint_step", "disable_auto_checkpoint",
           "enable_auto_checkpoint", "load", "load_sharded", "save",
           "save_async", "save_sharded", "wait_async_saves"]
