"""``python -m paddle_tpu_torch.distributed.launch`` (the JAX package's
``distributed/launch`` analog, collective mode): one worker process per
rank on this host, each given the ``PADDLE_*`` environment that
``init_parallel_env`` reads."""

from .main import launch, main  # noqa: F401
