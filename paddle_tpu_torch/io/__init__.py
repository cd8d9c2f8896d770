"""``paddle_tpu.io`` analog: so far the device prefetcher that the data
pipeline's feeder stands on. The DataLoader, datasets and samplers come
with the long tail of the API (ROADMAP queue A item A8)."""

from .prefetch import DevicePrefetcher, prefetch_to_device  # noqa: F401

__all__ = ["DevicePrefetcher", "prefetch_to_device"]
