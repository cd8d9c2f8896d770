from .engine import Engine, EngineConfig
from .kv_cache import PAGE_SENTINEL, PagedKVCache
from .sampling import SamplingParams
from .scheduler import PageAllocator, Request, Scheduler

__all__ = ["Engine", "EngineConfig", "PAGE_SENTINEL", "PagedKVCache",
           "SamplingParams", "PageAllocator", "Request", "Scheduler"]
