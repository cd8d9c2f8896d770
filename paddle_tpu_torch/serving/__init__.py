from .engine import Engine, EngineConfig, cached_generate
from .graphs import CapturedStep, PrefillBuffers, StepBuffers
from .kv_cache import (PAGE_SENTINEL, KVCache, PagedKVCache, decode_attend,
                       write_kv)
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import PageAllocator, Request, Scheduler
from .speculative import SpeculativeConfig, accept_greedy, propose_ngram

__all__ = ["Engine", "EngineConfig", "cached_generate", "CapturedStep",
           "PrefillBuffers", "StepBuffers", "PAGE_SENTINEL", "KVCache",
           "PagedKVCache", "decode_attend", "write_kv", "PrefixCache",
           "SamplingParams", "PageAllocator", "Request", "Scheduler",
           "SpeculativeConfig", "accept_greedy", "propose_ngram"]
