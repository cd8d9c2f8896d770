from .engine import Engine, EngineConfig
from .graphs import CapturedStep, StepBuffers
from .kv_cache import PAGE_SENTINEL, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .scheduler import PageAllocator, Request, Scheduler
from .speculative import SpeculativeConfig, accept_greedy, propose_ngram

__all__ = ["Engine", "EngineConfig", "CapturedStep", "StepBuffers",
           "PAGE_SENTINEL", "PagedKVCache", "PrefixCache", "SamplingParams",
           "PageAllocator", "Request", "Scheduler", "SpeculativeConfig",
           "accept_greedy", "propose_ngram"]
