from .common import Dropout, Embedding
from .norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "RMSNorm"]
