from .common import Dropout, Embedding
from .norm import LayerNorm

__all__ = ["Dropout", "Embedding", "LayerNorm"]
