from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import Dropout, Embedding, LayerNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "Embedding",
           "LayerNorm"]
