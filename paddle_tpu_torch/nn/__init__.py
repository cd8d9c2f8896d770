from . import functional
from .layer import Dropout, Embedding, LayerNorm

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm"]
