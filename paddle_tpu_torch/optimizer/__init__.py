from . import lr
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["lr", "Optimizer", "Adam", "AdamW"]
