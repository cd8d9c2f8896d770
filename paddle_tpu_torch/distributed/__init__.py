from . import fleet

__all__ = ["fleet"]
