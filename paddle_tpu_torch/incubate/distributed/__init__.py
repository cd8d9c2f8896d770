from . import models

__all__ = ["models"]
