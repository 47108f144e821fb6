"""AdamW (the port of `repro.optim`)."""
from . import adamw

__all__ = ["adamw"]
