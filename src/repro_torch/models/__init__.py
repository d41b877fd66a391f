"""Model zoo (dense transformer family in this slice)."""
from .model_zoo import build_model
from .transformer import ModelBundle

__all__ = ["ModelBundle", "build_model"]
