"""Model zoo (the transformer families dense, moe and vlm)."""
from .model_zoo import build_model
from .transformer import ModelBundle

__all__ = ["ModelBundle", "build_model"]
