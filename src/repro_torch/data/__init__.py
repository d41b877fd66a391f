"""Deterministic synthetic data: the port of ``repro.data``."""
from .passkey import make_passkey_batch, passkey_answer_tokens
from .pipeline import lm_tokens, make_prefill_batch, make_train_batch

__all__ = [
    "lm_tokens",
    "make_passkey_batch",
    "make_prefill_batch",
    "make_train_batch",
    "passkey_answer_tokens",
]
