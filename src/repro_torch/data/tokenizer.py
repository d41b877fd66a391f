"""Byte-level tokenizer for demos and chat-style examples (a copy of
``repro.data.tokenizer``: pure Python).

Vocabulary = 256 raw bytes + a handful of specials.  Enough to drive the
serving engine with real text without external assets; models trained on
the synthetic streams use their own id spaces.
"""
from __future__ import annotations

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
    ids = list(text.encode("utf-8"))
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return ids


def decode(ids: list[int]) -> str:
    return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")
