"""Passkey-retrieval task generator (Peng et al., 2023 setup): the port of
``repro.data.passkey``.

A K-digit passkey is hidden at a random depth inside filler text; the
prompt ends with a query marker and the model must emit the digits.  The
token space is carved from the model's own vocab:

    [0, 10)          digit tokens
    MARK_OPEN/CLOSE  passkey delimiters
    QUERY            "what is the passkey?" marker
    [16, vocab)      filler (drawn from the bigram stream)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

from .pipeline import lm_tokens

MARK_OPEN, MARK_CLOSE, QUERY = 10, 11, 12
N_DIGITS = 3
RESERVED = 16


def make_passkey_batch(cfg: ModelConfig, B: int, S: int, *, seed: int = 0, step: int = 0,
                       depth: float | None = None, device="cuda") -> tuple[dict, torch.Tensor]:
    """(train-style batch over full sequences, answers [B, N_DIGITS]).

    Each row: [filler ... MARK_OPEN d0..d2 MARK_CLOSE ... filler QUERY
    d0..d2].  The loss mask covers only the positions predicting the
    answer digits, so one batch both trains and evaluates the task."""
    rng = np.random.default_rng(seed * 100003 + step)
    toks = lm_tokens(seed ^ 0xF1, step, B, S, cfg.vocab - RESERVED)[:, :S].numpy() + RESERVED
    answers = rng.integers(0, 10, (B, N_DIGITS))
    tail = N_DIGITS + 1  # QUERY + digits
    for b in range(B):
        if depth is None:
            pos = int(rng.integers(1, S - tail - N_DIGITS - 3))
        else:
            pos = max(1, min(int(depth * S), S - tail - N_DIGITS - 3))
        toks[b, pos] = MARK_OPEN
        toks[b, pos + 1:pos + 1 + N_DIGITS] = answers[b]
        toks[b, pos + 1 + N_DIGITS] = MARK_CLOSE
        toks[b, S - tail] = QUERY
        toks[b, S - N_DIGITS:] = answers[b]
    targets = np.concatenate([toks[:, 1:], toks[:, :1] * 0], axis=1)
    mask = np.zeros((B, S), np.float32)
    mask[:, S - tail:S - 1] = 1.0  # positions predicting the digits
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
    return ({"tokens": as_t(toks, torch.int32), "targets": as_t(targets, torch.int32),
             "loss_mask": as_t(mask, torch.float32)}, as_t(answers, torch.int32))


def passkey_answer_tokens(batch: dict) -> torch.Tensor:
    """Prompt prefix for generation eval: everything up to and incl. QUERY."""
    toks = batch["tokens"]
    return toks[:, : toks.shape[1] - N_DIGITS]
