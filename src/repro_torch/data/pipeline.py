"""Deterministic synthetic data pipeline: the port of
``repro.data.pipeline``, drawn from seeded ``torch.Generator``s (never
JAX's PRNG, so the port's streams are its own, with the reference's
properties):

* every batch is a pure function of ``(seed, step)``, so a run restarted
  from a step-k checkpoint sees step k+1's batch again and resumes bit for
  bit;
* process ``i`` of ``n`` draws stream position ``step·n + i``: disjoint
  slices of one logical global batch;
* the LM stream is a fixed random bigram chain per seed (each token has 8
  successors), so a small model can learn it;
* tokens lie in [0, vocab); the vlm and encdec batches carry the
  reference's extra inputs (vision embeddings with masked targets, audio
  frames) at its shapes and dtypes.

Batches are made on the CPU and moved to ``device`` (the card unless
``device="cpu"``).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig

BRANCH = 8
_MASK63 = (1 << 63) - 1


def _gen(*key: int) -> torch.Generator:
    """A CPU generator seeded from the integers of ``key`` (mixed, so
    nearby keys give unrelated streams)."""
    h = 0x9E3779B97F4A7C15
    for k in key:
        h = (h * 0x100000001B3 + (k & _MASK63) + 0x632BE59BD9B4E019) & _MASK63
    return torch.Generator().manual_seed(h)


def _bigram_table(seed: int, vocab: int) -> torch.Tensor:
    """Each token's ``BRANCH`` successors [vocab, BRANCH] (int64)."""
    return torch.randint(0, vocab, (vocab, BRANCH), generator=_gen(seed, 0xB16), dtype=torch.int64)


def lm_tokens(seed: int, step: int, B: int, S: int, vocab: int) -> torch.Tensor:
    """[B, S+1] int32 token stream from the seed's bigram chain (CPU)."""
    succ = _bigram_table(seed, vocab)
    g = _gen(seed ^ 0x5EED, step)
    toks = torch.empty((B, S + 1), dtype=torch.int64)
    toks[:, 0] = torch.randint(0, vocab, (B,), generator=g)
    choices = torch.randint(0, BRANCH, (B, S), generator=g)
    for i in range(S):
        toks[:, i + 1] = succ[toks[:, i], choices[:, i]]
    return toks.to(torch.int32)


def _normal_bf16(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen).to(torch.bfloat16)


def make_train_batch(
    cfg: ModelConfig,
    shape: ShapeConfig,
    step: int,
    *,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    batch_override: int | None = None,
    seq_override: int | None = None,
    device="cuda",
) -> dict:
    """Family-aware train batch {tokens, targets, loss_mask[, vision_embeds
    | frames]} on ``device``."""
    B = batch_override or shape.global_batch // process_count
    S = seq_override or shape.seq_len
    eff_step = step * process_count + process_index
    dev = resolve_device(device)

    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        St = S - nv
        stream = lm_tokens(seed, eff_step, B, St, cfg.vocab)
        vis = _normal_bf16(_gen(seed ^ 0xB1, eff_step), (B, nv, cfg.d_model))
        # targets over the whole (vision + text) sequence: position nv-1+i
        # predicts text token stream[i] (the last vision position predicts
        # the first text token); the other vision positions are masked
        targets = torch.zeros((B, S), dtype=torch.int32)
        targets[:, nv - 1:nv + St] = stream
        mask = torch.zeros((B, S), dtype=torch.float32)
        mask[:, nv - 1:nv + St] = 1.0
        batch = {"tokens": stream[:, :-1], "targets": targets, "loss_mask": mask,
                 "vision_embeds": vis}
    elif cfg.family == "encdec":
        stream = lm_tokens(seed, eff_step, B, S, cfg.vocab)
        frames = _normal_bf16(_gen(seed ^ 0xA7D10, eff_step), (B, cfg.enc_ctx, cfg.d_model))
        batch = {"frames": frames, "tokens": stream[:, :-1], "targets": stream[:, 1:],
                 "loss_mask": torch.ones((B, S), dtype=torch.float32)}
    else:
        stream = lm_tokens(seed, eff_step, B, S, cfg.vocab)
        batch = {"tokens": stream[:, :-1], "targets": stream[:, 1:],
                 "loss_mask": torch.ones((B, S), dtype=torch.float32)}
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def make_prefill_batch(cfg: ModelConfig, B: int, S: int, *, seed: int = 0,
                       length: int | None = None, device="cuda") -> dict:
    """Prefill batch (serving path) with uniform lengths, on ``device``."""
    stream = lm_tokens(seed, 0, B, S, cfg.vocab)[:, :S]
    lengths = torch.full((B,), length or S, dtype=torch.int32)
    batch = {"tokens": stream, "lengths": lengths}
    if cfg.family == "vlm":
        batch["vision_embeds"] = _normal_bf16(_gen(seed ^ 0xB2), (B, cfg.n_vision_tokens,
                                                                  cfg.d_model))
        batch["lengths"] = lengths + cfg.n_vision_tokens
    if cfg.family == "encdec":
        batch["frames"] = _normal_bf16(_gen(seed ^ 0xA7D11), (B, cfg.enc_ctx, cfg.d_model))
    dev = resolve_device(device)
    return {k: v.contiguous().to(dev) for k, v in batch.items()}
