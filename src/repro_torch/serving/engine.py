"""Serving engine: prefill/decode around a ModelBundle, with slot-based
continuous batching support (port of ``repro.serving.engine`` for the
slab layout).

The default serving policy (``serving_policy`` / ``Engine.build``) is the
one-pass FIER pipeline: the CUDA retrieval kernel (1-bit score scan +
group-reduce + masking + exact radix threshold top-k, per-token scores
never in device memory) chained into the CUDA select-and-attend kernel
(rows gathered in-kernel, no K'/V' copies).

The cache lives on the engine's device and is updated in place by
``decode`` / ``insert``: the cache a call returns aliases the one it was
given.  ``insert`` prefills one request (B=1) and copies its cache into
one slot of the batched cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PolicyConfig
from repro_torch.models.model_zoo import ModelBundle, build_model


def serving_policy(
    budget: int = 1024,
    group: int = 32,
    *,
    skip_layers: int = 2,
    sink: int = 4,
    recent: int = 64,
    pipeline: str = "one_pass",
    layout: str = "slab",
) -> PolicyConfig:
    """The serving-default FIER policy: the ``one_pass`` pipeline with the
    standard sink/recent guard-rails.  ``pipeline='reference'`` is the
    plain top-k + gather oracle, which runs no custom kernel."""
    return PolicyConfig(
        kind="fier", budget=budget, group=group, skip_layers=skip_layers,
        sink=sink, recent=recent, pipeline=pipeline, layout=layout,
    )


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → no truncation


def sample_token(
    logits: torch.Tensor, cfg: SamplingConfig, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Greedy argmax (first maximum) or temperature/top-k sampling drawn
    from ``generator``.  logits [B, V] → int32 [B]."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32) / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class Engine:
    """Batched generation engine with continuous-batching slot management."""

    def __init__(
        self,
        bundle: ModelBundle,
        *,
        n_slots: int,
        capacity: int,
        sampling: SamplingConfig = SamplingConfig(),
        seed: int = 0,
    ):
        self.bundle = bundle
        self.device = bundle.device
        self.n_slots = n_slots
        self.capacity = capacity
        self.sampling = sampling
        # sampling generator: each decode call draws fresh numbers from it
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        pol = bundle.policy
        if pol is not None and pol.layout != "slab":
            raise NotImplementedError(
                "the paged engine is not ported yet (ROADMAP Queue 1 item 6)"
            )
        if bundle.plan is not None:
            bundle.plan.validate_capacity(capacity)

    @classmethod
    def build(
        cls,
        cfg,
        *,
        n_slots: int,
        capacity: int,
        policy: PolicyConfig | None = None,
        sampling: SamplingConfig = SamplingConfig(),
        layout: str | None = None,
        mesh=None,
        device="cuda",
        seed: int = 0,
    ) -> "Engine":
        """Build bundle + engine with the serving defaults: when ``policy``
        is None the one-pass FIER fast path (``serving_policy()``) with the
        budget clamped to ``capacity``.  ``device`` defaults to CUDA; a
        machine without a card raises unless ``device='cpu'`` is passed."""
        dev = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded serving is not ported yet (ROADMAP Queue 1 item 10)"
            )
        if policy is not None:
            pol = policy
        else:
            base = serving_policy()
            pol = dataclasses.replace(base, budget=min(base.budget, capacity))
        if layout is not None and layout != pol.layout:
            raise NotImplementedError(
                f"layout={layout!r} is not ported yet (ROADMAP Queue 1 item 6)"
            )
        bundle = build_model(cfg, pol, device=dev)
        return cls(bundle, n_slots=n_slots, capacity=capacity, sampling=sampling,
                   seed=seed)

    # ------------------------------------------------------------ lifecycle
    def compute_params(self, params: dict) -> dict:
        """Params with one bf16 copy of each layer weight, so calls stop
        casting them (the numbers do not change)."""
        return self.bundle.compute_params(params)

    def new_cache(self, length: int = 0) -> dict:
        return self.bundle.init_cache(self.n_slots, self.capacity, length)

    def prefill_batch(self, params, batch):
        """Whole-batch prefill: (logits [B, Vp], cache of B slots)."""
        return self.bundle.prefill(params, batch, capacity=self.capacity)

    def insert(self, params, batched_cache, tokens_1xS, length: int, slot: int):
        """Prefill one request and place it into ``slot``.  Returns (its
        first-token logits [1, Vp], the batched cache, updated in place)."""
        batch = {
            "tokens": tokens_1xS,
            "lengths": torch.tensor([length], dtype=torch.int32, device=self.device),
        }
        logits, single = self.bundle.prefill(params, batch, capacity=self.capacity)
        for part in ("front", "rest"):
            dst, src = batched_cache[part], single[part]
            for name in ("k", "v"):
                dst[name][:, slot] = src[name][:, 0]
            if "meta" in dst:
                for name in ("codes", "scale", "zero"):
                    getattr(dst["meta"], name)[:, slot] = getattr(src["meta"], name)[:, 0]
        batched_cache["length"][slot] = length
        return logits, batched_cache

    def decode(self, params, tokens, cache, active=None, generator=None):
        """One decode step for all slots; inactive slots don't advance
        (their cache writes land beyond their length, where the next
        insert overwrites them).  tokens [n_slots] → (next_tokens
        [n_slots] int32, logits, cache)."""
        old_len = cache["length"]
        logits, new_cache = self.bundle.decode_step(params, tokens, cache)
        if active is not None:
            new_cache["length"] = torch.where(active, new_cache["length"], old_len)
        nxt = sample_token(logits, self.sampling, generator or self._gen)
        return nxt, logits, new_cache

    # --------------------------------------------------------- conveniences
    def generate(
        self, params, prompts: torch.Tensor, lengths: torch.Tensor, max_new: int,
        generator: torch.Generator | None = None, return_cache: bool = False,
    ):
        """Static-batch generate: prefill the whole batch then decode
        ``max_new - 1`` steps.  prompts [B, S]; returns tokens [B, max_new]
        (and the cache, when ``return_cache``, for continuing the session)."""
        gen = generator or self._gen
        logits, cache = self.prefill_batch(params, {"tokens": prompts, "lengths": lengths})
        tok = sample_token(logits, self.sampling, gen)
        outs = [tok]
        for _ in range(max_new - 1):
            tok, _, cache = self.decode(params, tok, cache, generator=gen)
            outs.append(tok)
        toks = torch.stack(outs, dim=1)
        return (toks, cache) if return_cache else toks
