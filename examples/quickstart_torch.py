"""Quickstart on the PyTorch/CUDA port: build an LM with FIER-retrieval
decode and generate text.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port of ``examples/quickstart.py``: config → model bundle (with a cache
policy) → prefill → decode loop, and the FIER output compared against
Full-KV on the same prompt.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.core.policy import PolicyConfig
from repro_torch.data.pipeline import lm_tokens
from repro_torch.models import build_model


def generate(bundle, params, prompt, n_new=12):
    """Greedy tokens [B, n_new] after prefilling ``prompt`` [B, S] int32."""
    B, S = prompt.shape
    pre = {"tokens": prompt, "lengths": torch.full((B,), S, dtype=torch.int32,
                                                   device=prompt.device)}
    # cache capacity must be a multiple of the FIER group (the 1-bit
    # side-car packs 8 tokens/byte, one (scale, zero) cell per group)
    cap = -(-(S + n_new) // 16) * 16
    logits, cache = bundle.prefill(params, pre, capacity=cap)
    out = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(n_new):
        out.append(tok)
        logits, cache = bundle.decode_step(params, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(out, 1)


def bundles(cfg, device):
    """FIER (1-bit quantized key retrieval, token budget 16, group size 8)
    and Full-KV bundles.  pipeline="reference" is the plain top-k + gather
    pipeline (easy to read and step through; it runs no custom kernel);
    serving uses pipeline="one_pass", the CUDA kernels (see
    examples/serve_longcontext_torch.py)."""
    fier = PolicyConfig(kind="fier", budget=16, group=8, skip_layers=1,
                        pipeline="reference")
    return (build_model(cfg, fier, device=device),
            build_model(cfg, PolicyConfig(kind="full"), device=device))


def run(device="cuda", prompt=None, params=None):
    """Full-KV and FIER greedy tokens on one prompt: (full, fier, agreement).
    ``prompt`` [B, S] defaults to two 48-token rows of the data pipeline's
    stream; ``params`` to a seeded init."""
    dev = resolve_device(device)
    cfg = reduced_config("olmo-1b")
    print(f"model: {cfg.name} (reduced) — {cfg.n_layers}L d={cfg.d_model}")
    bundle_fier, bundle_full = bundles(cfg, dev)
    if params is None:
        params = bundle_fier.init(torch.Generator(device=dev).manual_seed(0))
    if prompt is None:
        prompt = lm_tokens(0, 0, 2, 48, cfg.vocab)[:, :48]
    prompt = prompt.to(dev)

    out_full = generate(bundle_full, params, prompt)
    out_fier = generate(bundle_fier, params, prompt)
    agree = float((out_full == out_fier).float().mean())
    S = prompt.shape[1]
    print("full-KV :", out_full[0].tolist())
    print("fier    :", out_fier[0].tolist())
    print(f"greedy agreement at {16 / S:.0%} budget: {agree:.0%}")
    print("(random init — examples/passkey_demo_torch.py trains a model first)")
    return out_full, out_fier, agree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
