"""The paper's headline contrast on the PyTorch/CUDA port, live: eviction
forgets, retrieval recalls.

    PYTHONPATH=src python examples/passkey_demo_torch.py [--device cpu] [--steps 600]

The port of ``examples/passkey_demo.py``.  Trains a small LM on the passkey
task (cached after the first run under ``$REPRO_TORCH_EXAMPLE_CACHE``, by
default a directory in the temp dir), hides a 3-digit key inside filler
context, then decodes the answer under four cache policies at the same
tiny budget:

    full             — every cached token
    SLM  (eviction)  — sink+recent only: the passkey tokens are long gone
    Quest (pages)    — page min/max retrieval
    FIER (this repo) — token-level 1-bit retrieval

The benchmark model, its passkey training and the policy bundles are
copies of ``benchmarks/common.py``'s (which imports JAX) on the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.core.policy import PolicyConfig
from repro_torch.data.passkey import N_DIGITS, make_passkey_batch
from repro_torch.launch.steps import TrainHParams, init_train_state, make_train_step
from repro_torch.models import build_model

CACHE_DIR = os.environ.get("REPRO_TORCH_EXAMPLE_CACHE",
                           os.path.join(tempfile.gettempdir(), "repro_torch_example_cache"))
SEQ, BUDGET = 256, 32
# the benchmark's training run and policies (benchmarks/common.py's defaults)
BATCH, SEED = 16, 0
GROUP, PAGE, SKIP, PIPELINE = 8, 8, 1, "reference"
CAPACITY = SEQ + 8
POLICIES = ("full", "slm", "quest", "fier")


def bench_model_cfg():
    """The benchmark LM: big enough to learn the task, small enough for a CPU."""
    return dataclasses.replace(
        reduced_config("olmo-1b"),
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256, vocab=512,
    )


def train_tiny_lm(device="cuda", steps: int = 600, cache_dir: str | None = CACHE_DIR):
    """Train (or load cached) the benchmark model on the passkey curriculum:
    AdamW, peak lr 1e-3, 20 warmup steps, BATCH sequences of SEQ tokens.
    ``cache_dir`` None trains without reading or writing a cache.  Returns
    (cfg, params)."""
    dev = resolve_device(device)
    cfg = bench_model_cfg()
    path = None
    if cache_dir is not None:
        tag = f"passkey_s{steps}_q{SEQ}_b{BATCH}_{SEED}_{dev.type}"
        path = os.path.join(cache_dir, f"params_{tag}.pt")
        if os.path.exists(path):
            return cfg, torch.load(path, map_location=dev)
    bundle = build_model(cfg, device=dev)
    hp = TrainHParams(peak_lr=1e-3, warmup=20, total_steps=steps)
    state = init_train_state(bundle, torch.Generator(device=dev).manual_seed(SEED), hp)
    step_fn = make_train_step(bundle, hp)
    for s in range(steps):
        data, _ = make_passkey_batch(cfg, BATCH, SEQ, seed=SEED, step=s, device=dev)
        state, metrics = step_fn(state, data)
        if s % 100 == 0:
            print(f"  [passkey] step {s}: loss={float(metrics['loss']):.3f}")
    params = state["params"]
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        torch.save(params, path)
    return cfg, params


def policy_bundle(cfg, kind: str, device):
    """The model under cache policy ``kind`` at BUDGET (``full``: no policy)."""
    pol = None if kind == "full" else PolicyConfig(
        kind=kind, budget=BUDGET, group=GROUP, page=PAGE, skip_layers=SKIP,
        pipeline=PIPELINE,
    )
    return build_model(cfg, pol, device=device)


def answer(bundle, params, prompt):
    """The N_DIGITS greedy digits [B, N_DIGITS] after ``prompt`` [B, S]."""
    B = prompt.shape[0]
    pre = {"tokens": prompt, "lengths": torch.full((B,), prompt.shape[1], dtype=torch.int32,
                                                   device=prompt.device)}
    logits, cache = bundle.prefill(params, pre, capacity=CAPACITY)
    digs = []
    for _ in range(N_DIGITS):
        tok = torch.argmax(logits[:, :10], dim=-1).to(torch.int32)
        digs.append(tok)
        logits, cache = bundle.decode_step(params, tok, cache)
    return torch.stack(digs, 1)


def evaluate(cfg, params, device="cuda"):
    """Each policy's batch accuracy on 4 passkeys at 30% depth: {kind:
    (digits [4, N_DIGITS], accuracy)}."""
    dev = resolve_device(device)
    batch, answers = make_passkey_batch(cfg, 4, SEQ, seed=7, step=0, depth=0.3, device=dev)
    prompt = batch["tokens"][:, : SEQ - N_DIGITS]
    print(f"context={SEQ} tokens, budget={BUDGET} ({BUDGET / SEQ:.0%}), "
          f"passkey at 30% depth\n")
    out = {}
    for kind in POLICIES:
        got = answer(policy_bundle(cfg, kind, dev), params, prompt)
        acc = float((got == answers).all(1).float().mean())
        print(f"{kind:6s}: answered {got[0].tolist()} "
              f"(true {answers[0].tolist()}) — batch acc {acc:.0%}")
        out[kind] = (got, acc)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=600)
    args = ap.parse_args(argv)
    cfg, params = train_tiny_lm(args.device, steps=args.steps)
    evaluate(cfg, params, args.device)


if __name__ == "__main__":
    main()
