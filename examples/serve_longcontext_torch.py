"""Serving demo on the PyTorch/CUDA port: continuous batching with
FIER-retrieval decode.

    PYTHONPATH=src python examples/serve_longcontext_torch.py [--device cpu]

The port of ``examples/serve_longcontext.py``: seven requests share four
engine slots; the scheduler admits and retires continuously while every
decode step runs FIER top-k attention over the 1-bit side-car (on the card,
the one-pass kernels K1/K2).  Prints per-request outputs and engine
utilisation.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.core.policy import PolicyConfig
from repro_torch.data.pipeline import lm_tokens
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, Engine, Request


def requests(vocab: int, n: int = 7) -> list[Request]:
    """Seven requests of 20, 22, ... tokens asking for 8, 9, ... tokens."""
    toks = lm_tokens(1, 0, n, 32, vocab)
    return [Request(rid=i, tokens=toks[i, : 20 + 2 * i].tolist(), max_new=8 + i)
            for i in range(n)]


def build(device="cuda", params=None):
    """(engine, params) of reduced llava-next-mistral-7b, its mistral-like
    backbone: 4 slots of 128 tokens.  pipeline="one_pass": the serving
    default — one-pass retrieval (scores never reach device memory) plus
    fused select-and-attend, no materialised K'/V' gather.  Other
    pipelines: "two_pass" (kernel ablation), "reference" (plain top-k);
    add layout="paged" for the block-pool cache."""
    dev = resolve_device(device)
    cfg = reduced_config("llava-next-mistral-7b")
    pol = PolicyConfig(kind="fier", budget=24, group=8, skip_layers=1, pipeline="one_pass")
    bundle = build_model(cfg, pol, device=dev)
    if params is None:
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    return Engine(bundle, n_slots=4, capacity=128), params


def run(device="cuda", reqs=None, params=None):
    """Serve ``reqs`` (default: :func:`requests`); returns (outputs by rid,
    the scheduler, wall seconds)."""
    engine, params = build(device, params)
    sched = ContinuousScheduler(engine, params, pad_prompt_to=32)
    reqs = requests(engine.bundle.cfg.vocab) if reqs is None else reqs
    t0 = time.time()
    outs = sched.run(reqs)
    wall = time.time() - t0
    for rid, out in sorted(outs.items()):
        print(f"req {rid}: {len(out)} tokens → {out}")
    total = sum(len(v) for v in outs.values())
    print(f"\n{total} tokens in {wall:.1f}s ({total / wall:.1f} tok/s), "
          f"decode steps={sched.steps}, mean slot occupancy="
          f"{sched.mean_occupancy:.2f}/{engine.n_slots}")
    return outs, sched, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
