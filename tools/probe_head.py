#!/usr/bin/env python3
"""Time ways of multiplying a decode step's hidden states by a bf16 LM head
in f32 on one GPU, at the two bf16-param configs' full heads.

    python3 tools/probe_head.py

command-r-plus-104b's tied head (the embedding [256000, 12288] read as its
transpose) and qwen3-moe-235b-a22b's untied one ([4096, 152064]), bf16, from
a seeded ``torch.Generator``; 4 hidden states in bf16.  Each way computes
``h.f32 @ W.f32``:

* ``whole``: the head cast to f32 whole, then one product (12.6 GB of f32
  for command-r);
* ``cols_<n>``: column chunks of n, each cast just before its product (what
  ``transformer._masked_logits`` does, n from its byte budget);
* ``rows_<n>``: the same chunks multiplied as ``(W_c.T.f32 @ h.T).T``, the
  head's rows as the product's left operand.

Each is timed with ``chip_smoke.Timer`` (CUDA events, L2 flushed; median of
5) in turns (the list, then the list reversed; the mean of the two), and its
largest difference from ``whole`` is printed as a fraction of max|logit|.
Prints one JSON line per head and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ways(torch, h, W, budget):
    hf = h.float()
    d, V = W.shape
    fit = budget // (4 * d)
    out = {"whole": lambda: hf @ W.float()}
    for n in sorted({fit, fit // 256 * 256, 16384}):
        out[f"cols_{n}"] = lambda n=n: torch.cat(
            [hf @ W[:, c:c + n].float() for c in range(0, V, n)], dim=-1)
        out[f"rows_{n}"] = lambda n=n: torch.cat(
            [(W[:, c:c + n].T.float() @ hf.T).T for c in range(0, V, n)], dim=-1)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_head: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads = {
        "command-r-plus-104b (tied)": lambda: torch.randn(
            (256000, 12288), generator=gen, device="cuda").mul_(12288**-0.5).to(torch.bfloat16).T,
        "qwen3-moe-235b-a22b (untied)": lambda: torch.randn(
            (4096, 152064), generator=gen, device="cuda").mul_(4096**-0.5).to(torch.bfloat16),
    }
    for name, make in heads.items():
        W = make()
        torch.cuda.empty_cache()
        d = W.shape[0]
        h = torch.randn((4, d), generator=gen, device="cuda").to(torch.bfloat16)
        fns = ways(torch, h, W, transformer.LOGIT_CHUNK_BYTES)
        ref = fns["whole"]()
        scale = float(ref.abs().max())
        gaps = {k: float((fn() - ref).abs().max()) / scale for k, fn in fns.items()}
        del ref
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(timer(fns[k], iters=5, warmup=1))
            torch.cuda.empty_cache()
        print(json.dumps({"head": name, "shape": list(W.shape), "ms": {
            k: sum(v) / len(v) for k, v in ms.items()}, "gap_of_max_logit": gaps}), flush=True)
        del W, fns
        torch.cuda.empty_cache()
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
