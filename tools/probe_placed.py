"""How far the placed tp2 x dp2 engine lies from the one-device engine on
the card, for each way of rounding the Megatron-parallel products.

    python3 tools/probe_placed.py

olmo-1b at full width (chip_smoke phase 4's weights and prompts, 8
teacher-forced decode steps) and granite-moe-1b-a400m (6 layers, phase
12(b)'s weights and prompts, 1 step), each served through
``Engine.build(mesh=tp2 x dp2)`` on params placed by ``param_shardings``
(``models/placed_serving.py``) and through the one-device paged engine.
A model shard's column block of a projection is formed either as the
f32 sum of its bf16 products rounded once or by a bf16 GEMM of the
block's width (``_col_part``); its row-parallel partial either in f32
(``_row_part``) or rounded to bf16 before the psum. Prints, per variant,
the prefill's and each step's max |Δlogit| × the one-device run's
max|logit|, and the seconds.  Needs a card.
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]


def gaps(torch, got, base, vocab):
    scale = float(base["logits"][..., :vocab].abs().max())
    steps = (got["logits"][..., :vocab] - base["logits"][..., :vocab]).abs().amax(dim=(1, 2))
    return {"prefill": float((got["pre"][:, :vocab] - base["pre"][:, :vocab]).abs().max()) / scale,
            "steps": [round(float(g) / scale, 6) for g in steps]}


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("probe_placed: no card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import placed_serving as ps
    from repro_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = cs.card_line()
    print(cs.CARD, flush=True)
    cs.build_kernels()
    cs.profile_decode = lambda *a, **k: None
    bf16 = lambda x, w: x @ w.to(x.dtype)
    f32_once = lambda x, w: (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    variants = {
        "col f32 sum once, row f32": (f32_once, ps._row_part),
        "col bf16 GEMM, row f32": (bf16, ps._row_part),
        "col f32 sum once, row bf16": (f32_once, bf16),
        "col bf16 GEMM, row bf16": (bf16, bf16),
    }
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    out = {}
    runs = (("olmo-1b", None, cs.PROMPTS, cs.SHARD_STEPS, 4),
            ("granite-moe-1b-a400m", cs.GRANITE_SHARD_LAYERS, cs.FAMILY_PROMPTS, 1, 9))
    for arch, layers, prompts, steps, seed in runs:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        bundle = Engine.build(cfg, n_slots=1, capacity=cs.CAPACITY, device="cuda").bundle
        params = bundle.compute_params(bundle.init(torch.Generator(device="cuda").manual_seed(0)))
        base = cs.sharded_drive(torch, cfg, params, None, prompts, steps, seed=seed, check=False,
                                timed=0)
        del base["eng"], base["cache"]
        placed = cs.placed_params(torch, params, mesh)
        col, row = ps._col_part, ps._row_part
        for name, (c, r) in variants.items():
            ps._col_part, ps._row_part = c, r
            t0 = time.perf_counter()
            try:
                got = cs.sharded_drive(torch, cfg, placed, mesh, prompts, steps, seed=seed,
                                       forced=base["toks"], check=False, timed=0)
            finally:
                ps._col_part, ps._row_part = col, row
            out[f"{arch}: {name}"] = dict(gaps(torch, got, base, cfg.vocab),
                                          seconds=round(time.perf_counter() - t0, 1))
            print(f"{arch}: {name}: {json.dumps(out[f'{arch}: {name}'])}", flush=True)
            del got
            cs.free(torch)
        del placed, params, base, bundle
        cs.free(torch)
    print(json.dumps({"card": cs.CARD, "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
