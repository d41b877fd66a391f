#!/usr/bin/env python3
"""Does a Mamba2 decode step give a row the same bits when it runs with
fewer rows?  The mesh decode steps each batch shard's rows alone
(``models.mamba2.decode_layer``); this probe runs the state update
``mamba2._state_step`` at mamba2-370m's width over 4 rows and over the two
halves of them, and each of its three contractions alone, on seeded inputs.

    python3 tools/probe_mamba_rows.py [--device cpu]

For each it prints how many elements differ between the whole and the
halves and the largest difference, as one JSON line, then the card's name
and power limit (``nvidia-smi``; "cpu" with ``--device cpu``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(torch, whole, halves) -> dict:
    parts = torch.cat(halves, dim=0)
    diff = (whole.float() - parts.float()).abs()
    return {"differ": int((whole != parts).sum()), "of": whole.numel(),
            "max_abs": float(diff.max()), "max_abs_whole": float(whole.float().abs().max())}


def main() -> int:
    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2

    dev = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-370m")
    B, H, Pd, N, K = 4, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_kernel
    ch = mamba2.conv_dim(cfg)
    g = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    p = {"conv_w": rnd(K, ch) * K**-0.5, "conv_b": rnd(ch) * 0.1, "dt_bias": rnd(H) * 0.1,
         "A_log": torch.log(torch.rand((H,), generator=g, device=dev) * 15 + 1),
         "D": torch.ones((H,), device=dev)}
    xBC, dt_raw = rnd(B, ch).to(torch.bfloat16), rnd(B, H).to(torch.bfloat16)
    conv, ssm = rnd(B, K - 1, ch).to(torch.bfloat16), rnd(B, H, Pd, N)
    halves = (slice(0, B // 2), slice(B // 2, B))

    step = lambda r: mamba2._state_step(xBC[r], dt_raw[r], p, conv[r], ssm[r], cfg)
    whole = step(slice(None))
    parts = [step(r) for r in halves]
    out = {name: compare(torch, whole[i], [q[i] for q in parts])
           for i, name in enumerate(("y", "conv", "ssm"))}
    # the three contractions alone, on the step's own operand shapes
    window = torch.cat([conv, xBC[:, None]], dim=1).float()
    Bm, Cm = rnd(B, N), rnd(B, N)
    dt, xs = rnd(B, H).abs(), rnd(B, H, Pd)
    ops = {
        "conv bkc,kc->bc": lambda r: torch.einsum("bkc,kc->bc", window[r], p["conv_w"]),
        "update bh,bn,bhp->bhpn": lambda r: torch.einsum("bh,bn,bhp->bhpn", dt[r], Bm[r], xs[r]),
        "readout bn,bhpn->bhp": lambda r: torch.einsum("bn,bhpn->bhp", Cm[r], ssm[r]),
    }
    for name, fn in ops.items():
        out[name] = compare(torch, fn(slice(None)), [fn(r) for r in halves])
    print(json.dumps({"device": dev, "rows": B, "halves": B // 2, **out}), flush=True)
    if dev == "cpu":
        print("cpu")
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
