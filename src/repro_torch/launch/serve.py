"""Serving entry point: ``python -m repro_torch.launch.serve --arch olmo-1b ...``

The port of ``repro.launch.serve`` (the card unless ``--device cpu``): the
engine and the continuous-batching scheduler over synthetic requests from
the data pipeline's stream, then one JSON line of throughput and
occupancy.  Policy full | fier | quest; ``--paged`` serves from the block
pool.  ``--model-axis N`` builds a local ("data", "model") mesh with a
model axis of N (``launch.mesh.make_local_mesh``: the visible cards, N
shards on one card when there are fewer); with ``--paged`` the pool is
sharded over it (``Engine.build(mesh=...)``: TP over KV heads × DP over
slots).  The reference's CLI builds the mesh but serves ``--paged`` on one
device; the port's sharded pool goes beyond it.  The slab layout runs on
one device, so ``--model-axis`` above 1 without ``--paged`` is refused.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import PolicyConfig
from repro_torch.data.pipeline import lm_tokens
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, Engine, Request, SamplingConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="fier", choices=["full", "fier", "quest"])
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="block-pool KV cache (prefix sharing + preemption)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="pool size in blocks; 0 = worst-case default")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.model_axis > 1 and not args.paged:
        raise ValueError(f"--model-axis {args.model_axis} shards the paged pool only: add "
                         "--paged (the slab layout serves on one device)")
    mesh = make_local_mesh(model_axis=args.model_axis, device=dev)
    layout = "paged" if args.paged else "slab"
    pol = None
    if args.policy != "full" and not cfg.attention_free:
        # paged fier serves through the one-pass kernels; slab keeps the
        # reference pipeline, as the reference's CLI does
        pol = PolicyConfig(
            kind=args.policy, budget=args.budget, group=args.group,
            skip_layers=1 if args.reduced else 2,
            pipeline="one_pass" if args.paged else "reference", layout=layout,
            block_size=args.block_size, pool_blocks=args.pool_blocks,
        )
    elif args.paged:
        pol = PolicyConfig(kind="full", layout="paged", block_size=args.block_size,
                           pool_blocks=args.pool_blocks)
    sampling = SamplingConfig(temperature=0.0)
    if args.paged and mesh.size > 1:
        eng = Engine.build(cfg, n_slots=args.slots, capacity=args.capacity, policy=pol,
                           sampling=sampling, mesh=mesh, device=dev,
                           max_positions=args.capacity)
        bundle = eng.bundle
    else:
        bundle = build_model(cfg, pol, device=dev, max_positions=args.capacity)
        eng = Engine(bundle, n_slots=args.slots, capacity=args.capacity, sampling=sampling)
    params = bundle.init(torch.Generator(device=dev).manual_seed(args.seed))

    sched = ContinuousScheduler(eng, eng.compute_params(params), pad_prompt_to=args.prompt_len)
    toks = lm_tokens(args.seed, 0, args.n_requests, args.prompt_len, cfg.vocab)
    reqs = [Request(rid=i, tokens=toks[i, :args.prompt_len].tolist(), max_new=args.max_new)
            for i in range(args.n_requests)]
    t0 = time.time()
    out = sched.run(reqs)
    wall = time.time() - t0
    total_tokens = sum(len(v) for v in out.values())
    report = {
        "arch": cfg.name, "policy": args.policy, "requests": len(reqs),
        "tokens": total_tokens, "wall_s": round(wall, 2),
        "tok_per_s": round(total_tokens / wall, 1),
        "decode_steps": sched.steps,
        "mean_occupancy": round(sched.mean_occupancy, 2),
        "mesh": dict(mesh.shape) if args.paged else None,
    }
    if args.paged:
        report.update(sched.engine.pool_stats(), preemptions=sched.preemptions)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
