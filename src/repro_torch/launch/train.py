"""Training entry point: ``python -m repro_torch.launch.train --arch olmo-1b ...``

The port of ``repro.launch.train`` (the card unless ``--device cpu``):
config → model → train step → deterministic data → checkpoint/restart
(fault-injectable) → one JSON line per logged step and one at the end.
``--model-axis N`` above 1 trains over ``make_local_mesh(N)`` — on one card
or the CPU the (1, N) grid, every shard on it — with the params and AdamW
moments placed by ``param_shardings`` / ``opt_shardings`` (Megatron TP over
'model', FSDP over 'data', EP for a MoE); recovery restores onto the mesh
(``runtime.reshard_tree`` as ``on_restore``).  A run given ``--ckpt-dir`` resumes
from the newest checkpoint there; without it (where the reference keeps a
fixed ``/tmp/repro_ckpt``) the checkpoints go to a fresh temporary
directory, removed at exit, so no run resumes from another's by accident.

    python -m repro_torch.launch.train --arch olmo-1b --reduced --device cpu \\
        --steps 20 --fail-at 7 --ckpt-dir CKPT [--model-axis 2]
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_train_batch
from repro_torch.launch import sharding as shard
from repro_torch.launch.mesh import batch_axes, fsdp_axes, make_local_mesh
from repro_torch.launch.steps import TrainHParams, init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.attention import DistConfig
from repro_torch.runtime import FaultInjector, StragglerMonitor, reshard_tree, run_with_recovery


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None, choices=[None, "cosine", "wsd"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; a run resumes from the newest checkpoint "
                         "it holds (default: a fresh temporary directory, removed at exit)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject faults at these steps (fault-tolerance demo)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    schedule = args.schedule or ("wsd" if "minicpm" in args.arch else "cosine")
    hp = TrainHParams(
        peak_lr=args.lr, warmup=max(args.steps // 10, 1), total_steps=args.steps,
        schedule=schedule, compress_grads=args.compress_grads,
    )
    max_pos = args.seq if cfg.family == "encdec" else None
    dcfg, on_restore = None, None
    if args.model_axis > 1:
        mesh = make_local_mesh(args.model_axis, device=dev)
        dcfg = DistConfig(
            mesh=mesh, batch_axes=batch_axes(mesh),
            ep_axis="model" if cfg.family == "moe" and mesh.shape["model"] > 1 else None,
        )
    bundle = build_model(cfg, None, dcfg, device=dev, max_positions=max_pos)
    train_step = make_train_step(bundle, hp)
    state = init_train_state(bundle, torch.Generator(device=dev).manual_seed(args.seed), hp)
    if dcfg is not None:
        params_sh = shard.param_shardings(state["params"], mesh,
                                          fsdp_axes(mesh, cfg.param_count() * 4))
        state_sh = {"params": params_sh,
                    "opt": shard.opt_shardings(state["opt"], params_sh, mesh)}
        if "ef" in state:
            state_sh["ef"] = params_sh
        state = reshard_tree(state, state_sh)
        on_restore = lambda st: reshard_tree(st, state_sh)  # noqa: E731
    shape = ShapeConfig("cli", args.seq, args.batch, "train")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep_n=2)
    injector = FaultInjector(args.fail_at)
    monitor = StragglerMonitor()
    t_start = time.time()

    def one_step(st, step):
        injector.maybe_fail(step)
        batch = make_train_batch(cfg, shape, step, seed=args.seed, device=dev)
        monitor.start()
        st, metrics = train_step(st, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = monitor.stop(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(json.dumps({"step": step, "dt_s": round(dt, 3), **m}), flush=True)
        return st

    try:
        state, stats = run_with_recovery(
            one_step, state, args.steps, ckpt, ckpt_every=args.ckpt_every, state_like=state,
            on_restore=on_restore,
        )
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(json.dumps({
        "done": True, "steps": args.steps, "wall_s": round(time.time() - t_start, 1),
        "restarts": stats["restarts"], "resumed_from": stats["resumed_from"],
        "straggler_events": len(monitor.events),
    }), flush=True)


if __name__ == "__main__":
    main()
