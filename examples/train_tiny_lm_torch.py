"""End-to-end training demo on the PyTorch/CUDA port, with fault
injection and recovery.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--device cpu] [--ckpt-dir DIR]

The port of ``examples/train_tiny_lm.py``: trains a reduced OLMo on the
deterministic bigram stream for 60 steps, crashes itself at steps 25 and
45 (injected), recovers from the checkpoints taken every 10 steps, and
checks that the loss went down: on held-out batches of the same stream,
the final checkpoint's loss against the initial weights' (the logged
per-step losses are each on another batch, and at this learning rate their
batch-to-batch spread is larger than 60 steps' progress).  The same entry
point trains at full size (``repro_torch.launch.train``).  The checkpoints go to a fresh temporary
directory, removed at exit, unless ``--ckpt-dir`` names one (a run resumes
from the newest checkpoint a given directory holds).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_train_batch
from repro_torch.launch import train
from repro_torch.launch.steps import TrainHParams, init_train_state
from repro_torch.models import build_model

SEED = 0  # the train CLI's default --seed
HELD_BATCHES = 4


def command(device="cuda", ckpt_dir="CKPT", steps: int = 60, fail_at=(25, 45),
            ckpt_every: int = 10, log_every: int = 10) -> list[str]:
    """The arguments of ``python -m repro_torch.launch.train`` for this demo."""
    return [
        "--arch", "olmo-1b", "--reduced",
        "--steps", str(steps), "--batch", "8", "--seq", "64",
        "--ckpt-every", str(ckpt_every), "--fail-at", *map(str, fail_at),
        "--ckpt-dir", ckpt_dir, "--log-every", str(log_every), "--device", device,
    ]


def run(argv: list[str]) -> dict:
    """Run the train CLI in this process on ``argv``, echoing its JSON
    lines; returns the final line with ``first_loss`` (step 0's) and
    ``last_loss`` (the last logged step's) added."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    for x in lines:
        print(json.dumps(x))
    steps = [x for x in lines if "loss" in x]
    return dict(lines[-1], first_loss=steps[0]["loss"], last_loss=steps[-1]["loss"])


def held_losses(device, ckpt_dir) -> tuple[float, float]:
    """The mean loss on HELD_BATCHES batches of the training stream that
    the 60 steps never see (steps 1000, 1001, ...), of the initial weights
    (the CLI's init at its seed, SEED) and of the newest checkpoint in
    ``ckpt_dir``: (before, after)."""
    dev = resolve_device(device)
    cfg = reduced_config("olmo-1b")
    bundle = build_model(cfg, None, device=dev)
    state = init_train_state(bundle, torch.Generator(device=dev).manual_seed(SEED),
                             TrainHParams())
    ckpt = CheckpointManager(ckpt_dir)
    final = ckpt.restore(ckpt.latest_step(), state)
    shape = ShapeConfig("cli", 64, 8, "train")
    batches = [make_train_batch(cfg, shape, 1000 + i, seed=SEED, device=dev)
               for i in range(HELD_BATCHES)]

    def loss(params):
        with torch.no_grad():
            return sum(float(bundle.train_loss(params, b)[0]) for b in batches) / len(batches)

    return loss(state["params"]), loss(final["params"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_example_ckpt_")
    cmd = command(args.device, ckpt_dir)
    print("running: python -m repro_torch.launch.train", " ".join(cmd))
    try:
        res = run(cmd)
        before, after = held_losses(args.device, ckpt_dir)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"restarts: {res['restarts']}; logged loss step 0 {res['first_loss']:.3f}, last "
          f"{res['last_loss']:.3f}; held-out loss {before:.4f} -> {after:.4f}")
    if not after < before:
        raise SystemExit("the held-out loss did not go down")


if __name__ == "__main__":
    main()
