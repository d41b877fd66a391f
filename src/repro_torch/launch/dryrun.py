"""Multi-pod dry run: does every (arch × shape × mesh) cell build, shard
coherently and fit per device, what does each device compute, and what
does it send over the wire — all without a card (port of
``repro.launch.dryrun``).

The reference lowers and compiles its jitted step on 512 forced host
devices and reads XLA's ``memory_analysis`` and ``cost_analysis``.  The
port traces its own single-controller step on fake devices instead: the
cell (``launch.specs.build_cell``) is built under ``FakeTensorMode`` on
``launch.mesh.make_production_mesh``, its arguments placed piece by piece
on their shards' fake devices, and the step runs once under a
``launch.accounting.DeviceAccountant`` and ``core.distributed.recording``.
Nothing is allocated and no card is touched.

The record's figures, each for the busiest device (the one with the
highest peak; its index is ``busiest_device``):

* ``argument_size_in_bytes``: the placed arguments it holds.
* ``output_size_in_bytes``: the storages of the step's outputs on it (a
  decode step updates its cache in place, so these alias arguments).
* ``temp_size_in_bytes``: its peak of live storage minus the arguments;
  ``per_device_bytes`` is the peak itself (arguments + temporaries).
* ``flops``: ``FlopCounterMode``'s formulas over the ops whose output it
  holds.  ``bytes_accessed``: operand plus result bytes of those ops, an
  upper bound (eager fuses nothing).
* ``collectives``: per-chip wire bytes by kind from the collective record,
  by the reference's ring model (all-reduce 2·X·(n−1)/n, all-gather
  X_out·(n−1)/n, reduce-scatter X_out·(n−1)), with ``counts`` and
  ``total``; the backward's transposes are included.  ``other`` and
  ``other_count`` are the bytes and number of the cross-device copies no
  collective made (a replicated block read from the one shard that stores
  it, a data shard's activations handed to its model shards).
* ``peak_sum_bytes``: the peak over time of the live bytes of all devices.

The reference's ``generated_code_size_in_bytes`` and
``alias_size_in_bytes`` (XLA executables) and ``lower_s`` / ``compile_s``
have no meaning here; ``trace_s`` is the seconds the trace took.

Usage:
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--single-pod-only] --out results.jsonl
(--all fans each cell into a subprocess, one JSON record per line.)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

RING = {
    "all-reduce": lambda x, n: 2 * x * (n - 1) / n,
    "all-gather": lambda x, n: x * (n - 1) / n,
    "reduce-scatter": lambda x, n: x * (n - 1),
    "all-to-all": lambda x, n: x * (n - 1) / n,
    "collective-permute": lambda x, n: x,
}


def wire_bytes(entries, index) -> dict[int, dict]:
    """Per-device wire bytes by kind (``RING``) of a collective record's
    entries, each charged to its devices; ``index`` maps a device to its
    number."""
    out: dict[int, dict] = {}
    for kind, x, n, devices, _ in entries:
        w = RING[kind](x, n)
        for dev in devices:
            d = out.setdefault(index(dev), {"bytes": dict.fromkeys(RING, 0.0),
                                            "counts": dict.fromkeys(RING, 0)})
            d["bytes"][kind] += w
            d["counts"][kind] += 1
    return out


def trace(cell, accountant=None) -> dict:
    """Run ``cell``'s step once under the accountant (a
    ``DeviceAccountant``, or the class given) and the collective record
    (under the caller's ``FakeTensorMode`` for a dry run; on real tensors
    the same figures describe a real run).  Returns the per-device counters
    and the record."""
    from repro_torch.core import distributed as dist

    from .accounting import DeviceAccountant

    acc = (accountant or DeviceAccountant)(cell.mesh.devices)
    args = acc.hold(cell.args)
    with dist.recording() as rec, acc:
        out = cell.fn(*cell.args)
    outs = acc.storage_bytes(out)
    del out
    return {"acc": acc, "args": args, "outs": outs, "record": rec,
            "wire": wire_bytes(rec.entries, acc.dev)}


def record_of(t: dict) -> dict:
    """The reference's record fields from a :func:`trace`, for the busiest
    device."""
    acc = t["acc"]
    d = max(acc.peak, key=lambda i: (acc.peak[i], -i))
    wire = t["wire"].get(d, {"bytes": dict.fromkeys(RING, 0.0), "counts": dict.fromkeys(RING, 0)})
    coll = dict(wire["bytes"])
    coll["counts"] = dict(wire["counts"])
    coll["total"] = sum(wire["bytes"].values())
    coll["other"] = float(acc.other_in[d])
    coll["other_count"] = int(acc.other_count[d])
    dev = next((k for k, v in acc.index.items() if v == d), None)
    return {
        "busiest_device": d, "busiest_device_name": str(dev),
        "argument_size_in_bytes": int(t["args"][d]),
        "output_size_in_bytes": int(t["outs"][d]),
        "temp_size_in_bytes": int(acc.peak[d] - t["args"][d]),
        "per_device_bytes": int(acc.peak[d]),
        "flops": float(acc.flops[d]),
        "bytes_accessed": float(acc.bytes_accessed[d]),
        "collectives": coll,
        "peak_sum_bytes": int(acc.total_peak),
    }


def run_cell(arch: str, shape: str, *, multi_pod: bool, policy: str = "fier",
             budget: int = 4096, dist_mode: str = "local", verbose: bool = True,
             cost_depth: int | None = None, cost_depth_enc: int | None = None,
             flops_only: bool = False, strategy: str = "tp") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from .mesh import make_production_mesh
    from .specs import build_cell

    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {
        "arch": arch, "shape": shape, "policy": policy,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "devices": mesh.size, "multi_pod": multi_pod,
        "dist_mode": dist_mode, "budget": budget,
        "cost_depth": cost_depth, "cost_depth_enc": cost_depth_enc,
        "strategy": strategy,
    }
    t0 = time.time()
    fake = FakeTensorMode()
    # its dispatch cache misses on every shard's device and costs more than it
    # saves (a third of a trace's time)
    fake.cache_enabled = False
    with fake:
        cell = build_cell(arch, shape, mesh, policy_kind=policy, budget=budget,
                          dist_mode=dist_mode, cost_depth=cost_depth,
                          cost_depth_enc=cost_depth_enc, strategy=strategy)
        rec["kind"] = cell.kind
        if flops_only:
            with FlopCounterMode(display=False) as fc:
                cell.fn(*cell.args)
            rec["traced_flops_global"] = float(fc.get_total_flops())
            rec["traced_flops_per_device"] = rec["traced_flops_global"] / mesh.size
        else:
            rec.update(record_of(trace(cell)))
    rec["trace_s"] = round(time.time() - t0, 1)
    _finish_model_flops(rec, arch, shape, cell, mesh)
    if verbose:
        print(f"[dryrun] {arch} × {shape} ({cell.kind}) on {rec['mesh']}:")
        if flops_only:
            print(f"  flops: global={rec['traced_flops_global']:.3e} "
                  f"per-device={rec['traced_flops_per_device']:.3e}")
            return rec
        print(f"  memory: args={rec['argument_size_in_bytes']/1e9:.2f}GB "
              f"temp={rec['temp_size_in_bytes']/1e9:.2f}GB "
              f"out={rec['output_size_in_bytes']/1e9:.2f}GB "
              f"(device {rec['busiest_device']}, the busiest)")
        print(f"  cost: flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} (per device)")
        print("  collectives (wire bytes/chip): " +
              ", ".join(f"{k}={v:.2e}" for k, v in rec["collectives"].items()
                        if isinstance(v, float) and v > 0))
    return rec


def _finish_model_flops(rec, arch, shape, cell, mesh):
    """6·N_active·tokens (train; the 6 covers fwd+bwd) or 2·N·tokens
    (prefill/decode fwd-only)."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(arch)
    sh = SHAPES[shape]
    n_active = cfg.active_param_count()
    tokens = sh.global_batch * (sh.seq_len if cell.kind != "decode" else 1)
    mult = 6 if cell.kind == "train" else 2
    rec["model_flops_global"] = float(mult * n_active * tokens)
    rec["model_flops_per_device"] = rec["model_flops_global"] / mesh.size


def all_cells(multi_pod_too: bool = True):
    from repro_torch.configs import ARCHS, shape_cells

    for arch in ARCHS:
        for shape in shape_cells(arch):
            yield arch, shape, False
            if multi_pod_too:
                yield arch, shape, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default="fier", choices=["fier", "quest", "full"])
    ap.add_argument("--budget", type=int, default=4096)
    ap.add_argument("--dist-mode", default="local", choices=["local", "exact"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--json", action="store_true", help="print record as JSON line")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--cost-depth", type=int, default=None,
                    help="rebuild at this depth (microbatches 1, no skip layers)")
    ap.add_argument("--cost-depth-enc", type=int, default=None)
    ap.add_argument("--flops-only", action="store_true",
                    help="FlopCounterMode's count over the traced step only")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp_pure"])
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        sink = open(args.out, "a") if args.out else None
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {**os.environ, "PYTHONPATH": os.path.dirname(src)}
        for arch, shape, mp in all_cells(multi_pod_too=not args.single_pod_only):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--policy", args.policy, "--json",
                   "--budget", str(args.budget), "--dist-mode", args.dist_mode,
                   "--strategy", args.strategy]
            if mp:
                cmd.append("--multi-pod")
            if args.cost_depth is not None:
                cmd += ["--cost-depth", str(args.cost_depth)]
            if args.cost_depth_enc is not None:
                cmd += ["--cost-depth-enc", str(args.cost_depth_enc)]
            t0 = time.time()
            tag = f"{arch} × {shape} × {'2pod' if mp else '1pod'}"
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                                   env=env)
            except subprocess.TimeoutExpired:
                print(f"FAIL {tag}: timed out after {args.timeout} s", flush=True)
                failures.append(tag)
                continue
            dt = time.time() - t0
            if r.returncode == 0:
                line = r.stdout.strip().splitlines()[-1]
                print(f"PASS {tag} ({dt:.0f}s)", flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
            else:
                print(f"FAIL {tag} ({dt:.0f}s):\n{r.stderr[-2000:]}", flush=True)
                failures.append(tag)
        if sink:
            sink.close()
        print(f"\n{'ALL PASS' if not failures else f'{len(failures)} FAILURES'}")
        for f in failures:
            print(" -", f)
        return 1 if failures else 0

    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   policy=args.policy, budget=args.budget,
                   dist_mode=args.dist_mode, verbose=not args.json,
                   cost_depth=args.cost_depth, cost_depth_enc=args.cost_depth_enc,
                   flops_only=args.flops_only, strategy=args.strategy)
    if args.json:
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
