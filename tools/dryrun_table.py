"""Full-depth figures from the dry run's records at two cost depths.

    python tools/dryrun_table.py RECORDS.jsonl [MORE.jsonl ...]

Reads ``python -m repro_torch.launch.dryrun ... --cost-depth 1|2 --json``
records (one JSON object per line; ``--all --out`` writes such a file) and
prints, for each (arch, shape, mesh) with records at depths 1 and 2, a
markdown row extrapolated to the config's full depth the reference's way
(``repro/launch/specs.py``: two depths give the per-layer terms):
X(L) = X(a) + (L - a)·(X(b) - X(a)) / (b - a) for the busiest device's
argument bytes, FLOPs, bytes accessed and wire bytes by kind, and for a
train step's temporaries (remat keeps one input per layer).  The two
depths a < b are the smallest pair whose records name the same busiest
device (a device's per-layer terms extrapolate; two devices' do not).  A
serving step keeps nothing across layers: its temporaries peak within a
layer, at the switch between two (both layers' gathered weights alive) or
in the head, which depth b already shows, so its row takes depth b's.
Every depth is built with ``skip_layers=0`` and one microbatch, so the
rows describe that variant of the cell.  A record without a partner is
printed as it is, its depth named.
"""
from __future__ import annotations

import json
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def figures(rec: dict) -> dict:
    c = dict(rec["collectives"])
    c.setdefault("all-to-all", 0.0)  # records from before the prefill's K/V hand-off
    out = {"args": rec["argument_size_in_bytes"], "temp": rec["temp_size_in_bytes"],
           "flops": rec["flops"], "bytes": rec["bytes_accessed"], "other": c["other"],
           "trace_s": rec["trace_s"]}
    out.update({k: c[k] for k in KINDS})
    return out


def full_depth(arch: str) -> int:
    cfg = get_config(arch)
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def main(paths: list[str]) -> None:
    recs: dict = {}
    for path in paths:
        for line in open(path):
            if line.strip():
                r = json.loads(line)
                key = (r["arch"], r["shape"], r["mesh"])
                recs.setdefault(key, {})[r["cost_depth"]] = r
    print("| arch | shape | mesh | depth | args GB | temp GB | args+temp GB of 80 | "
          "TFLOP | bytes accessed GB | all-reduce GB | all-gather GB | reduce-scatter GB "
          "| all-to-all GB | other GB | trace s |")
    print("| --- " * 15 + "|")
    for (arch, shape, mesh), by_depth in sorted(recs.items()):
        depths = sorted(d for d in by_depth if d is not None)
        pairs = [(a, b) for i, a in enumerate(depths) for b in depths[i + 1:]
                 if by_depth[a]["busiest_device"] == by_depth[b]["busiest_device"]]
        if pairs:
            a, b = pairs[0]
            fa, fb = figures(by_depth[a]), figures(by_depth[b])
            L = full_depth(arch)
            f = {k: fa[k] + (L - a) * (fb[k] - fa[k]) / (b - a) for k in fa}
            if by_depth[b]["kind"] != "train":
                f["temp"] = fb["temp"]
            depth = f"{L} (from {a}, {b})"
            secs = f"{fa['trace_s']}, {fb['trace_s']}"
        else:
            d, r = next(iter(by_depth.items()))
            f, depth, secs = figures(r), f"{d or full_depth(arch)}", f"{r['trace_s']}"
        gb = lambda x: f"{x / 1e9:.3f}"
        print(f"| {arch} | {shape} | {mesh} | {depth} | {gb(f['args'])} | {gb(f['temp'])} | "
              f"{gb(f['args'] + f['temp'])} | {f['flops'] / 1e12:.3f} | {gb(f['bytes'])} | "
              f"{gb(f['all-reduce'])} | {gb(f['all-gather'])} | {gb(f['reduce-scatter'])} | "
              f"{gb(f['all-to-all'])} | {gb(f['other'])} | {secs} |")


if __name__ == "__main__":
    main(sys.argv[1:])
