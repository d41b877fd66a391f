#!/usr/bin/env python3
"""Hold the CUDA kernels of this checkout to the same kernels built from
another source directory, on one GPU: bit for bit at every fixed
instantiation, and timed in turns at the main path's shape.

    python3 tools/compare_kernels.py OTHER_CSRC_DIR

``OTHER_CSRC_DIR`` holds an earlier ``src/repro_torch/kernels/csrc`` (e.g.
unpacked with ``git archive <commit> src/repro_torch/kernels/csrc``) whose
C interfaces match this checkout's.  On the same inputs (made on the card
from seeded ``torch.Generator``s) the two builds of K1/K3 (idx, τ, m), K6
(scores), K2/K4/K8 (outputs) and K5 (codes, scale, zero) must agree bit for
bit at every (d_head, rep) the earlier kernels were instantiated for: K1,
K3 and K6 at d_head 16, 32, 64, 112 and 128 and reps 1, 2, 4, 8, 12 and 16
(group max and sum; g 32 at S 8192 and g 8 at S 264), K2/K4/K8 at
``sparse_attention.KERNEL_REPS`` at each d_head and rep 1 at 112 (budgets
1024 and 1000), K5 at each d_head.  Then each kernel of both builds is timed
in turns (old, new, new, old; ``chip_smoke.Timer``, L2 flushed) at the
main path's shape (B 4, Hkv 16, rep 1, D 128, S 8192, g 32, budget 1024,
bs 32) and at the GQA shape (Hkv 4, rep 4, the group sum).  Prints one line
per comparison, the card's name and power limit, and exits non-zero on the
first difference.
"""
from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

HEADS = (16, 32, 64, 112, 128)
SCORE_REPS = (1, 2, 4, 8, 12, 16)


def libraries(cs, other):
    """[(cache, key, other build's function, this build's)] for K1, K3, K6,
    K2, K4, K8 and K5: ``cache[key]`` is where the port's wrapper keeps the
    launch function of its fixed instantiations (the other tree may build
    several kernels in one library: K1 and K3 from one entry point, K2 and
    K4 from another)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import pack_quantize as pq
    from repro_torch.kernels import sparse_attention as sa

    which = (  # cache, key, the other tree's source and entry point, this build's function
        (fr._fns, "fier_retrieve", "fier_retrieve", "fier_retrieve_launch",
         lambda: fr._kernel("fier_retrieve")),
        (fr._fns, "fier_retrieve_paged", "fier_retrieve", "fier_retrieve_launch",
         lambda: fr._kernel("fier_retrieve_paged")),
        (vars(fs), "_fn", "fier_score", "fier_score_launch", fs._kernel),
        (sa._fns, ("fier_attend", "fier_attend_launch"), "fier_attend", "fier_attend_launch",
         lambda: sa._kernel(128, 1)),
        (sa._fns, ("fier_attend_paged", "fier_attend_paged_launch"), "fier_attend",
         "fier_attend_launch", lambda: sa._kernel(128, 1, "paged")),
        (sa._fns, ("fier_attend_gathered", "fier_attend_gathered_launch"), "fier_attend",
         "fier_attend_gathered_launch", lambda: sa._kernel(128, 1, "gathered")),
        (vars(pq), "_fn", "fier_pack", "fier_pack_launch", pq._kernel),
    )
    sources = sorted({src for _, _, src, _, _ in which})
    with ThreadPoolExecutor(len(sources)) as pool:  # every nvcc at once, beside this build's
        futures = {src: pool.submit(cs.nvcc_lib, os.path.join(other, f"{src}.cu"), f"{src}_other")
                   for src in sources}
        build.build()
        libs = {src: f.result() for src, f in futures.items()}
    out = []
    for cache, key, src, entry, this in which:
        f, new = getattr(libs[src], entry), this()
        f.argtypes, f.restype = new.argtypes, new.restype
        out.append((cache, key, f, new))
    return out


class Swap:
    """Within ``with Swap(libs, "old")`` every wrapper launches the other
    directory's build."""

    def __init__(self, libs, which):
        self.libs, self.i = libs, 2 if which == "old" else 3

    def __enter__(self):
        for entry in self.libs:
            entry[0][entry[1]] = entry[self.i]

    def __exit__(self, *exc):
        for cache, key, _, new in self.libs:
            cache[key] = new


def both(torch, libs, fn):
    with Swap(libs, "old"):
        a = fn()
    b = fn()
    torch.cuda.synchronize()
    return a, b


def equal(torch, name, a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        if not torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)):
            raise AssertionError(f"{name}: the two builds differ")


def scoring(torch, cs, libs):
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr

    n = 0
    for S, group, budget, bs, B in ((cs.CAPACITY, cs.GROUP, cs.BUDGET, cs.BLOCK_SIZE, cs.SLOTS),
                                    (264, 8, 32, 8, 4)):
        for D in HEADS:
            for rep in SCORE_REPS:
                Hkv = max(1, 16 // rep) if S == cs.CAPACITY else 4
                q, _, _, qk, lengths = cs.device_inputs(torch, B, Hkv, rep, D, S, seed=D + rep,
                                                        group=group)
                pools, table, _, _, _ = cs.paged_inputs(torch, q, None, None, qk, lengths, bs,
                                                        spare=8, seed=rep)
                for reduce in ("max", "sum"):
                    sel = dict(group=group, group_reduce=reduce, sink=4, recent=64)
                    equal(torch, f"K1 {(B, Hkv, rep, D, S, reduce)}", *both(
                        torch, libs, lambda: fr.fier_retrieve(q, qk.codes, qk.scale, qk.zero,
                                                              lengths, budget, **sel)))
                    equal(torch, f"K3 {(B, Hkv, rep, D, S, reduce)}", *both(
                        torch, libs, lambda: fr.fier_retrieve(
                            q, pools["codes"], pools["scale"], pools["zero"], lengths, budget,
                            block_table=table, **sel)))
                equal(torch, f"K6 {(B, Hkv, rep, D, S)}", *both(
                    torch, libs, lambda: fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero,
                                                            group=group)))
                n += 1
                del q, qk, lengths, pools, table
    print(f"K1, K3 and K6 equal bit for bit at {n} shapes (each K1/K3 under max and sum)",
          flush=True)


def attention(torch, cs, libs):
    from repro_torch.core.quantize import quantize
    from repro_torch.core.retrieval import gather_kv
    from repro_torch.kernels import sparse_attention as sa

    n = 0
    for D in HEADS:
        for rep in sa.KERNEL_REPS_AT.get(D, sa.KERNEL_REPS):
            for budget in (cs.BUDGET, 1000):
                B, Hkv = cs.SLOTS, max(1, 16 // rep)
                q, K, V, lengths, idx = cs.attend_inputs(torch, B, Hkv, rep, D, cs.CAPACITY,
                                                         budget, seed=D + rep + budget)
                pools, table, _, _, _ = cs.paged_inputs(torch, q, K, V, quantize(K, cs.GROUP),
                                                        lengths, cs.BLOCK_SIZE, spare=8, seed=rep)
                ks, vs = gather_kv(K, V, idx)
                mask = (idx < lengths[:, None, None]).to(torch.int8)
                tag = (B, Hkv, rep, D, budget)
                equal(torch, f"K2 {tag}", *both(
                    torch, libs, lambda: sa.fier_attend_selected(q, K, V, idx, lengths)))
                equal(torch, f"K4 {tag}", *both(torch, libs, lambda: sa.fier_attend_selected(
                    q, pools["k"], pools["v"], idx, lengths, block_table=table)))
                equal(torch, f"K8 {tag}", *both(
                    torch, libs, lambda: sa.fier_attend_gathered(q, ks, vs, mask)))
                n += 1
                del q, K, V, lengths, idx, pools, table, ks, vs, mask
    print(f"K2, K4 and K8 equal bit for bit at {n} shapes", flush=True)


def packing(torch, cs, libs):
    from repro_torch.kernels import pack_quantize as pq

    for D in HEADS:
        gen = torch.Generator(device="cuda").manual_seed(D)
        k = torch.randn((cs.SLOTS, cs.CAPACITY, 16, D), generator=gen, device="cuda")
        for x in (k, k.to(torch.bfloat16)):
            equal(torch, f"K5 D={D} {x.dtype}", *both(
                torch, libs, lambda: pq.fier_pack_quantize(x, cs.GROUP)))
    print(f"K5 equal bit for bit at d_head {HEADS} (f32 and bf16 keys)", flush=True)


def timings(torch, cs, libs):
    from repro_torch.core.retrieval import gather_kv
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import pack_quantize as pq
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels import topk_select as tk

    timer = cs.Timer(torch)
    for Hkv, rep, reduce in ((16, 1, "max"), (4, 4, "sum")):
        q, K, V, qk, lengths = cs.device_inputs(torch, cs.SLOTS, Hkv, rep, 128, cs.CAPACITY,
                                                seed=rep)
        pools, table, _, _, _ = cs.paged_inputs(torch, q, K, V, qk, lengths, cs.BLOCK_SIZE,
                                                spare=8, seed=rep)
        sel = dict(group=cs.GROUP, group_reduce=reduce, sink=cs.SINK, recent=cs.RECENT)
        idx, _, _ = fr.fier_retrieve(q, qk.codes, qk.scale, qk.zero, lengths, cs.BUDGET, **sel)
        scores = fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=cs.GROUP)
        kv = fr.masked_kv(scores, lengths, cs.SINK, cs.RECENT, reduce).reshape(cs.SLOTS * Hkv, -1)
        ks, vs = gather_kv(K, V, idx)
        mask = (idx < lengths[:, None, None]).to(torch.int8)
        calls = {
            "K1": lambda: fr.fier_retrieve(q, qk.codes, qk.scale, qk.zero, lengths, cs.BUDGET,
                                           **sel),
            "K3": lambda: fr.fier_retrieve(q, pools["codes"], pools["scale"], pools["zero"],
                                           lengths, cs.BUDGET, block_table=table, **sel),
            "K6": lambda: fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=cs.GROUP),
            "K7": lambda: tk.fier_topk_threshold(kv, cs.BUDGET),
            "K2": lambda: sa.fier_attend_selected(q, K, V, idx, lengths),
            "K4": lambda: sa.fier_attend_selected(q, pools["k"], pools["v"], idx, lengths,
                                                  block_table=table),
            "K8": lambda: sa.fier_attend_gathered(q, ks, vs, mask),
            "K5": lambda: pq.fier_pack_quantize(K, cs.GROUP),
        }
        for name, fn in calls.items():
            t = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                with Swap(libs, which):
                    t[which].append(timer(fn))
            old, new = (sum(t[w]) / 2 for w in ("old", "new"))
            print(f"{name} B={cs.SLOTS} Hkv={Hkv} rep={rep} D=128 {reduce}: other build "
                  f"{old:.4f} ms, this build {new:.4f} ms ({100 * (new / old - 1):+.1f}%)",
                  flush=True)
        del q, K, V, qk, lengths, pools, table, idx, scores, kv, ks, vs, mask
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    import chip_smoke as cs

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    libs = libraries(cs, os.path.abspath(sys.argv[1]))
    print(f"built both in {time.perf_counter() - t0:.1f} s", flush=True)
    scoring(torch, cs, libs)
    attention(torch, cs, libs)
    packing(torch, cs, libs)
    timings(torch, cs, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
