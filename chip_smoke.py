#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FIER (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # the whole check, as described below
    python3 chip_smoke.py --kernels-only  # phases 1-2 only, no result line

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Setup: the card's name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (olmo-1b: 4 slots, 16 kv heads, d_head 128, capacity 8192,
   group 32, budget 1024) and at a GQA shape (4 kv heads × 4 query heads,
   with the group sum and with the group max), with per-row lengths that
   include one row shorter than the budget; then the kernel, its plain
   version and one library call (where one computes the same function)
   timed in turns with the L2 cache flushed before every launch.  The paged kernels K3 and K4
   run on a pool built by scattering the slab's blocks (bs 32) into a random
   permutation of pool blocks, with spare blocks and one table entry inside
   a row's length pointed at the null block 0 (non-zero data): K3 must equal
   K1 on the gathered slab bit for bit (idx, τ, m), K4 must equal K2 bit for
   bit, and each must agree with its own plain version.  K5 must equal its
   plain version bit for bit (the bytes where it differs from
   ``build_metadata``'s side-car are printed, on bf16 and on f32 keys), K6
   lie within the f32 summation-order bound of its plain version, K7 give
   its plain version's τ and m exactly, and K8 lie within 1e-4·max|out| of
   its plain version and equal K2 bit for bit on ``gather_kv`` of K2's
   selection; ``ops.fier_decode_two_pass`` must give
   ``ops.fier_decode_one_pass``'s idx, τ, m and output bit for bit under
   the group max, and the same index set up to near-τ ties under the sum.
3. The main path at full olmo-1b width (random weights from a seeded
   ``torch.Generator``): ``Engine.build`` with the default policy,
   ``generate`` of 32 greedy tokens for 4 prompts, then ``insert`` of a
   fifth prompt into a freed slot and 8 ``decode(active=...)`` steps.  Every
   slab kernel must have launched 14 × (decode steps) times (16 layers − 2
   skip layers), the paged ones never.  The same engine built with
   ``pipeline='reference'`` (no custom kernel) gives identical prefill
   logits.  The first decode step is run with the kernels, with their plain
   versions (each layer's kernel inputs compared on the way), and with two
   planted faults: its logits must lie near the plain run's and the
   reference pipeline's, and each fault's must not (``first_step_checks``).
4. Paged vs slab (``paged_vs_slab``): the same weights, four prompts
   (7900/6000/4000/1500) inserted one by one into the slab engine and into
   ``Engine.build(layout="paged")`` (bs 32, default pool), then 32 greedy
   decode steps (the paged engine calling ``advance_slot`` for every slot
   first).  Tokens and the first step's logits must be equal (max |Δ| 0);
   each run launches only its own layout's kernels, 14 per step.
5. Serving a stream (``serve_stream``): ``ContinuousScheduler`` with chunk
   2048 over a paged engine (8 slots × 8192, bs 32, a tight pool of 621
   blocks) and 12 requests: P (a 4096-token family prefix + 250 tokens),
   two exact repeats of P (full-prompt replay, shared partial tail block,
   copy-on-write), four distinct prompts (7000/5000/3000/1500) and five
   family-prefix prompts.  Every request must finish, the audit be clean
   with no block in use, prefix hits, replays and CoW copies be > 0, the
   repeats generate P's tokens, a budget downshift or a preemption occur,
   and K3/K4 launch 14 × the scheduler's decode steps.  The first decode
   step at each budget served (1024 and, after a downshift, 512; 8 slots)
   also runs K3 and K4's plain versions on the engine's own tensors, held
   to the tolerances of phase 2.
6. The two_pass pipeline at full width (``two_pass_path``): phase 3's
   weights and prompts through ``Engine.build(policy=serving_policy(
   pipeline="two_pass"))``.  The first decode step runs the pipeline's
   kernels beside K1, K8 and ``fier_decode_reference(use_kernels=True)`` on
   the engine's own tensors and must give phase 3's one_pass logits
   exactly; the unfused building blocks (``ops.pack_quantize``, K5, on a
   FIER layer's key slab, bitwise its plain version, and
   ``ops.fier_attention_decode``, K6 → sort → gather → K8, on every FIER
   layer's tensors of that step) run counted; ``generate`` of 32 greedy
   tokens must give phase 3's tokens (128/128) with K6 = K7 = K2 = 14 ×
   decode steps and no other kernel; ``count_score_bytes`` of one layer
   must read 0 for one_pass (slab and paged) and at least 2·4·Hq·S·B for
   two_pass.  two_pass and one_pass decode steps are then timed in turns and
   profiled (information, no gate).
7. One JSON line ``{"kernels": [...]}`` with each kernel's check, times,
   bound and launch count (K1/K2: phase 3; K3/K4: phase 5; K6/K7: phase 6's
   generate; K5/K8: phase 6's building blocks), the card line, and as the
   last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# main-path shapes (olmo-1b, Engine.build(n_slots=4, capacity=8192) defaults)
SLOTS, CAPACITY, GROUP, BUDGET, SINK, RECENT = 4, 8192, 32, 1024, 4, 64
BLOCK_SIZE = 32
DEVICE = "cuda"
N_LAYERS, SKIP = 16, 2
PROMPTS = (7900, 6000, 4000, 1500)
FIFTH_PROMPT = 3000
MAX_NEW = 32
EXTRA_STEPS = 8

# tolerances
K2_REL_TOL = 1e-4          # K2 vs plain: max |Δout| <= 1e-4 · max |out| (f32 sum order, exp)
# first decode step, as fractions of max |logit| (4.716 with these seeds), each
# set between the sound run's gap and the smaller planted fault's (PERF.md):
PLAIN_LOGIT_REL_TOL = 0.015  # kernels vs their plain versions: sound 0.0384, fault 0.1136
REF_LOGIT_REL_TOL = 0.02     # vs the reference pipeline: sound 0.0642, fault 0.1208


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing

class Timer:
    """Median device time of a callable, CUDA events around each launch,
    the L2 cache (50 MB) flushed by a 256 MB write before every launch.
    A ~3 ms device spin after the flush lets the host enqueue the timed
    work before the start event fires, so the wrapper's host-side
    overhead (checks, allocation, the ctypes call) is not in the window."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(5_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def in_turns(timer, plain, kernel, library):
    """plain, kernel, library, library, kernel, plain: mean of the two
    medians of each.  ``library`` None: no single call computes the
    function, its time is None."""
    t = {"plain": [], "kernel": [], "library": []}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        fn = {"plain": plain, "kernel": kernel, "library": library}[name]
        if fn is not None:
            t[name].append(timer(fn))
    return {k: (sum(v) / len(v) if v else None) for k, v in t.items()}


# ------------------------------------------------------------ phase 2

def make_inputs(torch, B, Hkv, rep, D, S, seed):
    import numpy as np

    from repro_torch.core.quantize import quantize

    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D)).astype(np.float32)  # per-channel spread
    K = torch.from_numpy((rng.standard_normal((B, S, Hkv, D)) * ch).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, rep, D)).astype(np.float32))
    K, V, q = (t.to(DEVICE, torch.bfloat16) for t in (K, V, q))
    qk = quantize(K, GROUP)
    lengths = torch.tensor([S, 5003, 2100, 700][:B], dtype=torch.int32, device=DEVICE)
    return q, K, V, qk, lengths


def check_kernels(torch, timer, shapes):
    import torch.nn.functional as F

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels.check import selection_agrees

    rows = {"fier_retrieve": [], "fier_attend_selected": []}
    for (B, Hkv, rep, D, S, reduce) in shapes:
        q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=rep)
        sel = dict(group=GROUP, group_reduce=reduce, sink=SINK, recent=RECENT)
        args = (q, qk.codes, qk.scale, qk.zero, lengths, BUDGET)

        # ---- K1 against its plain version
        idx_k, tau_k, m_k = fr.fier_retrieve(*args, **sel)
        idx_p, tau_p, m_p = fr.fier_retrieve_plain(*args, **sel)
        torch.cuda.synchronize()
        s = fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=GROUP)
        kv = fr.masked_kv(s, lengths, SINK, RECENT, reduce)
        # both sum the same exact f32 products (bf16 q × bf16 a) in other
        # orders: |Δscore| <= D·2^-23 · rep · max Σ_d |q_d|·|a_td|
        amax = (qk.scale.float().abs() + qk.zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)
        ok, ndiff = selection_agrees(
            idx_k.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1),
            tau_k.reshape(-1), tau_p.reshape(-1), m_k.reshape(-1), m_p.reshape(-1),
            kv.reshape(B * Hkv, S), eps,
        )
        tau_err = float(torch.where(
            tau_k == tau_p, torch.zeros_like(tau_k), (tau_k - tau_p).abs()
        ).max())
        if not ok:
            raise AssertionError(
                f"K1 disagrees with its plain version at {(B, Hkv, rep, D, S, reduce)}: "
                f"{ndiff} differing indices, eps {eps:.3g}, tau err {tau_err:.3g}"
            )
        log(f"  K1 B={B} Hkv={Hkv} rep={rep} {reduce}: index sets agree "
            f"({ndiff} near-tau swaps, eps {eps:.3g}), tau err {tau_err:.3g}, "
            f"m equal {bool((m_k == m_p).all())}")
        kv_rows = kv.reshape(B * Hkv, S)
        t = in_turns(
            timer,
            lambda: fr.fier_retrieve_plain(*args, **sel),
            lambda: fr.fier_retrieve(*args, **sel),
            lambda: torch.topk(kv_rows, BUDGET, dim=-1),
        )
        nbytes = sum(a.numel() * a.element_size() for a in (q, qk.codes, qk.scale, qk.zero, lengths))
        nbytes += idx_k.numel() * 4 + tau_k.numel() * 4 + m_k.numel() * 4
        flops = 2 * B * Hkv * rep * S * D
        rows["fier_retrieve"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], bytes=nbytes, flops=flops, max_abs_err=tau_err,
        ))

        # ---- K2 against its plain version, on K1's selection
        out_k = sa.fier_attend_selected(q, K, V, idx_k, lengths)
        out_p = sa.fier_attend_selected_plain(q, K, V, idx_k, lengths)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out_k).all()):
            raise AssertionError(
                f"K2 disagrees with its plain version at {(B, Hkv, rep, D, S)}: "
                f"max err {err:.3g} > {K2_REL_TOL} · {scale:.3g}"
            )
        log(f"  K2 B={B} Hkv={Hkv} rep={rep}: max |err| {err:.3g} "
            f"(<= {K2_REL_TOL}·max|out| = {K2_REL_TOL * scale:.3g})")
        valid = idx_k < lengths[:, None, None]
        mask = valid[:, :, None, :].expand(B, Hkv, rep, BUDGET)

        def library():
            from repro_torch.core.retrieval import gather_kv

            ks, vs = gather_kv(K, V, idx_k)
            return F.scaled_dot_product_attention(
                q, ks.transpose(1, 2), vs.transpose(1, 2), attn_mask=mask
            )

        t = in_turns(
            timer,
            lambda: sa.fier_attend_selected_plain(q, K, V, idx_k, lengths),
            lambda: sa.fier_attend_selected(q, K, V, idx_k, lengths),
            library,
        )
        n_valid = int(valid.sum())
        nbytes = 2 * n_valid * D * 2 + idx_k.numel() * 4 + q.numel() * 2
        nbytes += lengths.numel() * 4 + out_k.numel() * 4
        flops = 4 * n_valid * rep * D
        rows["fier_attend_selected"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], bytes=nbytes, flops=flops, max_abs_err=err,
        ))
        del q, K, V, qk, lengths, s, kv
        torch.cuda.empty_cache()
    return finish_rows(rows)


def paged_inputs(torch, q, K, V, qk, lengths, bs, spare, seed):
    """The slab's blocks scattered into a random permutation of pool blocks
    (with ``spare`` unused blocks), and one table entry of row 1 inside its
    length pointed at the null block 0, which holds non-zero data.  Returns
    the pools, the table and the logical slabs the table gathers (what K1
    and K2 see)."""
    import numpy as np

    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kvcache.paged import gather_block_rows

    B, S = K.shape[:2]
    nb = S // bs
    N = 1 + B * nb + spare
    rng = np.random.default_rng(seed)
    perm = 1 + rng.permutation(N - 1)[: B * nb]
    table = torch.from_numpy(perm.reshape(B, nb).astype(np.int32)).to(q.device)
    hole = int(lengths[1]) // bs // 2  # a block well inside row 1's length
    table[1, hole] = 0

    def to_pool(a, fill):
        pb = a.shape[1] // nb
        pool = torch.empty((N, pb, *a.shape[2:]), dtype=a.dtype, device=a.device)
        pool[0] = fill(pool[0])
        ids = torch.from_numpy(perm.astype(np.int64)).to(a.device)
        pool[ids] = a.reshape(B * nb, pb, *a.shape[2:])
        pool[torch.from_numpy(np.setdiff1d(np.arange(1, N), perm)).to(a.device)] = 0
        return pool

    noise = lambda t: torch.randn(t.shape, device=t.device).to(t.dtype)
    pools = dict(
        k=to_pool(K, noise), v=to_pool(V, noise),
        codes=to_pool(qk.codes, lambda t: torch.randint_like(t, 1, 256)),
        scale=to_pool(qk.scale, lambda t: noise(t).abs() + 0.5),
        zero=to_pool(qk.zero, noise),
    )
    g = lambda a: gather_block_rows(a, table)
    slab_qk = QuantizedKeys(g(pools["codes"]), g(pools["scale"]), g(pools["zero"]), qk.group)
    return pools, table, g(pools["k"]), g(pools["v"]), slab_qk


def check_paged_kernels(torch, timer, shapes):
    """K3 and K4 on a permuted pool with a null-block hole: each against its
    plain version, and bitwise against K1 / K2 on the gathered slab."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa

    rows = {"fier_retrieve_paged": [], "fier_attend_selected_paged": []}
    for (B, Hkv, rep, D, S, reduce) in shapes:
        q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=rep + 10)
        pools, table, Ks, Vs, sqk = paged_inputs(
            torch, q, K, V, qk, lengths, BLOCK_SIZE, spare=64, seed=rep
        )
        del K, V, qk
        sel = dict(group=GROUP, group_reduce=reduce, sink=SINK, recent=RECENT)
        pargs = (q, pools["codes"], pools["scale"], pools["zero"], table, lengths, BUDGET)
        kargs = (q, pools["codes"], pools["scale"], pools["zero"], lengths, BUDGET)
        ksel = dict(sel, block_table=table)

        # ---- K3: bitwise K1 on the gathered slab, and its plain version
        idx3, tau3, m3 = fr.fier_retrieve(*kargs, **ksel)
        idx1, tau1, m1 = fr.fier_retrieve(
            q, sqk.codes, sqk.scale, sqk.zero, lengths, BUDGET, **sel
        )
        idx_p, tau_p, m_p = fr.fier_retrieve_paged_plain(*pargs, **sel)
        torch.cuda.synchronize()
        if not (torch.equal(idx3, idx1) and torch.equal(tau3, tau1) and torch.equal(m3, m1)):
            raise AssertionError(f"K3 differs from K1 on the gathered slab at "
                                 f"{(B, Hkv, rep, D, S, reduce)}")
        # K1 on the same slab passed the plain-version check in phase 2's
        # first half; K3 = K1 bitwise, so the same near-τ band applies here
        s = fr.retrieval_scores(q, sqk.codes, sqk.scale, sqk.zero, group=GROUP)
        kv = fr.masked_kv(s, lengths, SINK, RECENT, reduce)
        amax = (sqk.scale.float().abs() + sqk.zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)
        from repro_torch.kernels.check import selection_agrees

        ok, ndiff = selection_agrees(
            idx3.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1),
            tau3.reshape(-1), tau_p.reshape(-1), m3.reshape(-1), m_p.reshape(-1),
            kv.reshape(B * Hkv, S), eps,
        )
        tau_err = float(torch.where(tau3 == tau_p, torch.zeros_like(tau3),
                                    (tau3 - tau_p).abs()).max())
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version: {ndiff} indices")
        log(f"  K3 B={B} Hkv={Hkv} rep={rep} {reduce}: idx, tau, m bitwise equal to K1 on "
            f"the gathered slab; vs plain: {ndiff} near-tau swaps, tau err {tau_err:.3g}")
        kv_rows = kv.reshape(B * Hkv, S)
        t = in_turns(
            timer,
            lambda: fr.fier_retrieve_paged_plain(*pargs, **sel),
            lambda: fr.fier_retrieve(*kargs, **ksel),
            lambda: torch.topk(kv_rows, BUDGET, dim=-1),
        )
        nbytes = sum(a.numel() * a.element_size() for a in (q, sqk.codes, sqk.scale, sqk.zero))
        nbytes += table.numel() * 4 + lengths.numel() * 4
        nbytes += idx3.numel() * 4 + tau3.numel() * 4 + m3.numel() * 4
        rows["fier_retrieve_paged"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], bytes=nbytes, flops=2 * B * Hkv * rep * S * D,
            max_abs_err=tau_err,
        ))

        # ---- K4: bitwise K2 on the gathered slab, and its plain version
        out4 = sa.fier_attend_selected(
            q, pools["k"], pools["v"], idx3, lengths, block_table=table
        )
        out2 = sa.fier_attend_selected(q, Ks, Vs, idx3, lengths)
        out_p = sa.fier_attend_selected_paged_plain(
            q, pools["k"], pools["v"], table, idx3, lengths
        )
        torch.cuda.synchronize()
        if not torch.equal(out4, out2):
            raise AssertionError(f"K4 differs from K2 on the gathered slab: max "
                                 f"{float((out4 - out2).abs().max()):.3g}")
        err = float((out4 - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out4).all()):
            raise AssertionError(f"K4 disagrees with its plain version: {err:.3g} > "
                                 f"{K2_REL_TOL} · {scale:.3g}")
        log(f"  K4 B={B} Hkv={Hkv} rep={rep}: bitwise equal to K2 on the gathered slab; "
            f"vs plain max |err| {err:.3g} (<= {K2_REL_TOL * scale:.3g})")
        valid = idx3 < lengths[:, None, None]
        mask = valid[:, :, None, :].expand(B, Hkv, rep, BUDGET)
        kflat = pools["k"].reshape(-1, Hkv, D)
        vflat = pools["v"].reshape(-1, Hkv, D)
        heads = torch.arange(Hkv, device=q.device)[None, :, None]

        def library():
            prow = table.long().gather(1, (idx3 // BLOCK_SIZE).long().reshape(B, -1))
            prow = prow.reshape(idx3.shape) * BLOCK_SIZE + (idx3 % BLOCK_SIZE)
            ks, vs = kflat[prow, heads], vflat[prow, heads]  # [B, Hkv, budget, D]
            return F.scaled_dot_product_attention(q, ks, vs, attn_mask=mask)

        t = in_turns(
            timer,
            lambda: sa.fier_attend_selected_paged_plain(
                q, pools["k"], pools["v"], table, idx3, lengths),
            lambda: sa.fier_attend_selected(
                q, pools["k"], pools["v"], idx3, lengths, block_table=table),
            library,
        )
        n_valid = int(valid.sum())
        nbytes = 2 * n_valid * D * 2 + idx3.numel() * 4 + q.numel() * 2
        nbytes += lengths.numel() * 4 + table.numel() * 4 + out4.numel() * 4
        rows["fier_attend_selected_paged"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], bytes=nbytes, flops=4 * n_valid * rep * D,
            max_abs_err=err,
        ))
        del q, pools, Ks, Vs, sqk, s, kv
        torch.cuda.empty_cache()
    return finish_rows(rows)


def byte_diff(torch, a, b) -> int:
    """Bytes in which two tensors of one shape and dtype differ."""
    as_bytes = lambda t: t.contiguous().view(torch.uint8)
    return int((as_bytes(a) != as_bytes(b)).sum())


def check_unfused_kernels(torch, timer, shapes):
    """K5–K8 against their plain versions, K8 bitwise against K2 on the same
    selection, and ``ops.fier_decode_two_pass`` against
    ``ops.fier_decode_one_pass``: idx, τ, m and output bit for bit under
    ``max``, the index set within ε of τ under ``sum`` (the group sum runs
    in torch's order there, in K1's inside K1)."""
    import torch.nn.functional as F

    from repro_torch.core import retrieval
    from repro_torch.core.policy import CacheView
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack_quantize as pq
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels import topk_select as tk
    from repro_torch.kernels.check import selection_agrees

    rows = {"pack_quantize": [], "fier_score": [], "topk_threshold": [], "sparse_attention": []}
    for (B, Hkv, rep, D, S, reduce) in shapes:
        q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=rep + 20)
        shape = (B, Hkv, rep, D, S)
        sel = dict(group_reduce=reduce, sink=SINK, recent=RECENT)

        # ---- K5: bitwise its plain version; bytes off build_metadata's side-car
        got = pq.fier_pack_quantize(K, GROUP)
        want = pq.fier_pack_quantize_plain(K, GROUP)
        torch.cuda.synchronize()
        for name, a, b in zip(("codes", "scale", "zero"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"K5 {name} differs from its plain version at {shape}: "
                                     f"{byte_diff(torch, a, b)} bytes")
        side = (qk.codes, qk.scale, qk.zero)  # quantize(K), what build_metadata returns
        off_bf16 = [byte_diff(torch, a, b) for a, b in zip(got, side)]
        Kf = K.float()
        qf = quantize(Kf, GROUP)
        off_f32 = [byte_diff(torch, a, b) for a, b in
                   zip(pq.fier_pack_quantize(Kf, GROUP), (qf.codes, qf.scale, qf.zero))]
        del Kf, qf
        log(f"  K5 {shape}: codes/scale/zero bitwise equal to its plain version; bytes "
            f"differing from build_metadata's side-car (codes, scale, zero): bf16 keys "
            f"{off_bf16}, f32 keys {off_f32}")
        t = in_turns(timer, lambda: pq.fier_pack_quantize_plain(K, GROUP),
                     lambda: pq.fier_pack_quantize(K, GROUP), None)
        nbytes = K.numel() * 2 + sum(a.numel() * a.element_size() for a in got)
        rows["pack_quantize"].append(dict(
            shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
            bytes=nbytes, flops=0, max_abs_err=0.0, bytes_off_side_car_bf16=sum(off_bf16),
            bytes_off_side_car_f32=sum(off_f32),
        ))

        # ---- K6: within the f32 summation-order bound of its plain version
        args = (q, qk.codes, qk.scale, qk.zero)
        s_k = fs.fier_score_scan(*args, group=GROUP)
        s_p = fs.retrieval_scores(*args, group=GROUP)
        torch.cuda.synchronize()
        amax = (qk.scale.float().abs() + qk.zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)
        err = float((s_k - s_p).abs().max())
        if not (err <= eps and torch.isfinite(s_k).all()):
            raise AssertionError(f"K6 disagrees with its plain version at {shape}: "
                                 f"{err:.3g} > {eps:.3g}")
        log(f"  K6 {shape}: max |Δscore| {err:.3g} (<= {eps:.3g})")
        t = in_turns(timer, lambda: fs.retrieval_scores(*args, group=GROUP),
                     lambda: fs.fier_score_scan(*args, group=GROUP), None)
        nbytes = sum(a.numel() * a.element_size() for a in args) + s_k.numel() * 4
        rows["fier_score"].append(dict(
            shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
            bytes=nbytes, flops=2 * B * Hkv * rep * S * D, max_abs_err=err,
        ))

        # ---- K7: tau and m exactly its plain version's
        masked = fr.masked_kv(s_k, lengths, SINK, RECENT, reduce).reshape(B * Hkv, S)
        tau_k, m_k = tk.fier_topk_threshold(masked, BUDGET)
        tau_p, m_p = tk.fier_topk_threshold_plain(masked, BUDGET)
        torch.cuda.synchronize()
        if not (torch.equal(tau_k, tau_p) and torch.equal(m_k, m_p)):
            raise AssertionError(f"K7 differs from its plain version at {shape}")
        log(f"  K7 {shape} {reduce}: tau and m equal to its plain version")
        t = in_turns(timer, lambda: tk.fier_topk_threshold_plain(masked, BUDGET),
                     lambda: tk.fier_topk_threshold(masked, BUDGET),
                     lambda: torch.topk(masked, BUDGET, dim=-1).values[:, -1])
        rows["topk_threshold"].append(dict(
            shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
            bytes=masked.numel() * 4 + tau_k.numel() * 4 + m_k.numel() * 4, flops=0,
            max_abs_err=0.0,
        ))

        # ---- the two pipelines on one slab view
        view = CacheView.slab(K, V, qk, lengths)
        q3 = q.reshape(B, Hkv * rep, D)
        idx1, tau1, m1 = ops.retrieve(q3, view, BUDGET, return_stats=True, **sel)
        idx2 = tk.compact_indices(masked, tau_k, m_k, BUDGET).reshape(B, Hkv, BUDGET)
        one = ops.fier_decode_one_pass(q3, view, BUDGET, **sel)
        two = ops.fier_decode_two_pass(q3, view, BUDGET, **sel)
        torch.cuda.synchronize()
        if reduce == "max":
            same = (torch.equal(idx1, idx2) and torch.equal(tau1.reshape(-1), tau_k)
                    and torch.equal(m1.reshape(-1), m_k) and torch.equal(one, two))
            if not same:
                raise AssertionError(f"two_pass differs from one_pass at {shape} (max)")
            log(f"  two_pass vs one_pass {shape} max: idx, tau, m and output bit for bit")
        else:
            ok, ndiff = selection_agrees(
                idx1.reshape(B * Hkv, -1), idx2.reshape(B * Hkv, -1), tau1.reshape(-1), tau_k,
                m1.reshape(-1), m_k, masked, eps,
            )
            if not ok:
                raise AssertionError(f"two_pass selects other tokens than one_pass at {shape}: "
                                     f"{ndiff} indices outside eps {eps:.3g}")
            log(f"  two_pass vs one_pass {shape} sum: index sets agree ({ndiff} near-tau "
                f"swaps, eps {eps:.3g}); outputs equal {torch.equal(one, two)}")

        # ---- K8: its plain version, and K2 bit for bit on the same selection
        ks, vs = retrieval.gather_kv(K, V, idx1)
        mask = (idx1 < lengths[:, None, None]).to(torch.int8)
        out8 = sa.fier_attend_gathered(q, ks, vs, mask)
        out2 = sa.fier_attend_selected(q, K, V, idx1, lengths)
        out_p = sa.fier_attend_gathered_plain(q, ks, vs, mask)
        torch.cuda.synchronize()
        if not torch.equal(out8, out2):
            raise AssertionError(f"K8 differs from K2 on the same selection at {shape}: max "
                                 f"{float((out8 - out2).abs().max()):.3g}")
        err = float((out8 - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out8).all()):
            raise AssertionError(f"K8 disagrees with its plain version at {shape}: "
                                 f"{err:.3g} > {K2_REL_TOL} · {scale:.3g}")
        log(f"  K8 {shape}: bitwise equal to K2 on gather_kv of its selection; vs plain "
            f"max |err| {err:.3g} (<= {K2_REL_TOL * scale:.3g})")
        amask = mask.bool()[:, :, None, :].expand(B, Hkv, rep, BUDGET)

        def library():
            ks_, vs_ = retrieval.gather_kv(K, V, idx1)
            return F.scaled_dot_product_attention(
                q, ks_.transpose(1, 2), vs_.transpose(1, 2), attn_mask=amask
            )

        t = in_turns(timer, lambda: sa.fier_attend_gathered_plain(q, ks, vs, mask),
                     lambda: sa.fier_attend_gathered(q, ks, vs, mask), library)
        n_valid = int(mask.sum())
        nbytes = 2 * n_valid * D * 2 + mask.numel() + q.numel() * 2 + out8.numel() * 4
        rows["sparse_attention"].append(dict(
            shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
            bytes=nbytes, flops=4 * n_valid * rep * D, max_abs_err=err,
        ))
        del q, K, V, qk, lengths, got, want, s_k, s_p, masked, ks, vs, view
        torch.cuda.empty_cache()
    return finish_rows(rows)


def finish_rows(rows):
    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S, r["flops"] / F32_FLOPS)
            r["bound_by"] = (
                "bytes" if r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS
                else "operations"
            )
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {lib}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}: {r['bytes']} B, {r['flops']} flop)")
    return rows


# ------------------------------------------------------------ phase 3

def main_path(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, serving_policy

    cfg = get_config("olmo-1b")
    eng = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY)
    pol = eng.bundle.policy
    if (pol.kind, pol.pipeline, pol.layout, pol.budget) != ("fier", "one_pass", "slab", BUDGET):
        raise AssertionError(f"Engine.build's default policy is {pol}")
    params = eng.bundle.init(torch.Generator(device="cuda").manual_seed(0))
    params = eng.compute_params(params)
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    S = max(PROMPTS)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (SLOTS, S))).to("cuda")
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
    fifth = torch.from_numpy(rng.integers(0, cfg.vocab, (1, FIFTH_PROMPT))).to("cuda")
    batch = {"tokens": prompts, "lengths": lengths}

    # ---- the reference pipeline (plain PyTorch, no custom kernel) on the same params
    ref = Engine.build(
        cfg, n_slots=SLOTS, capacity=CAPACITY,
        policy=serving_policy(budget=BUDGET, pipeline="reference"),
    )
    lg_ref, cache_ref = ref.prefill_batch(params, batch)
    tok0_ref = torch.argmax(lg_ref, -1).to(torch.int32)
    _, lg1_ref, _ = ref.decode(params, tok0_ref, cache_ref)
    del cache_ref
    toks_ref = ref.generate(params, prompts, lengths, MAX_NEW)
    del ref
    torch.cuda.empty_cache()

    # ---- time to first token of the 4-prompt batch (prefill + sample)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_prefill, cache = eng.prefill_batch(params, batch)
    tok0 = torch.argmax(lg_prefill, -1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    if not torch.equal(lg_prefill, lg_ref):
        raise AssertionError("prefill logits differ between one_pass and reference engines")
    log("  prefill logits identical to the reference pipeline")
    engine_errs, lg1 = first_step_checks(
        torch, eng, params, tok0.to(torch.int32), cache, lg1_ref, cfg.vocab
    )
    del cache
    torch.cuda.empty_cache()

    # ---- the counted run: generate, insert, decode(active)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = eng.generate(params, prompts, lengths, MAX_NEW, return_cache=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    slot = SLOTS - 1  # the 1500-token request is done; its slot is reused
    t0 = time.perf_counter()
    lg5, cache = eng.insert(params, cache, fifth, FIFTH_PROMPT, slot)
    tok = toks[:, -1].clone()
    tok[slot] = torch.argmax(lg5, -1)[0].to(torch.int32)
    torch.cuda.synchronize()
    t_insert = time.perf_counter() - t0
    active = torch.tensor([True, True, False, True], device="cuda")
    step_ms = []
    for _ in range(EXTRA_STEPS):
        t0 = time.perf_counter()
        tok, lg, cache = eng.decode(params, tok, cache, active=active)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profile_decode(torch, eng, params, tok, cache, active)
    steps = (MAX_NEW - 1) + EXTRA_STEPS
    check_launches(counts, SLAB_KERNELS, (N_LAYERS - SKIP) * steps)
    log(f"  launches {counts}: {N_LAYERS - SKIP} x {steps} decode steps")

    # ---- outputs are right by the repo's own means
    lens = cache["length"].tolist()
    want = [p + MAX_NEW - 1 + EXTRA_STEPS for p in PROMPTS]
    want[slot] = FIFTH_PROMPT + EXTRA_STEPS
    want[2] = PROMPTS[2] + MAX_NEW - 1  # inactive slot does not advance
    if lens != want:
        raise AssertionError(f"cache lengths {lens}, expected {want}")
    if not (toks.shape == (SLOTS, MAX_NEW) and bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        raise AssertionError(f"generated tokens out of range: {toks.shape}")
    if not torch.isfinite(lg[:, : cfg.vocab]).all():
        raise AssertionError("non-finite decode logits")
    if not torch.equal(toks[:, 0], tok0.to(torch.int32)):
        raise AssertionError("generate's first token differs from prefill's argmax")
    agree = int((toks == toks_ref).sum())
    med = sorted(step_ms)[len(step_ms) // 2]
    log(f"  greedy tokens agreeing with the reference pipeline: {agree}/{toks.numel()}")
    log(f"  TTFT (4 prompts {PROMPTS}, prefill + sample) {ttft * 1e3:.1f} ms; "
        f"insert of a {FIFTH_PROMPT}-token prompt {t_insert * 1e3:.1f} ms")
    log(f"  generate {MAX_NEW} tokens (prefill + {MAX_NEW - 1} decode steps): {t_gen:.3f} s")
    log(f"  decode(active) steps: median {med:.2f} ms/step "
        f"({3 / (med / 1e3):.1f} tokens/s over 3 active slots); "
        f"peak memory {peak / 2**30:.2f} GiB")
    del cache
    p3 = dict(prompts=prompts, lengths=lengths, toks=toks, lg1=lg1)
    return counts, engine_errs, params, eng, p3


SLAB_KERNELS = ("fier_retrieve", "fier_attend_selected")
PAGED_KERNELS = ("fier_retrieve_paged", "fier_attend_selected_paged")


def check_launches(counts, path_kernels, expect):
    """Each kernel of the path launched ``expect`` times, every other 0."""
    for name, n in counts.items():
        want = expect if name in path_kernels else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times, expected {want}")


# ------------------------------------------------------------ phase 4

def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def paged_vs_slab(torch, cfg, params, slab, prompts=PROMPTS, steps=MAX_NEW):
    """The same four prompts inserted one by one into the slab engine and
    into a paged one (bs 32, default pool), then ``steps`` greedy decode
    steps, the paged engine calling ``advance_slot`` for every slot before
    each step.  Tokens and the first step's logits must be equal; each
    engine must have run only its own layout's kernels, 14 per step."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine

    rng = np.random.default_rng(4)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))).to(DEVICE) for n in prompts]
    n_fier = cfg.n_layers - slab.bundle.policy.skip_layers

    def drive(eng, kernels):
        cache = eng.new_cache()
        reset_launch_counts()
        tok = torch.zeros(len(prompts), dtype=torch.int32, device=DEVICE)
        for slot, t in enumerate(toks):
            lg, cache = eng.insert(params, cache, t, t.shape[1], slot)
            tok[slot] = torch.argmax(lg, -1)[0]
        out, first, ms = [tok.clone()], None, []
        for _ in range(steps):
            sync(torch)
            t0 = time.perf_counter()
            if eng.paged:
                for slot in range(len(prompts)):
                    ok, cache = eng.advance_slot(cache, slot)
                    if not ok:
                        raise AssertionError("the default pool ran dry")
            tok, lg, cache = eng.decode(params, tok, cache)
            sync(torch)
            ms.append(1e3 * (time.perf_counter() - t0))
            if first is None:
                first = lg.clone()
            out.append(tok.clone())
        counts = launch_counts()
        check_launches(counts, kernels, n_fier * steps)
        if eng.paged:
            eng.audit()
        if DEVICE == "cuda":
            log(f"  {'paged' if eng.paged else 'slab'} engine:")
            profile_decode(torch, eng, params, tok, cache, None)
        del cache
        return torch.stack(out, 1), first, median(ms), counts

    toks_s, lg_s, ms_s, _ = drive(slab, SLAB_KERNELS)
    paged = Engine.build(cfg, n_slots=len(prompts), capacity=slab.capacity,
                         layout="paged", device=DEVICE)
    pol = paged.bundle.policy
    if (pol.layout, pol.pipeline, pol.budget, pol.block_size) != (
            "paged", "one_pass", slab.bundle.policy.budget, BLOCK_SIZE):
        raise AssertionError(f"the paged engine's policy is {pol}")
    toks_p, lg_p, ms_p, counts = drive(paged, PAGED_KERNELS)
    gap = float((lg_p - lg_s).abs().max())
    agree = int((toks_p == toks_s).sum())
    log(f"  first decode step, paged vs slab: max |Δlogit| {gap:.6g} (expected 0)")
    log(f"  greedy tokens equal to the slab engine's: {agree}/{toks_s.numel()}")
    log(f"  decode ms/step (median of {steps}): slab {ms_s:.2f}, paged {ms_p:.2f} "
        f"(advance_slot included); launches {counts}")
    if gap != 0.0 or not torch.equal(toks_p, toks_s):
        raise AssertionError("the paged engine differs from the slab engine")
    return counts


# ------------------------------------------------------------ phase 5

def stream_requests(vocab, family=4096, own=(250, 256), distinct=(7000, 5000, 3000, 1500)):
    """The phase 5 trace, in submission order: P (the family prefix plus
    ``own[0]`` tokens, a partial last block), two exact repeats of P, four
    distinct prompts, five family-prefix prompts of ``own[1]`` tokens each."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(5)
    toks = lambda n: rng.integers(1, vocab, size=n).tolist()
    fam = toks(family)
    P = fam + toks(own[0])
    specs = [(P, 32), (P, 16), (P, 16)]
    specs += [(toks(n), 64) for n in distinct]
    specs += [(fam + toks(own[1]), 32) for _ in range(5)]
    return [Request(rid=i, tokens=list(t), max_new=m) for i, (t, m) in enumerate(specs)]


def serve_stream(torch, cfg, params, *, n_slots=8, capacity=CAPACITY, pool_blocks=621,
                 chunk_tokens=2048, requests=None):
    """``ContinuousScheduler`` over a paged engine with a tight pool: every
    request must finish, the audit must be clean with no block in use, the
    prefix cache, the full-prompt replay and copy-on-write must all have
    fired, the repeats of P must have generated P's tokens, pressure must
    have shown as a budget downshift or a preemption, and the paged kernels
    must have launched 14 × the decode steps.  The first decode step at each
    budget the engine serves (the full one and every downshifted rung) runs
    K3 and K4 beside their plain versions on the engine's own tensors
    (``checked_kernels``; the served tokens stay the kernels')."""
    import dataclasses

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.obs import Observability
    from repro_torch.obs.tracing import PID_REQUEST
    from repro_torch.serving import ContinuousScheduler, Engine, serving_policy

    reqs = requests if requests is not None else stream_requests(cfg.vocab)
    eng = Engine.build(
        cfg, n_slots=n_slots, capacity=capacity, obs=Observability(), device=DEVICE,
        policy=dataclasses.replace(serving_policy(layout="paged"), pool_blocks=pool_blocks),
    )
    if eng.block_size != BLOCK_SIZE:
        raise AssertionError(f"the paged engine's block size is {eng.block_size}")
    sched = ContinuousScheduler(eng, params, chunk_tokens=chunk_tokens)
    dec_ms, checked_at = [], []
    errs = new_errs()
    checked = checked_kernels(torch, errs, keep_plain=False)
    decode = eng.decode

    def timed_decode(*a, **k):
        check = eng.current_budget not in checked_at
        if check:
            checked_at.append(eng.current_budget)
            ops.fier_retrieve, ops.fier_attend_selected = checked
        try:
            sync(torch)
            t0 = time.perf_counter()
            out = decode(*a, **k)
            sync(torch)
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
        if not check:  # a checked step also runs the plain versions: not timed
            dec_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    eng.decode = timed_decode
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sched.start()
    reset_launch_counts()
    wall0 = time.monotonic()
    for r in reqs:
        sched.submit(r)
    while sched.busy:
        if not sched.step():
            raise AssertionError("the scheduler stalled")
    sync(torch)
    wall = time.monotonic() - wall0
    counts = launch_counts()
    n_fier = cfg.n_layers - eng.bundle.policy.skip_layers
    check_launches(counts, PAGED_KERNELS, n_fier * sched.steps)

    eng.audit()
    ps = eng.pool_stats()
    status = {oc.status for oc in sched.outcomes.values()}
    n_tok = sum(len(r.out) for r in reqs)
    first = {}
    for e in eng.obs.tracer.events:
        if e.pid == PID_REQUEST and e.name == "token" and e.tid not in first:
            first[e.tid] = e.wall_ts - wall0
    ttft = sorted(first.values())
    pct = lambda q: ttft[min(len(ttft) - 1, int(q * (len(ttft) - 1) + 0.5))]
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    stats = dict(
        requests=len(reqs), decode_steps=sched.steps, prefill_chunks=sched.prefill_chunks,
        preemptions=sched.preemptions, prefill_aborts=sched.prefill_aborts,
        budget_downshifts=eng.downshifts, budget_restores=eng.restores,
        blocks_shed=eng.blocks_shed, prefix_block_hits=ps["pool_prefix_block_hits"],
        prefix_replays=eng.prefix_hits, cow_copies=ps["pool_cow_copies"],
        peak_blocks=ps["pool_peak_in_use"], blocks_in_use_at_end=ps["pool_blocks_in_use"],
        tokens=n_tok, wall_s=round(wall, 3), tokens_per_s=round(n_tok / wall, 2),
        decode_ms_median=round(median(dec_ms), 2), wall_ttft_p50_s=round(pct(0.5), 3),
        wall_ttft_p99_s=round(pct(0.99), 3), peak_gib=round(peak / 2**30, 2),
    )
    log(f"  pool {pool_blocks} blocks ({pool_blocks - 1} usable × {BLOCK_SIZE} tokens), "
        f"{n_slots} slots × {capacity}: {json.dumps(stats)}")
    log(f"  launches {counts}: {n_fier} x {sched.steps} decode steps")
    log(f"  decode steps held against the plain versions at budgets {checked_at}, "
        f"{n_slots} slots:")
    log_errs(errs, "K3", "K4")
    reps = [r.out == reqs[0].out[: len(r.out)] for r in reqs[1:3]]
    log(f"  the repeats of P generated P's tokens: {reps}")
    checks = {
        "every request finished": status == {"finished"} and len(sched.outcomes) == len(reqs),
        "no block in use at the end": ps["pool_blocks_in_use"] == 0,
        "prefix block hits > 0": ps["pool_prefix_block_hits"] > 0,
        "prefix replays > 0": eng.prefix_hits > 0,
        "copy-on-write copies > 0": ps["pool_cow_copies"] > 0,
        "the repeats of P generated P's tokens": all(reps),
        "a budget downshift or a preemption": eng.downshifts + sched.preemptions > 0,
        "the full budget's first decode step held against the plain versions":
            eng.base_budget in checked_at and errs["calls"] == n_fier * len(checked_at),
        "every downshifted budget's first decode step held against the plain versions":
            eng.downshifts == 0 or min(checked_at) < eng.base_budget,
        "every request got max_new tokens in range": all(
            len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out) for r in reqs
        ),
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"phase 5 failed: {bad}")
    del eng, sched
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return counts, stats, errs


def clone_cache(torch, cache):
    """A copy of a decode cache (decode updates its cache in place)."""
    import dataclasses

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: copy(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)
            })
        return x

    return copy(cache)


def new_errs():
    return {"k1_tau": 0.0, "k1_swaps": 0, "k2": 0.0, "k2_rel": 0.0, "calls": 0}


def checked_kernels(torch, errs, *, keep_plain):
    """Stand-ins for ``ops.fier_retrieve`` / ``ops.fier_attend_selected``
    that run the kernel and its plain version on the same (the engine's
    own) tensors, either layout: K1/K3 must give the same index set up to
    near-τ ties, K2/K4 must lie within K2_REL_TOL of max|out|.  They return
    the plain result when ``keep_plain`` (it goes on down the stack), else
    the kernel's, so the served path is the one it would have been.  The
    kernel launch is the path's own; the plain version launches nothing."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels.check import selection_agrees
    from repro_torch.kvcache.paged import gather_block_rows

    def retrieve(q, codes, scale, zero, lengths, budget, *, block_table=None, **sel):
        got = fr.fier_retrieve(q, codes, scale, zero, lengths, budget,
                               block_table=block_table, **sel)
        if block_table is not None:
            want = fr.fier_retrieve_paged_plain(
                q, codes, scale, zero, block_table, lengths, budget, **sel)
            codes, scale, zero = (gather_block_rows(a, block_table) for a in (codes, scale, zero))
        else:
            want = fr.fier_retrieve_plain(q, codes, scale, zero, lengths, budget, **sel)
        B, Hkv, rep, D = q.shape
        s = fr.retrieval_scores(q, codes, scale, zero, group=sel["group"])
        kv = fr.masked_kv(s, lengths, sel["sink"], sel["recent"], sel["group_reduce"])
        amax = (scale.float().abs() + zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)
        ok, ndiff = selection_agrees(
            *(x.reshape(B * Hkv, -1) for x in (got[0], want[0])),
            *(x.reshape(-1) for x in (got[1], want[1], got[2], want[2])),
            kv.reshape(B * Hkv, -1), eps,
        )
        name = "K3" if block_table is not None else "K1"
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version on the engine's "
                                 f"tensors: {ndiff} indices, eps {eps:.3g}")
        d_tau = torch.where(got[1] == want[1], 0.0, (got[1] - want[1]).abs()).max()
        errs["k1_tau"] = max(errs["k1_tau"], float(d_tau))
        errs["k1_swaps"] += ndiff
        errs["calls"] += 1
        return want if keep_plain else got

    def attend(q, K, V, idx, lengths=None, *, block_table=None):
        got = sa.fier_attend_selected(q, K, V, idx, lengths, block_table=block_table)
        if block_table is not None:
            want = sa.fier_attend_selected_paged_plain(q, K, V, block_table, idx, lengths)
        else:
            want = sa.fier_attend_selected_plain(q, K, V, idx, lengths)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= K2_REL_TOL:
            name = "K4" if block_table is not None else "K2"
            raise AssertionError(f"{name} disagrees with its plain version on the engine's "
                                 f"tensors: {err:.3g} ({rel:.3g} of max|out|)")
        errs["k2"], errs["k2_rel"] = max(errs["k2"], err), max(errs["k2_rel"], rel)
        return want if keep_plain else got

    return retrieve, attend


def log_errs(errs, retrieval, attention):
    log(f"  per layer on the engine's tensors ({errs['calls']} calls): {retrieval} index "
        f"sets agree ({errs['k1_swaps']} near-tau swaps), max tau err {errs['k1_tau']:.3g}; "
        f"{attention} max |err| {errs['k2']:.3g} ({errs['k2_rel']:.3g} of max|out|)")



def first_step_checks(torch, eng, params, tok0, cache, lg1_ref, vocab):
    """The first decode step after prefill, five ways, each from a copy of
    the same prefill cache:

    * with the kernels (the main path);
    * with each kernel's plain version on the engine's own tensors — every
      layer's K1 and K2 inputs also go through the kernel and are compared
      there (K1: same index set up to near-τ ties; K2: within K2_REL_TOL);
      the plain results go on down the stack;
    * with two planted faults: K2 given every selected index shifted by
      one token, and K1's selection of the last FIER layer handed to the
      neighbouring kv head.
    The kernel step must lie within PLAIN_LOGIT_REL_TOL of the plain step
    and REF_LOGIT_REL_TOL of the reference pipeline, and each planted fault
    beyond both, so the gates are shown to see a wrong kernel.  Returns the
    largest K1 τ error and K2 error of the per-layer comparisons, and the
    kernel step's logits."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa

    def step(retrieve=fr.fier_retrieve, attend=sa.fier_attend_selected):
        ops.fier_retrieve, ops.fier_attend_selected = retrieve, attend
        try:
            _, lg, _ = eng.decode(params, tok0, clone_cache(torch, cache))
            torch.cuda.synchronize()
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
        return lg[:, :vocab]

    errs = new_errs()
    checked_retrieve, checked_attend = checked_kernels(torch, errs, keep_plain=True)

    def shifted_attend(q, K, V, idx, lengths=None, **k):
        return sa.fier_attend_selected(q, K, V, (idx + 1) % K.shape[1], lengths, **k)

    n_calls = [0]

    def rolled_retrieve(*a, **k):
        idx, tau, m = fr.fier_retrieve(*a, **k)
        n_calls[0] += 1
        if n_calls[0] == N_LAYERS - SKIP:  # the last FIER layer only
            idx = torch.roll(idx, 1, dims=1)
        return idx, tau, m

    lg1 = step()
    lg1_plain = step(checked_retrieve, checked_attend)
    faults = {
        "K2 fed idx+1": step(attend=shifted_attend),
        "K1's last-layer selection on the next kv head": step(retrieve=rolled_retrieve),
    }
    ref = lg1_ref[:, :vocab]
    s1 = float(ref.abs().max())
    gap = lambda a, b: float((a - b).abs().max())
    top1 = lambda a, b: int((a.argmax(-1) == b.argmax(-1)).sum())
    d_plain, d_ref = gap(lg1, lg1_plain), gap(lg1, ref)
    log_errs(errs, "K1", "K2")
    log(f"  first decode step (max |logit| {s1:.4g}): max |Δlogit| vs plain versions "
        f"{d_plain:.4g} (top-1 {top1(lg1, lg1_plain)}/{SLOTS}), vs reference pipeline "
        f"{d_ref:.4g} (top-1 {top1(lg1, ref)}/{SLOTS})")
    for name, lg in faults.items():
        log(f"  planted fault, {name}: max |Δlogit| vs plain versions "
            f"{gap(lg, lg1_plain):.4g}, vs reference pipeline {gap(lg, ref):.4g}")
    if not torch.isfinite(lg1).all():
        raise AssertionError("non-finite first-step logits")
    if not d_plain <= PLAIN_LOGIT_REL_TOL * s1:
        raise AssertionError(f"first step vs plain versions: {d_plain:.4g} > "
                             f"{PLAIN_LOGIT_REL_TOL} · {s1:.4g}")
    if not d_ref <= REF_LOGIT_REL_TOL * s1:
        raise AssertionError(f"first step vs reference pipeline: {d_ref:.4g} > "
                             f"{REF_LOGIT_REL_TOL} · {s1:.4g}")
    for name, lg in faults.items():
        if not (gap(lg, lg1_plain) > PLAIN_LOGIT_REL_TOL * s1
                and gap(lg, ref) > REF_LOGIT_REL_TOL * s1):
            raise AssertionError(f"the first-step gates do not see the planted fault "
                                 f"({name}): {gap(lg, lg1_plain):.4g}, {gap(lg, ref):.4g}")
    return errs, lg1


def profile_decode(torch, eng, params, tok, cache, active, steps: int = 3):
    """Device busy share of decode steps, their kernel launches and the
    kernels that fill them (torch.profiler; the profiler's own overhead
    slows the host side, so the busy share is a lower bound on an
    unprofiled step's).  Only kernel rows are summed: an operator row
    repeats its kernels' time.  A paged engine's step includes
    ``advance_slot`` for every active slot, as the scheduler runs it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slots = [s for s in range(eng.n_slots) if active is None or bool(active[s])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            if eng.paged:
                for slot in slots:
                    ok, cache = eng.advance_slot(cache, slot)
                    if not ok:
                        raise AssertionError("the pool ran dry while profiling")
            tok, _, cache = eng.decode(params, tok, cache, active=active)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    events = [
        e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev(e) > 0
    ]
    if not events:
        log("  profiled decode steps: the profiler reported no device kernels")
        return
    busy_us = sum(dev(e) for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"  profiled {steps} decode steps: wall {wall_us / steps / 1e3:.2f} ms/step, "
        f"device busy {busy_us / steps / 1e3:.3f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% busy, {100 - 100 * busy_us / wall_us:.1f}% idle), "
        f"{n_kernels // steps} kernel launches/step")
    for e in sorted(events, key=dev, reverse=True)[:10]:
        log(f"    {dev(e) / steps / 1e3:8.3f} ms/step  {e.count // steps:5d} calls/step  "
            f"{e.key[:90]}")


# ------------------------------------------------------------ phase 6

TWO_PASS_KERNELS = ("fier_score", "topk_threshold", "fier_attend_selected")
UNFUSED_KERNELS = ("pack_quantize", "fier_score", "sparse_attention")


def two_pass_checks(torch, errs, calls):
    """A stand-in for ``ops.fier_decode_two_pass`` that runs the pipeline
    step by step (K6 → group reduction → K7 + ``compact_indices`` → K2, the
    pipeline's own launches) and, on the engine's own tensors, checks:
    its selection against K1's (idx, τ, m bitwise under ``max``); K8 on
    ``gather_kv`` of that selection against K2 (bitwise) and against K8's
    plain version; the selection of ``fier_decode_reference(use_kernels=True)``
    (``select_topk`` over K6's scores) against K1's, up to scores within ε
    of τ, and that pipeline's output finite.  Each call's (q, view) is kept
    in ``calls`` for the building-block run.  K1 and K8 launched here are
    comparison launches."""
    from repro_torch.core import retrieval
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels import topk_select as tk

    def checked(q, view, budget, *, group_reduce, sink, recent):
        B, Hq, D = q.shape
        Hkv = view.k.shape[2]
        sel = dict(sink=sink, recent=recent)
        scores = ops.fier_score(q, view.meta)
        kv = retrieval.reduce_over_query_group(scores, Hkv, group_reduce)
        masked = retrieval.masked_scores(kv, view.length, **sel).reshape(B * Hkv, -1)
        tau, m = tk.fier_topk_threshold(masked, budget)
        idx = tk.compact_indices(masked, tau, m, budget).reshape(B, Hkv, budget)
        out = ops.attend_selected(q, view, idx)
        calls.append((q, view))

        idx1, tau1, m1 = ops.retrieve(q, view, budget, group_reduce=group_reduce,
                                      return_stats=True, **sel)
        if group_reduce == "max" and not (torch.equal(idx, idx1) and torch.equal(
                tau, tau1.reshape(-1)) and torch.equal(m, m1.reshape(-1))):
            raise AssertionError("two_pass selects other tokens than K1 on the engine's tensors")
        q4 = q.reshape(B, Hkv, Hq // Hkv, D)
        ks, vs = retrieval.gather_kv(view.k, view.v, idx)
        mask = (idx < view.length[:, None, None]).to(torch.int8)
        out8 = sa.fier_attend_gathered(q4, ks, vs, mask)
        out2 = sa.fier_attend_selected(q4, view.k, view.v, idx, view.length)
        out_p = sa.fier_attend_gathered_plain(q4, ks, vs, mask)
        if not torch.equal(out8, out2):
            raise AssertionError("K8 differs from K2 on the engine's tensors")
        err = float((out8 - out_p).abs().max())
        rel = err / float(out_p.abs().max())
        if not rel <= K2_REL_TOL:
            raise AssertionError(f"K8 disagrees with its plain version on the engine's "
                                 f"tensors: {err:.3g} ({rel:.3g} of max|out|)")
        errs["k8"], errs["k8_rel"] = max(errs["k8"], err), max(errs["k8_rel"], rel)

        ref_idx = retrieval.select_topk(kv, budget, view.length, **sel)
        amax = (view.meta.scale.float().abs() + view.meta.zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * (Hq // Hkv) * q.float().abs().sum(-1).amax() * amax)
        marks = lambda i: torch.zeros_like(masked, dtype=torch.bool).scatter_(
            1, i.reshape(B * Hkv, -1).long(), True)
        near = ((masked - tau[:, None]).abs() <= eps) | (masked == tau[:, None])
        n_ref = int((marks(ref_idx) ^ marks(idx1)).sum())
        if not bool((~(marks(ref_idx) ^ marks(idx1)) | near).all()):
            raise AssertionError("the reference pipeline with use_kernels selects other "
                                 "tokens than K1 on the engine's tensors")
        ref_out = retrieval.fier_decode_reference(
            q, view.k, view.v, view.meta, budget, view.length, group_reduce=group_reduce,
            use_kernels=True, **sel,
        )
        if not torch.isfinite(ref_out).all():
            raise AssertionError("non-finite output of fier_decode_reference(use_kernels=True)")
        errs["ref_swaps"] += n_ref
        errs["ref_gap"] = max(errs["ref_gap"], float((ref_out.float() - out.float()).abs().max()))
        errs["calls"] += 1
        return out

    return checked


def two_pass_path(torch, cfg, params, p3, one):
    """Phase 6: the ``two_pass`` pipeline at full width on the phase 3
    weights and prompts.  The first decode step (from a copy of the prefill
    cache) runs ``two_pass_checks`` and must give phase 3's one_pass logits
    exactly; the unfused building blocks (``ops.pack_quantize`` on the first
    FIER layer's key slab, ``ops.fier_attention_decode`` on every FIER
    layer's tensors of that step) then run counted, K5 held bitwise to its
    plain version; ``generate`` of 32 greedy tokens must give phase 3's
    tokens with K6 = K7 = K2 = 14 × decode steps and nothing else;
    ``count_score_bytes`` of one layer must read 0 for one_pass (slab and
    paged) and at least 2·4·Hq·S·B for two_pass.  Then two_pass and one_pass
    decode steps are timed in turns and profiled (information only)."""
    import dataclasses

    from repro_torch.core.policy import CacheView, DecodePlan, decode_attention
    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import pack_quantize as pq
    from repro_torch.obs.flopcount import count_score_bytes
    from repro_torch.serving import Engine, serving_policy

    eng = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, device=DEVICE,
                       policy=serving_policy(budget=BUDGET, pipeline="two_pass"))
    pol = eng.bundle.policy
    if (pol.pipeline, pol.layout, pol.budget) != ("two_pass", "slab", BUDGET):
        raise AssertionError(f"the two_pass engine's policy is {pol}")
    prompts, lengths = p3["prompts"], p3["lengths"]
    lg0, cache = eng.prefill_batch(params, {"tokens": prompts, "lengths": lengths})
    tok0 = torch.argmax(lg0, -1).to(torch.int32)

    # ---- the first decode step, checked on the engine's own tensors
    errs = {"k8": 0.0, "k8_rel": 0.0, "ref_swaps": 0, "ref_gap": 0.0, "calls": 0}
    calls = []
    real = ops.fier_decode_two_pass
    ops.fier_decode_two_pass = two_pass_checks(torch, errs, calls)
    try:
        step_cache = clone_cache(torch, cache)
        _, lg1, _ = eng.decode(params, tok0, step_cache)
        sync(torch)
    finally:
        ops.fier_decode_two_pass = real
    n_fier = cfg.n_layers - pol.skip_layers
    if errs["calls"] != n_fier:
        raise AssertionError(f"the checked step ran {errs['calls']} FIER layers, not {n_fier}")
    gap = float((lg1[:, : cfg.vocab] - p3["lg1"]).abs().max())
    log(f"  first decode step: max |Δlogit| vs phase 3's one_pass step {gap:.6g} (expected 0)")
    log(f"  per layer on the engine's tensors ({errs['calls']} calls): K6+K7 selection = K1's "
        f"(idx, tau, m bitwise); K8 = K2 bitwise, vs plain max |err| {errs['k8']:.3g} "
        f"({errs['k8_rel']:.3g} of max|out|); reference+use_kernels index sets vs K1: "
        f"{errs['ref_swaps']} near-tau swaps, output max |Δ| vs two_pass {errs['ref_gap']:.3g}")
    if gap != 0.0:
        raise AssertionError("the two_pass first step differs from the one_pass step")

    # ---- the unfused building blocks, counted, on that step's tensors
    reset_launch_counts()
    q0, view0 = calls[0]
    codes, scale, zero = pq.fier_pack_quantize(view0.k, GROUP)
    outs = [ops.fier_attention_decode(q, v.k, v.v, v.meta, BUDGET, v.length)
            for q, v in calls]
    sync(torch)
    counts_bb = launch_counts()
    want = {"pack_quantize": 1, "fier_score": n_fier, "sparse_attention": n_fier}
    for name, n in counts_bb.items():
        if n != want.get(name, 0):
            raise AssertionError(f"building blocks: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    plain = pq.fier_pack_quantize_plain(view0.k, GROUP)
    side = (view0.meta.codes, view0.meta.scale, view0.meta.zero)
    if not all(torch.equal(a, b) for a, b in zip((codes, scale, zero), plain)):
        raise AssertionError("K5 differs from its plain version on the engine's key slab")
    off = [byte_diff(torch, a, b) for a, b in zip((codes, scale, zero), side)]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite fier_attention_decode output")
    log(f"  building blocks on the step's tensors: launches {counts_bb}; K5 bitwise equal to "
        f"its plain version on the first FIER layer's key slab, bytes differing from the "
        f"engine's side-car (codes, scale, zero) {off}")
    del calls, outs, codes, scale, zero, plain, step_cache

    # ---- the counted run
    reset_launch_counts()
    sync(torch)
    t0 = time.perf_counter()
    toks, cache2 = eng.generate(params, prompts, lengths, MAX_NEW, return_cache=True)
    sync(torch)
    t_gen = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(counts, TWO_PASS_KERNELS, n_fier * (MAX_NEW - 1))
    agree = int((toks == p3["toks"]).sum())
    log(f"  launches {counts}: {n_fier} x {MAX_NEW - 1} decode steps")
    log(f"  greedy tokens equal to phase 3's one_pass tokens: {agree}/{toks.numel()}; "
        f"generate {MAX_NEW} tokens {t_gen:.3f} s")
    if agree != toks.numel():
        raise AssertionError("two_pass tokens differ from one_pass tokens")

    # ---- score bytes of one FIER layer at the main-path shape
    rest = cache2["rest"]
    meta = rest["meta"].layer(0)
    length = cache2["length"]
    B, S, Hkv, D = rest["k"][0].shape
    Hq = cfg.n_heads
    q = torch.randn((B, Hq, D), device=DEVICE).to(torch.bfloat16)
    slab = CacheView.slab(rest["k"][0], rest["v"][0], meta, length)
    nb = S // BLOCK_SIZE
    pool = lambda a: a.reshape(B * nb, a.shape[1] // nb, Hkv, D)
    table = torch.arange(B * nb, dtype=torch.int32, device=DEVICE).reshape(B, nb)
    paged = CacheView.paged(pool(slab.k), pool(slab.v), QuantizedKeys(
        pool(meta.codes), pool(meta.scale), pool(meta.zero), GROUP), table, length)
    sb = {}
    for name, view, pipeline in (("one_pass", slab, "one_pass"), ("one_pass_paged", paged, "one_pass"),
                                 ("two_pass", slab, "two_pass"), ("reference", slab, "reference")):
        plan = DecodePlan.build(dataclasses.replace(pol, pipeline=pipeline, layout=view.layout))
        sb[name] = count_score_bytes(lambda q: decode_attention(q, view, plan), S, q)
    floor = 2 * 4 * Hq * S * B
    log(f"  score bytes of one layer (B={B}, Hq={Hq}, S={S}): {sb}; two_pass floor "
        f"2·4·Hq·S·B = {floor}")
    if not (sb["one_pass"] == 0 and sb["one_pass_paged"] == 0 and sb["two_pass"] >= floor
            and sb["reference"] > 0):
        raise AssertionError(f"the score-byte contract fails: {sb}")
    del slab, paged, meta, rest

    # ---- two_pass vs one_pass decode steps in turns (unprofiled), and profiles
    _, cache1 = one.prefill_batch(params, {"tokens": prompts, "lengths": lengths})
    tok1 = tok2 = toks[:, -1].clone()
    ms = {"one_pass": [], "two_pass": []}
    for i in range(2 * EXTRA_STEPS):
        for name in (("one_pass", "two_pass") if i % 2 == 0 else ("two_pass", "one_pass")):
            sync(torch)
            t0 = time.perf_counter()
            if name == "one_pass":
                tok1, _, cache1 = one.decode(params, tok1, cache1)
            else:
                tok2, _, cache2 = eng.decode(params, tok2, cache2)
            sync(torch)
            ms[name].append(1e3 * (time.perf_counter() - t0))
    med = {k: median(v) for k, v in ms.items()}
    log(f"  decode ms/step in turns (median of {2 * EXTRA_STEPS} each, 4 slots): two_pass "
        f"{med['two_pass']:.2f}, one_pass {med['one_pass']:.2f}")
    if DEVICE == "cuda":
        log("  two_pass engine:")
        profile_decode(torch, eng, params, tok2, cache2, None)
        log("  one_pass engine:")
        profile_decode(torch, one, params, tok1, cache1, None)
    del cache, cache1, cache2, eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return counts, counts_bb, errs, dict(step_ms=med, score_bytes=sb)


# ------------------------------------------------------------------ main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[setup] {card}")
    log(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build()
    log(f"[setup] built {sorted(built) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (_, report) in built.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[setup] ptxas {name}: {line.strip()}")

    log("[kernels] each kernel against its plain version")
    timer = Timer(torch)
    shapes = [
        (SLOTS, 16, 1, 128, CAPACITY, "max"),   # olmo-1b main path (MHA)
        (SLOTS, 4, 4, 128, CAPACITY, "sum"),    # GQA
        (SLOTS, 4, 4, 128, CAPACITY, "max"),    # GQA, max
    ]
    rows = check_kernels(torch, timer, shapes)
    rows.update(check_paged_kernels(torch, timer, shapes))
    log("[kernels] K5-K8 and two_pass vs one_pass")
    rows.update(check_unfused_kernels(torch, timer, shapes))
    del timer
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv:  # a quick build-and-check call; no result line
        return 0

    log("[main path] olmo-1b at full width, 4 slots, capacity 8192")
    counts, engine_errs, params, slab, p3 = main_path(torch)
    cfg = slab.bundle.cfg

    log("[paged vs slab] the same prompts through a paged engine, bs 32, default pool")
    counts_p4 = paged_vs_slab(torch, cfg, params, slab)
    torch.cuda.empty_cache()

    log("[serving] ContinuousScheduler, chunk 2048, 8 slots x 8192, pool 621 blocks")
    counts_p5, stream, errs_p5 = serve_stream(torch, cfg, params)
    counts.update({k: counts_p5[k] for k in PAGED_KERNELS})

    log("[two_pass] the two_pass pipeline at full width, the unfused building blocks")
    counts_p6, counts_bb, errs_p6, p6 = two_pass_path(torch, cfg, params, p3, slab)
    del slab
    torch.cuda.empty_cache()
    counts.update({k: counts_p6[k] for k in ("fier_score", "topk_threshold")})
    counts.update({k: counts_bb[k] for k in ("pack_quantize", "sparse_attention")})

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {
        "fier_retrieve": (csrc + "fier_retrieve.cu", "src/repro/kernels/fused_retrieval.py:284"),
        "fier_attend_selected": (csrc + "fier_attend.cu",
                                 "src/repro/kernels/sparse_attention.py:228"),
        "fier_retrieve_paged": (csrc + "fier_retrieve.cu",
                                "src/repro/kernels/fused_retrieval.py:435"),
        "fier_attend_selected_paged": (csrc + "fier_attend.cu",
                                       "src/repro/kernels/sparse_attention.py:358"),
        "pack_quantize": (csrc + "fier_pack.cu", "src/repro/kernels/pack_quantize.py:52"),
        "fier_score": (csrc + "fier_score.cu", "src/repro/kernels/fier_score.py:110"),
        "topk_threshold": (csrc + "fier_topk.cu", "src/repro/kernels/topk_select.py:101"),
        "sparse_attention": (csrc + "fier_attend.cu", "src/repro/kernels/sparse_attention.py:106"),
    }
    # where each count comes from: the run that drove the kernel's path
    launch_runs = {
        "fier_retrieve": "phase 3", "fier_attend_selected": "phase 3",
        "fier_retrieve_paged": "phase 5", "fier_attend_selected_paged": "phase 5",
        "fier_score": "phase 6 two_pass generate", "topk_threshold": "phase 6 two_pass generate",
        "pack_quantize": "phase 6 building blocks", "sparse_attention": "phase 6 building blocks",
    }
    engine_err = {
        "fier_retrieve": engine_errs["k1_tau"], "fier_attend_selected": engine_errs["k2"],
        "fier_retrieve_paged": errs_p5["k1_tau"], "fier_attend_selected_paged": errs_p5["k2"],
        "sparse_attention": errs_p6["k8"],
    }
    kernels = []
    for name, rs in rows.items():
        r = rs[0]  # the main path's shape
        row = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": max([x["max_abs_err"] for x in rs] + [engine_err.get(name, 0.0)]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "check": "pass",
            "gqa_ms": rs[1]["ms"], "gqa_bound_ms": rs[1]["bound_ms"],
            "launches_run": launch_runs[name],
        }
        if name in PAGED_KERNELS:
            # launches above: the serving run (phase 5); the paged-vs-slab run too
            row["launches_paged_vs_slab"] = counts_p4[name]
        if name == "fier_attend_selected":
            row["launches_two_pass"] = counts_p6[name]
        if name == "pack_quantize":
            row["bytes_off_side_car_bf16"] = r["bytes_off_side_car_bf16"]
            row["bytes_off_side_car_f32"] = r["bytes_off_side_car_f32"]
        if r["library_ms"] is None:
            row["library_note"] = "no single PyTorch call computes this function"
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
