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
   group 32, budget 1024) and at one GQA shape (4 kv heads × 4 query heads),
   with per-row lengths that include one row shorter than the budget; then
   the kernel, its plain version and one library call timed in turns with
   the L2 cache flushed before every launch.
3. The main path at full olmo-1b width (random weights from a seeded
   ``torch.Generator``): ``Engine.build`` with the default policy,
   ``generate`` of 32 greedy tokens for 4 prompts, then ``insert`` of a
   fifth prompt into a freed slot and 8 ``decode(active=...)`` steps.  Every
   kernel must have launched 14 × (decode steps) times (16 layers − 2 skip
   layers).  The same engine built with ``pipeline='reference'`` (no custom
   kernel) gives identical prefill logits.  The first decode step is run
   with the kernels, with their plain versions (each layer's kernel inputs
   compared on the way), and with two planted faults: its logits must lie
   near the plain run's and the reference pipeline's, and each fault's
   must not (``first_step_checks``).
4. One JSON line ``{"kernels": [...]}`` with each kernel's check, times,
   bound and launch count, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
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
    medians of each."""
    t = {"plain": [], "kernel": [], "library": []}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        fn = {"plain": plain, "kernel": kernel, "library": library}[name]
        t[name].append(timer(fn))
    return {k: sum(v) / len(v) for k, v in t.items()}


# ------------------------------------------------------------ phase 2

def make_inputs(torch, B, Hkv, rep, D, S, seed):
    import numpy as np

    from repro_torch.core.quantize import quantize

    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D)).astype(np.float32)  # per-channel spread
    K = torch.from_numpy((rng.standard_normal((B, S, Hkv, D)) * ch).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, rep, D)).astype(np.float32))
    K, V, q = (t.to("cuda", torch.bfloat16) for t in (K, V, q))
    qk = quantize(K, GROUP)
    lengths = torch.tensor([S, 5003, 2100, 700][:B], dtype=torch.int32, device="cuda")
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
        kv, _ = fr.masked_keys(s, lengths, SINK, RECENT, reduce)
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
    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S, r["flops"] / F32_FLOPS)
            r["bound_by"] = (
                "bytes" if r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS
                else "operations"
            )
            log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
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
    engine_errs = first_step_checks(
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
    expect = (N_LAYERS - SKIP) * steps
    for name, n in counts.items():
        if n != expect:
            raise AssertionError(f"{name} launched {n} times, expected {expect}")
    log(f"  launches {counts} == {N_LAYERS - SKIP} x {steps} decode steps")

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
    return counts, engine_errs


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
    largest K1 τ error and K2 error of the per-layer comparisons."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels.check import selection_agrees

    def step(retrieve=fr.fier_retrieve, attend=sa.fier_attend_selected):
        ops.fier_retrieve, ops.fier_attend_selected = retrieve, attend
        try:
            _, lg, _ = eng.decode(params, tok0, clone_cache(torch, cache))
            torch.cuda.synchronize()
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
        return lg[:, :vocab]

    errs = {"k1_tau": 0.0, "k1_swaps": 0, "k2": 0.0, "k2_rel": 0.0}

    def checked_retrieve(q, codes, scale, zero, lengths, budget, **sel):
        got = fr.fier_retrieve(q, codes, scale, zero, lengths, budget, **sel)
        want = fr.fier_retrieve_plain(q, codes, scale, zero, lengths, budget, **sel)
        B, Hkv, rep, D = q.shape
        s = fr.retrieval_scores(q, codes, scale, zero, group=sel["group"])
        kv, _ = fr.masked_keys(s, lengths, sel["sink"], sel["recent"], sel["group_reduce"])
        amax = (scale.float().abs() + zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)
        ok, ndiff = selection_agrees(
            *(x.reshape(B * Hkv, -1) for x in (got[0], want[0])),
            *(x.reshape(-1) for x in (got[1], want[1], got[2], want[2])),
            kv.reshape(B * Hkv, -1), eps,
        )
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version on the engine's "
                                 f"tensors: {ndiff} indices, eps {eps:.3g}")
        d_tau = torch.where(got[1] == want[1], 0.0, (got[1] - want[1]).abs()).max()
        errs["k1_tau"] = max(errs["k1_tau"], float(d_tau))
        errs["k1_swaps"] += ndiff
        return want

    def checked_attend(q, K, V, idx, lengths=None):
        got = sa.fier_attend_selected(q, K, V, idx, lengths)
        want = sa.fier_attend_selected_plain(q, K, V, idx, lengths)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= K2_REL_TOL:
            raise AssertionError(f"K2 disagrees with its plain version on the engine's "
                                 f"tensors: {err:.3g} ({rel:.3g} of max|out|)")
        errs["k2"], errs["k2_rel"] = max(errs["k2"], err), max(errs["k2_rel"], rel)
        return want

    def shifted_attend(q, K, V, idx, lengths=None):
        return sa.fier_attend_selected(q, K, V, (idx + 1) % K.shape[1], lengths)

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
    log(f"  per layer on the engine's tensors: K1 index sets agree ({errs['k1_swaps']} "
        f"near-tau swaps), max tau err {errs['k1_tau']:.3g}; K2 max |err| "
        f"{errs['k2']:.3g} ({errs['k2_rel']:.3g} of max|out|)")
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
    return errs


def profile_decode(torch, eng, params, tok, cache, active, steps: int = 3):
    """Device busy share of decode steps and the kernels that fill it
    (torch.profiler; the profiler's own overhead slows the host side, so
    the busy share is a lower bound on an unprofiled step's).  Only kernel
    rows are summed: an operator row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
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
    log(f"  profiled {steps} decode steps: wall {wall_us / steps / 1e3:.2f} ms/step, "
        f"device busy {busy_us / steps / 1e3:.3f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% busy, {100 - 100 * busy_us / wall_us:.1f}% idle)")
    for e in sorted(events, key=dev, reverse=True)[:10]:
        log(f"    {dev(e) / steps / 1e3:8.3f} ms/step  {e.count // steps:5d} calls/step  "
            f"{e.key[:90]}")


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
    rows = check_kernels(torch, timer, [
        (SLOTS, 16, 1, 128, CAPACITY, "max"),   # olmo-1b main path (MHA)
        (SLOTS, 4, 4, 128, CAPACITY, "sum"),    # GQA
    ])
    del timer
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv:  # a quick build-and-check call; no result line
        return 0

    log("[main path] olmo-1b at full width, 4 slots, capacity 8192")
    counts, engine_errs = main_path(torch)

    sources = {
        "fier_retrieve": ("src/repro_torch/kernels/csrc/fier_retrieve.cu",
                          "src/repro/kernels/fused_retrieval.py:284"),
        "fier_attend_selected": ("src/repro_torch/kernels/csrc/fier_attend.cu",
                                 "src/repro/kernels/sparse_attention.py:228"),
    }
    kernels = []
    for name, rs in rows.items():
        r = rs[0]  # the main path's shape
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": max(
                [x["max_abs_err"] for x in rs]
                + [engine_errs["k1_tau" if name == "fier_retrieve" else "k2"]]
            ),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "check": "pass",
            "gqa_ms": rs[1]["ms"], "gqa_bound_ms": rs[1]["bound_ms"],
        })
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
