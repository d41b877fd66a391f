#!/usr/bin/env python3
"""Where the two-pass kernels K6 (``fier_score.cu``) and K7 (``fier_topk.cu``)
of the PyTorch/CUDA port spend their time, on one GPU.

    python3 tools/probe_score_topk.py [--baseline DIR]

``DIR`` holds an earlier ``fier_score.cu``, ``fier_topk.cu`` and
``fier_common.cuh`` (the one-block-per-row K7 and the many-wave K6, e.g.
from ``git show <commit>:src/repro_torch/kernels/csrc/...`` of an earlier
commit).  All timings
use ``chip_smoke.Timer`` (L2 flushed before every launch) at the serving
shape (B 4, 16 kv heads, S 8192) and the GQA shape (4 kv × 4 query heads):

1. The timer's floors: an empty kernel, and ``x.sum()`` over as many bytes
   as K6 and K7 read, after a write flush and after a read flush.
2. ``%globaltimer`` stamps in copies of the kernels (this checkout's and,
   with ``--baseline``, DIR's), per CTA: K6's start, q staged, its warp 0's
   first chunk scored, end; K7's start, range in shared memory and keys
   formed (this checkout's), each radix pass's own histogram counted and
   its digit chosen (after the cluster's sum, in a cluster; this checkout's
   K7 also split over a cluster of 2), end; with each kernel's occupancy in
   CTAs per SM.
3. K7 against its cluster width C at 8,192 to 131,072 scores per row and
   4, 16 and 64 rows (what ``topk_select.SPLIT_KEYS`` rests on).
4. K7 at one CTA per row with 256 and 1024 threads, and with pass 0
   counted by ``radix_select`` itself.

Scratch copies are built into ``src/repro_torch/kernels/build/probe``.
Prints one line per measurement, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

STAMPS = """
__device__ unsigned long long g_stamps[4096 * 32];
__device__ __forceinline__ void stamp(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 32 + k] = t;
}
"""
READ_STAMPS = """
extern "C" int read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, fier::g_stamps, (size_t)n * 32 * 8);
}
"""
# radix_select: pass p's histogram complete (4 + 2p) and scanned (5 + 2p)
HEADER_STAMPS = [
    ("namespace fier {\n", "namespace fier {\n" + STAMPS),
    ("      __syncthreads();\n    }\n    const int* t = total(p, h);\n",
     "      __syncthreads();\n    }\n    if (threadIdx.x == 0) stamp(4 + 2 * p);\n"
     "    const int* t = total(p, h);\n"),
    ("    __syncthreads();\n    const int jstar = sel[0];\n",
     "    __syncthreads();\n    if (threadIdx.x == 0) stamp(5 + 2 * p);\n    const int jstar = sel[0];\n"),
]
# per kernel source: the edits that place stamps 0 (start), 1, 2 and 15 (end)
SOURCE_STAMPS = {
    "fier_score.cu": [  # stamp 1: q staged, 2: warp 0's first chunk scored
        ("  const size_t row_stride = (size_t)Hkv * D;  // elements between seq rows\n",
         "  const size_t row_stride = (size_t)Hkv * D;  // elements between seq rows\n"
         "  if (tid == 0) stamp(0);\n"),
        ("        q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);\n      __syncthreads();\n",
         "        q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);\n      __syncthreads();\n"
         "      if (tid == 0 && u == (int)blockIdx.x) stamp(1);\n"),
        ("\n        cur = nxt;\n", "\n        if (tid == 0 && c == c0) stamp(2);\n        cur = nxt;\n"),
        ("    }\n  }\n}\n\ntemplate <int kD, int kMaxRep>",
         "    }\n  }\n  __syncthreads();\n  if (tid == 0) stamp(15);\n}\n\n"
         "template <int kD, int kMaxRep>"),
    ],
    "fier_score.cu@baseline": [
        ("  const int S8 = S >> 3;\n", "  const int S8 = S >> 3;\n  if (tid == 0) stamp(0);\n"),
        ("    q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);\n  __syncthreads();\n",
         "    q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);\n  __syncthreads();\n"
         "  if (tid == 0) stamp(1);\n"),
        ("      if (pos < S) out_row[(size_t)r * S + pos] = s;\n    }\n",
         "      if (pos < S) out_row[(size_t)r * S + pos] = s;\n    }\n"
         "    if (tid == 0 && c == c0) stamp(2);\n"),
        ("  }\n}\n\n}  // namespace",
         "  }\n  __syncthreads();\n  if (tid == 0) stamp(15);\n}\n\n}  // namespace"),
    ],
    "fier_topk.cu": [  # stamp 1: range in shared memory, 2: keys formed, pass 0 counted
        ("  const float* s = scores + (size_t)row * S + t0;\n",
         "  const float* s = scores + (size_t)row * S + t0;\n  if (tid == 0) stamp(0);\n"),
        ("    __syncthreads();  // the whole range has landed; hist is zeroed\n",
         "    __syncthreads();  // the whole range has landed; hist is zeroed\n"
         "    if (tid == 0) stamp(1);\n"),
        ("  }\n  __syncthreads();\n\n  auto key_at", "  }\n  __syncthreads();\n  if (tid == 0) stamp(2);\n\n  auto key_at"),
        ("  if (C > 1) cluster.sync();  // no CTA leaves",
         "  if (tid == 0) stamp(15);\n  if (C > 1) cluster.sync();  // no CTA leaves"),
    ],
    "fier_topk.cu@baseline": [
        ("  const float* s = scores + (size_t)blockIdx.x * S;\n",
         "  const float* s = scores + (size_t)blockIdx.x * S;\n  if (threadIdx.x == 0) stamp(0);\n"),
        ("    m_out[blockIdx.x] = m;\n  }\n", "    m_out[blockIdx.x] = m;\n    stamp(15);\n  }\n"),
    ],
}
# per kernel source: CTAs per SM that can be resident, at `smem` dynamic bytes
OCCUPANCY = {
    "fier_score.cu": ("fier_score_kernel<1, 128, 8>", "threads_for<1>()"),
    "fier_score.cu@baseline": ("fier_score_kernel<1>", "kThreads"),
    "fier_topk.cu": ("topk_threshold_kernel<true>", "kThreads"),
    "fier_topk.cu@baseline": ("topk_threshold_kernel", "kThreads"),
}
OCCUPANCY_FN = """
extern "C" int occupancy(int smem, int* n) {{
  auto kernel = {0};
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, {1}, smem);
}}
"""
COLUMNS = {0: "start", 1: "q staged / range landed", 2: "first chunk / keys formed",
           15: "end", **{4 + 2 * p: f"pass {p} counted" for p in range(4)},
           **{5 + 2 * p: f"pass {p} scanned" for p in range(4)}}


def log(*a):
    print(*a, flush=True)


def copy_with(src_dir, name, out_dir, edits, header_edits=(), extra=""):
    """``src_dir/name`` and its header, edited, into ``out_dir``; the .cu path."""
    os.makedirs(out_dir, exist_ok=True)
    for fname, reps, tail in ((name, edits, extra), ("fier_common.cuh", header_edits, "")):
        text = open(os.path.join(src_dir, fname)).read()
        for a, b in reps:
            if a not in text:
                raise RuntimeError(f"{fname}: no anchor {a!r}")
            text = text.replace(a, b, 1)
        open(os.path.join(out_dir, fname), "w").write(text + tail)
    return os.path.join(out_dir, name)


def build_all(jobs):
    """{tag: .cu path} → {tag: CDLL}, one nvcc each, all at once."""
    from repro_torch.kernels import build

    procs = {}
    for tag, src in jobs.items():
        lib = src[:-3] + ".so"
        procs[tag] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for tag, (p, lib) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{err}")
        regs = [ln.split(":", 1)[1].strip() for ln in err.splitlines() if "Used" in ln]
        log(f"  built {tag}: {'; '.join(regs)}")
        libs[tag] = ctypes.CDLL(os.path.abspath(lib))
    return libs


def launcher(lib, kind, baseline):
    """The launch entry of a built copy with its argument types."""
    if kind == "score":
        f = lib.fier_score_launch
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (6 if baseline else 9) + [ctypes.c_void_p]
    else:
        f = lib.fier_topk_launch
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (3 if baseline else 6) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import topk_select as tk

    if not torch.cuda.is_available():
        print("probe_score_topk: no GPU", file=sys.stderr)
        return 2
    base_dir = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    log(cs.card_line())
    csrc = os.path.join(HERE, "src/repro_torch/kernels/csrc")
    out = str(build.BUILD_DIR / "probe")
    jobs = {}
    for name in ("fier_score.cu", "fier_topk.cu"):
        jobs[f"{name} stamped"] = copy_with(
            csrc, name, os.path.join(out, "stamped"), SOURCE_STAMPS[name], HEADER_STAMPS,
            READ_STAMPS + OCCUPANCY_FN.format(*OCCUPANCY[name]))
        if base_dir:
            key = name + "@baseline"
            jobs[f"{name} baseline stamped"] = copy_with(
                base_dir, name, os.path.join(out, "baseline"), SOURCE_STAMPS[key], HEADER_STAMPS,
                READ_STAMPS + OCCUPANCY_FN.format(*OCCUPANCY[key]))
    threads = ("constexpr int kThreads = 512;", "constexpr int kThreads = {};")
    for n in (256, 1024):
        jobs[f"K7 {n} threads"] = copy_with(csrc, "fier_topk.cu", os.path.join(out, f"t{n}"),
                                            [(threads[0], threads[1].format(n))])
    jobs["K7 pass 0 in radix_select"] = copy_with(csrc, "fier_topk.cu", os.path.join(out, "rs0"), [
        ("        count_digit(hist, k[e], in, 0u, 0u, 24, lane);  // radix pass 0\n", ""),
        ("cluster_total, kSmemKeys, tau_key, m);", "cluster_total, false, tau_key, m);")])
    libs = build_all(jobs)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    timer = cs.Timer(torch)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[floors] empty kernel {cs.empty_kernel_ms(torch, timer):.4f} ms")

    def score_call(f, baseline, q, qk, o):
        B, Hkv, rep, D = q.shape
        S = qk.codes.shape[1] * 8
        p = fs.score_plan(S, B * Hkv, n_sm)
        args = [q.data_ptr(), qk.codes.data_ptr(), qk.scale.data_ptr(), qk.zero.data_ptr(),
                o.data_ptr(), B, S, Hkv, rep, D, cs.GROUP]
        args += [] if baseline else [p.parts, p.part_chunks, p.grid]
        return lambda: f(*args, stream()), (p.grid if not baseline else B * Hkv * (-(-S // 512)))

    def topk_call(f, baseline, rows, tau, m, C=None):
        R, S = rows.shape
        p = tk.topk_plan(S, R, n_sm)
        C = p.cluster if C is None else C
        T = -(-(-(-S // 32)) // C) * 32
        args = [rows.data_ptr(), tau.data_ptr(), m.data_ptr(), R, S, cs.BUDGET]
        args += [] if baseline else [C, T, int(4 * T + 16 + tk.SMEM_STATIC <= tk.SMEM_LIMIT)]
        return lambda: f(*args, stream()), (R if baseline else R * C)

    def stamps(lib, fn, n_ctas, title, smem=0):
        occ = ctypes.c_int(0)
        lib.occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
        if lib.occupancy(smem, ctypes.byref(occ)) != 0:
            raise RuntimeError("the occupancy query failed")
        fn()
        torch.cuda.synchronize()
        timer.flush_buf.zero_()
        torch.cuda._sleep(5_000_000)
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (n_ctas * 32))()
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if lib.read_stamps(ctypes.addressof(buf), n_ctas) != 0:
            raise RuntimeError("reading the stamps failed")
        a = np.frombuffer(buf, dtype=np.uint64).reshape(n_ctas, 32).astype(np.int64)
        t0 = a[:, 0].min()
        log(f"  {title}: {n_ctas} CTAs, {occ.value} resident per SM at most; µs after the "
            f"first CTA's start, median / max:")
        for k, label in sorted(COLUMNS.items(), key=lambda kv: (kv[0] == 15, kv[0])):
            if (a[:, k] > 0).all():
                rel = (a[:, k] - t0) / 1e3
                log(f"    {label:>26} {np.median(rel):8.3f} {rel.max():8.3f}")

    for (B, Hkv, rep) in ((cs.SLOTS, 16, 1), (cs.SLOTS, 4, 4)):
        D, S = 128, cs.CAPACITY
        q, _, _, qk, lengths = cs.make_inputs(torch, B, Hkv, rep, D, S, seed=rep + 20)
        s = fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=cs.GROUP)
        masked = fr.masked_kv(s, lengths, cs.SINK, cs.RECENT, "max").reshape(B * Hkv, S)
        tau_p, m_p = tk.fier_topk_threshold_plain(masked, cs.BUDGET)
        shape = (B, Hkv, rep, D, S)
        for what, nbytes in (("K6", cs.score_work(q, qk.codes, qk.scale, qk.zero, s)["bytes"]),
                             ("K7", cs.topk_work(masked)["bytes"])):
            flat = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
            log(f"[floors] {shape} x.sum() over {what}'s {nbytes} B: write flush "
                f"{timer(lambda: flat.sum()):.4f} ms, read flush "
                f"{timer(lambda: flat.sum(), clean=True):.4f} ms")
            del flat
        for which in ("", " baseline") if base_dir else ("",):
            bl = bool(which)
            o = torch.empty_like(s)
            f6 = launcher(libs[f"fier_score.cu{which} stamped"], "score", bl)
            fn, n = score_call(f6, bl, q, qk, o)
            stamps(libs[f"fier_score.cu{which} stamped"], fn, n, f"K6{which} {shape}")
            if not torch.equal(o, s):
                raise AssertionError(f"K6{which} (stamped) differs from K6")
            tau = torch.empty_like(tau_p)
            m = torch.empty_like(m_p)
            f7 = launcher(libs[f"fier_topk.cu{which} stamped"], "topk", bl)
            fn, n = topk_call(f7, bl, masked, tau, m)
            smem = 0 if bl else tk.topk_plan(S, B * Hkv, n_sm).smem_bytes
            stamps(libs[f"fier_topk.cu{which} stamped"], fn, n, f"K7{which} {shape}", smem)
            if not bl:  # the same row split over a cluster of 2: its barrier and DSMEM sum
                fn, n = topk_call(f7, bl, masked, tau, m, C=2)
                stamps(libs["fier_topk.cu stamped"], fn, n, f"K7 {shape} at C = 2",
                       4 * (-(-S // 64) * 32) + 16)
                if not (torch.equal(tau, tau_p) and torch.equal(m, m_p)):
                    raise AssertionError("K7 at C = 2 (stamped) differs from its plain version")
            if not (torch.equal(tau, tau_p) and torch.equal(m, m_p)):
                raise AssertionError(f"K7{which} (stamped) differs from its plain version")
        t = {}
        for tag in ("K7 256 threads", "K7 1024 threads", "K7 pass 0 in radix_select"):
            tau = torch.empty_like(tau_p)
            m = torch.empty_like(m_p)
            fn, _ = topk_call(launcher(libs[tag], "topk", False), False, masked, tau, m)
            fn()
            torch.cuda.synchronize()
            if not (torch.equal(tau, tau_p) and torch.equal(m, m_p)):
                raise AssertionError(f"{tag} differs from its plain version")
            t[tag] = fn
        t["K7"] = lambda: tk.fier_topk_threshold(masked, cs.BUDGET)
        ms = {k: [] for k in t}
        for order in (list(t), list(t)[::-1]):
            for k in order:
                ms[k].append(timer(t[k]))
        log(f"[variants] {shape} (one CTA per row): " +
            ", ".join(f"{k} {sum(v) / 2:.4f}" for k, v in ms.items()) + " ms")

    log("[K7 against C] one wave of one CTA per SM holds rows·C <= "
        f"{n_sm}; SPLIT_KEYS = {tk.SPLIT_KEYS}")
    f7 = tk._kernel()
    for S in (8192, 16384, 32768, 65536, 131072):
        for R in (4, 16, 64):
            rows = cs.topk_rows(torch, R, S, seed=S + R)
            tau_p, m_p = tk.fier_topk_threshold_plain(rows, cs.BUDGET)
            fns = {}
            for C in (1, 2, 4, 8):
                T = -(-(-(-S // 32)) // C) * 32
                if tk.SMEM_STATIC + 4 * T + 16 > tk.SMEM_LIMIT:
                    continue
                tau = torch.empty_like(tau_p)
                m = torch.empty_like(m_p)
                fn, _ = topk_call(f7, False, rows, tau, m, C)
                fn()
                torch.cuda.synchronize()
                if not (torch.equal(tau, tau_p) and torch.equal(m, m_p)):
                    raise AssertionError(f"K7 at C={C} differs from its plain version")
                fns[C] = fn
            ms = {C: [] for C in fns}
            for order in (list(fns), list(fns)[::-1]):
                for C in order:
                    ms[C].append(timer(fns[C]))
            log(f"  S {S} rows {R}: " + ", ".join(f"C={C} {sum(v) / 2:.4f}" for C, v in ms.items())
                + f" ms; the plan takes C={tk.topk_plan(S, R, n_sm).cluster}")
    return 0



if __name__ == "__main__":
    sys.exit(main())
