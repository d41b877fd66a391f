// K2 fier_attend_selected and K4 fier_attend_selected_paged: fused
// select-and-attend decode attention for Hopper (sm_90a), over a slab cache
// (K2) or a paged block pool (K4); and K8 fier_attend_gathered, the same
// attention over rows gathered beforehand: the kernel body and its launch,
// built by fier_attend.cu, fier_attend_paged.cu and fier_attend_gathered.cu
// (the fixed instantiations of K2, K4 and K8) and fier_attend_any.cu (the
// generic layout of all three), one library each, so that they compile in
// parallel.
//
// K2 replaces the TPU kernel
// repro/kernels/sparse_attention.py::fused_sparse_attention_hm (pallas_call at
// :228, body _fused_kernel :133, online softmax _softmax_accumulate :39).  K4
// replaces paged_fused_sparse_attention_hm (pallas_call at :358, body
// _paged_fused_kernel :262).  K8 replaces sparse_attention_hm (pallas_call at
// :106, body _kernel :64).
//
// What bounds it on the card: bytes.  Per (batch, kv-head) row it reads the
// valid ones of its `budget` selected K rows and V rows (2 x D x 2 bytes
// each) from the seq-major [B, S, Hkv, D] cache slabs, plus idx, q and the
// f32 output.  At the serving shape (B = 4, Hkv = 16, budget = 1024, D = 128,
// lengths 8192/5003/2100/700) that is 31,211,536 B: 0.00932 ms at
// 3.35 TB/s.  The arithmetic is 2 x rep FLOP per 2 bytes of K (and of V),
// far below the card's ridge at rep <= 8, so it stays in f32 FMAs: tensor
// cores would not move the bound.  What the design must do is keep enough
// scattered 256-byte rows in flight to cover the memory latency.
//
// Design: one launch per call.
//   * Each (b, h) row's `budget` slots are split over a thread-block
//     cluster of C <= 8 CTAs of 256 threads (sparse_attention.attend_plan
//     picks C from budget, B x Hkv, rep and the SM count, never from the
//     address policy: one CTA per SM, C = 2 at the serving shape); CTA r
//     takes slots [r budget / C, (r + 1) budget / C).
//   * A CTA first finds the row of every slot of its range (up to
//     kMaxChunk = 2048 slots at a time; one chunk unless its range is
//     longer): the idx reads are independent and unrolled, so they cost one
//     memory latency, not one per slot as they would inside the copy loop
//     (K4: one more for the block-table entries, each read once per slot).
//     The rows, -1 for a masked slot, sit in shared memory.
//   * Its 16 row groups of 16 lanes then stream their slots (group g takes
//     slots g, g + 16, ...) through a ring in shared memory, kBatch = 4 rows
//     a step and kRing = 3 steps deep: each lane issues cp.async.cg 16-byte
//     copies of its 8 channels of the K row and the V row, so a CTA keeps up
//     to 12 rows per group (96 KiB) in flight.  A masked slot (idx >=
//     length, or mask == 0 for K8) is never read: its copies have source
//     size 0, which zero-fills the shared row.  A lane reads back only the
//     bytes it copied itself, so waiting for its own copies is enough and
//     the steps need no barrier: no group waits for another.
//   * Per step and group: q . k of 4 rows (q in registers, f32, a xor
//     butterfly over the 16 lanes, times 1/sqrt(D); masked slots -1e30), an
//     online softmax per query head (the group's running max, denominator
//     and accumulators rescaled by exp(m_old - m_new) once per step), then
//     p . v into the lane's f32 accumulators.  rep is a template parameter
//     (1, 2, 4, 8), so q and the accumulators take registers for the real
//     rep only.
//   * The combine: the CTA merges its 16 groups' (m, den, unnormalised o)
//     in group order and writes the result into its own slot of rank 0's
//     shared memory through distributed shared memory (after waiting on a
//     cluster barrier phase every CTA arrived at when it started).  One
//     cluster barrier (arrive.release, wait.acquire) makes every slot
//     visible to rank 0, which merges the slots in rank order and writes
//     out / max(den, 1e-30); the other ranks exit, since no CTA reads their
//     shared memory.  No partial result reaches device memory, and every
//     sum runs in a fixed order, so the output is deterministic.
// Why groups and not the whole CTA: a CTA-wide step (scores, one warp's
// softmax, p . v, three barriers) measured 2 us per 32 KiB at rep 1 and
// 5 us at rep 4, slower than the memory delivers them (PERF.md).
//
// d_head and rep.  d_head (16, 32, 64, 112 or 128) is a template parameter:
// a row takes kLPR lanes of 8 channels (16 bytes) each, D/8 rounded up to a
// power of two and at least 8, so at 64 a CTA has 32 lane groups of 8 lanes
// and takes 128 slots a step; the ring keeps 96 KiB of K/V rows in flight at
// each.  At 32 and 16 (the reduced configs) a row is 4 or 2 such chunks and
// takes an 8-lane group as at 64, its other lanes idle as at 112 below:
// narrower groups would take more slot groups, and at rep 16 their merge
// scratch (128 slot groups x 16 heads x (16 + 2) floats, 147,456 B) would
// not fit the 96 KiB ring it reuses.  At 112
// (zamba2-7b's shared attention block) a row is 14 such chunks (224 bytes,
// so the 16-byte cp.async stays aligned) and takes a 16-lane group as at
// 128, with lanes 14 and 15 idle: they copy nothing (source size 0
// zero-fills their ring chunks) and hold q = 0, so they add exact zeros to
// the butterfly and keep zero accumulators.  A 14-lane group would not
// divide a warp: the xor butterfly, the ring's layout and the merge are built
// for power-of-two groups, and 16 keeps them as they are at 128 (the ring
// carries 1/8 padding there).  Only rep 1 is instantiated at 112 (zamba2-7b
// has 32 kv heads of 32 query heads).  rep is a template parameter up to 8 as above.  At rep
// 12 and 16 (starcoder2-3b, qwen3-moe) a lane holding every query head would
// keep 16 x 8 q values and as many accumulators, with the running maxima,
// denominators and a step's scores: over 255 registers, so it would spill.
// There the query heads are split instead: the two lane groups of a warp
// half form one slot group that shares its K/V rows in the ring (the lower
// group copies the K row, the upper the V row, and a __syncwarp after the
// copies land makes each half's copies visible to the other), and each
// lane group keeps rep/2 query heads: the registers of rep 6 or 8.  A slot
// group then takes half as many slots per step, so the ring is twice as
// deep (6 steps) to keep the same 96 KiB of rows in flight.  The rows are
// read once for all rep heads; the merges run over slot groups in order.
//
// Every other (d_head, rep), d_head a multiple of 8 up to 256, runs a
// generic instantiation (kAny) of a layout class kD = 64, 128 or 256 (the
// widest d_head it takes; a row takes kD / 8 lanes: 8, 16 or 32) and a
// block of kRep query heads (1, 2, 4, 8 or 16; at most 8 in the 256 class,
// whose 32-lane groups leave no room for a head split), with d_head and rep
// run-time values.  Its lanes past d_head / 8 idle as at 112.  A CTA
// attends for one block of query heads: the grid takes ceil(rep / kRep)
// blocks per (b, h) row (clusters of C CTAs each, as before), and the
// heads of the last block past rep hold q = 0 and write nothing (rep 7
// takes one block of 8, one head idle; rep 71 five blocks of 16, nine
// idle).  The blocks of a row read its selected K/V rows each, at about
// the same time, so mostly from L2.  A loop over head blocks inside the
// CTA would read them from the ring again and keep the row's softmax in
// registers per block; the grid keeps the kernel body as it was.

// K4 differs only where a slot's row is found (address policy kPaged): the
// logical index t becomes the pool row table[b, t / bs] * bs + t % bs of the
// K/V pools [N, bs, Hkv, D] (a shift and a mask when bs is a power of two;
// K2: b * S + t of the slabs); a masked slot's table entry is never read.
// K8 is a third policy (kGathered): row t of (b, h) of k_sel / v_sel
// [B, budget, Hkv, D] (what gather_kv returns) at the element offset
// b * sb + t * st + h * sh given by the tensors' strides (channels
// contiguous), valid where mask[b, h, t] != 0.  The plan, the stages and the
// arithmetic are shared, so on the same logical contents K4's output and
// K8's (on gather_kv(K, V, idx) with idx < length) are K2's bit for bit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;            // slots a slot group takes per step
constexpr int kMaxCluster = 8;
constexpr int kMaxChunk = 2048;      // slots whose rows a CTA holds at once (4 bytes each)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kMasked = -1e30f;    // a masked slot's score, as the reference masks
constexpr int kRingBytes = 98304;    // sparse_attention.RING_BYTES, at every (D, rep)

// How an instantiation (d_head kD, rep kRep) lays a CTA out.
template <int kD, int kRep>
struct Layout {
  static constexpr int kLanesUsed = kD / 8;          // lanes that own 8 channels (16 bytes) of a row
  static constexpr int kLPR = kLanesUsed <= 8 ? 8 : kLanesUsed <= 16 ? 16 : 32;  // a power of 2
  static constexpr int kGroups = kThreads / kLPR;    // lane groups of kLPR lanes
  static constexpr int kSplit = kRep > 8 ? 2 : 1;    // lane groups sharing a slot's rows
  static constexpr int kRepL = kRep / kSplit;        // query heads per lane group
  static constexpr int kSlotGroups = kGroups / kSplit;
  static constexpr int kRing = 3 * kSplit;           // steps of a slot group in shared memory
  static constexpr int kStep = kSlotGroups * kBatch;  // slots the CTA takes per step
  // the ring: K rows [kRing][kSlotGroups][kBatch] of kLPR 16-byte chunks, then V rows alike
  static constexpr int kRingChunks = kRing * kSlotGroups * kBatch * kLPR;
  static_assert(kRep % kSplit == 0 && kRepL <= 8, "a lane group keeps at most 8 query heads");
  static_assert(2 * kRingChunks * 16 == kRingBytes, "the ring is 96 KiB at every (D, rep)");
  static_assert(kSlotGroups * kRep * (kD + 2) * 4 <= kRingBytes, "the merge reuses the ring");
  static_assert(kSplit * kLPR <= 32, "a slot group's lane groups share one warp");
  static_assert(kD % 8 == 0 && kLanesUsed <= kLPR, "a row fits its lane group");
};

// dynamic shared memory: the ring, rank 0's receive slots, the chunk's rows
// (sparse_attention.AttendPlan.smem_bytes)
template <int kD, int kRep>
constexpr size_t smem_bytes(int C, int chunk) {
  return kRingBytes + (size_t)C * kRep * (kD + 2) * 4 + (size_t)chunk * 4;
}

// Where a slot finds its rows (template argument of fier_attend_kernel).
constexpr int kSlab = 0;      // K2: K/V [B, S, Hkv, D], rows idx[t]
constexpr int kPaged = 1;     // K4: K/V [N, bs, Hkv, D] through table [B, S / bs]
constexpr int kGathered = 2;  // K8: K/V [B, budget, Hkv, D], row t, validity mask[t]

__device__ __forceinline__ void bf16x8_to_float(const uint4& w, float (&out)[8]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(v[i] << 16);
    out[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
  }
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 reads nothing and
// zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kAny: the generic layout of class kD at d_head D_any, rep_any query heads
// per kv head in blocks of kRep (fixed instantiations: kD and kRep).
// kAddr = kSlab (K2): K/V [B, S, Hkv, D], table and mask unused.
// kAddr = kPaged (K4): K/V [N, bs, Hkv, D], table [B, S / bs]; bsh = log2(bs)
// when bs is a power of two, else -1.  kAddr = kGathered (K8): K/V
// [B, budget, Hkv, D] with element strides (sb, st, sh), mask
// [B, Hkv, budget]; table, idx and lengths unused.
template <int kAddr, int kD, int kRep, bool kAny>
__global__ void __launch_bounds__(kThreads)
fier_attend_kernel(const void* __restrict__ q,               // [B, Hkv, rep, D] bf16 or f32
                   const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V,
                   const int* __restrict__ table,            // [B, S / bs] (K4)
                   const int* __restrict__ idx,              // [B, Hkv, budget] (K2, K4)
                   const int* __restrict__ lengths,          // [B] (K2, K4)
                   const int8_t* __restrict__ mask,          // [B, Hkv, budget] (K8)
                   float* __restrict__ out,                  // [B, Hkv, rep, D]
                   int S, int Hkv, int budget, float scale, int bs, int bsh,
                   long long sb, long long st, long long sh, int chunk, int q_bf16,
                   int D_any, int rep_any) {
  using L = Layout<kD, kRep>;
  const int D = kAny ? D_any : kD;        // d_head; kD is the row stride of the merge scratch
  const int rep = kAny ? rep_any : kRep;  // query heads per kv head
  const int n_blk = kAny ? (rep + kRep - 1) / kRep : 1;  // blocks of kRep query heads
  constexpr int kLPR = L::kLPR, kSplit = L::kSplit, kRepL = L::kRepL;
  constexpr int kSlotGroups = L::kSlotGroups, kRing = L::kRing, kStep = L::kStep;
  extern __shared__ __align__(16) unsigned char dyn[];
  uint4* kring = reinterpret_cast<uint4*>(dyn);  // [kRing][kSlotGroups][kBatch][kLPR]
  uint4* vring = kring + L::kRingChunks;          // the same for V

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  // rank 0 receives each rank's unnormalised output and (max, denominator)
  float* recv_o = reinterpret_cast<float*>(dyn + kRingBytes);    // [C][kRep][kD]
  float* recv_md = recv_o + C * kRep * kD;                       // [C][kRep][2]
  int* rows_s = reinterpret_cast<int*>(recv_md + C * kRep * 2);  // [chunk]: row, -1 masked
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / C;  // (b * Hkv + h) * n_blk + the block of query heads
  const int bh = unit / n_blk;      // b * Hkv + h
  const int hb0 = (unit - bh * n_blk) * kRep;  // the block's first query head
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int gid = tid / kLPR;       // lane group
  const int sl = tid % kLPR;        // lane within the row: channels 8*sl .. 8*sl+7
  // whether the lane owns channels (a constant true unless d_head pads the group)
  const bool lane_on = kAny ? sl < D / 8 : L::kLanesUsed == kLPR || sl < L::kLanesUsed;
  const int sg = gid / kSplit;      // slot group
  const int h0 = gid % kSplit * kRepL;  // this lane group's first query head
  const int s0 = (int)((long long)rank * budget / C);  // this CTA's slots [s0, s1)
  const int s1 = (int)((long long)(rank + 1) * budget / C);
  // Every CTA of the cluster must have started before any writes into rank
  // 0's shared memory: arrive now, wait (long since complete) before the push.
  cluster_arrive_relaxed();

  float qr[kRepL][8];  // bf16 q converts exactly; no cast kernel before the launch
#pragma unroll
  for (int r = 0; r < kRepL; ++r) {
    const size_t e = ((size_t)bh * rep + hb0 + h0 + r) * D + sl * 8;
    if (!lane_on || (kAny && hb0 + h0 + r >= rep)) {  // an idle lane or query head
#pragma unroll
      for (int k = 0; k < 8; ++k) qr[r][k] = 0.0f;
    } else if (q_bf16) {
      bf16x8_to_float(*reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + e),
                      qr[r]);
    } else {
      const float4* qp = reinterpret_cast<const float4*>(static_cast<const float*>(q) + e);
      const float4 a = qp[0], z = qp[1];
      qr[r][0] = a.x; qr[r][1] = a.y; qr[r][2] = a.z; qr[r][3] = a.w;
      qr[r][4] = z.x; qr[r][5] = z.y; qr[r][6] = z.z; qr[r][7] = z.w;
    }
  }

  // element offset of (b, h)'s channel 0 in a row, and row length in elements
  size_t head_off, row_elems;
  if constexpr (kAddr == kGathered) {
    head_off = (size_t)(b * sb + h * sh);
    row_elems = (size_t)st;
  } else {
    head_off = (size_t)h * D;
    row_elems = (size_t)Hkv * D;
  }
  const int length = kAddr == kGathered ? 0 : lengths[b];
  const int* trow = kAddr == kPaged ? table + (size_t)b * (S / bs) : nullptr;

  // the group's running softmax: the same values in all 16 lanes (a xor
  // butterfly gives every lane the same sums)
  float m_run[kRepL], den_run[kRepL], acc[kRepL][8];
#pragma unroll
  for (int r = 0; r < kRepL; ++r) {
    m_run[r] = kMasked;
    den_run[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;
  }

  // The range in chunks of at most `chunk` slots (one chunk unless the
  // budget is very large): the chunk's rows first, then its steps.
  for (int c0 = s0; c0 < s1; c0 += chunk) {
    const int m = min(chunk, s1 - c0);
    __syncthreads();  // every thread is done with the previous chunk's rows
    // ---- every slot's row at once: independent loads, unrolled, so one
    // memory latency (two for K4: idx, then the table entry) per chunk
#pragma unroll 4
    for (int i = tid; i < m; i += kThreads) {
      if constexpr (kAddr == kGathered) {
        rows_s[i] = mask[(size_t)bh * budget + c0 + i] != 0 ? c0 + i : -1;
      } else {
        const int r = idx[(size_t)bh * budget + c0 + i];
        const bool valid = (r < length) && (r >= 0) && (r < S);
        rows_s[i] = !valid ? -1 : kAddr == kSlab ? b * S + r : r;
      }
    }
    if constexpr (kAddr == kPaged) {
      __syncthreads();
#pragma unroll 4
      for (int i = tid; i < m; i += kThreads) {
        const int r = rows_s[i];
        if (r >= 0) {
          const int blk = bsh >= 0 ? r >> bsh : r / bs;
          rows_s[i] = trow[blk] * bs + (bsh >= 0 ? r & (bs - 1) : r - blk * bs);
        }
      }
    }
    __syncthreads();

    // Slot group g takes slots g, g + kSlotGroups, ... of the chunk, kBatch
    // per step.  Without a head split each thread copies, and later reads,
    // only its own 16-byte chunk of its group's rows, so waiting for its
    // own copies is enough: the steps need no barrier.  With the split the
    // lower lane group copies the K chunks and the upper the V chunks, and
    // a __syncwarp after the wait shows each half the other's (and tells
    // the copier that the slot it refills was read).  Slots past the chunk
    // or masked are zero-filled (source size 0: nothing is read).
    auto slot = [&](int step, int u) { return sg + kSlotGroups * (step * kBatch + u); };
    auto ring_at = [&](int step, int u) {
      return (((step % kRing) * kSlotGroups + sg) * kBatch + u) * kLPR + sl;
    };
    auto issue = [&](int step) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = slot(step, u);
        const int row = i < m && lane_on ? rows_s[i] : -1;
        const size_t e = head_off + (size_t)max(row, 0) * row_elems + (lane_on ? sl * 8 : 0);
        const int nb = row >= 0 ? 16 : 0;
        if (kSplit == 1 || h0 == 0) cp_async16(kring + ring_at(step, u), K + e, nb);
        if (kSplit == 1 || h0 != 0) cp_async16(vring + ring_at(step, u), V + e, nb);
      }
    };

    const int n_steps = (m + kStep - 1) / kStep;  // uniform over the CTA
#pragma unroll
    for (int j = 0; j < kRing - 1; ++j) {
      if (j < n_steps) issue(j);
      cp_async_commit();
    }
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<kRing - 2>();  // this thread's copies of the step have landed
      if constexpr (kSplit > 1) __syncwarp();  // and the other half's; the last step's reads done
      if (step + kRing - 1 < n_steps) issue(step + kRing - 1);  // into the previous step's slot
      cp_async_commit();

      // ---- scores s = (q . k) * scale of the step's kBatch rows, masked
      float sc[kRepL][kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = slot(step, u);
        ok[u] = i < m && rows_s[i] >= 0;
        float kf[8];
        bf16x8_to_float(kring[ring_at(step, u)], kf);
#pragma unroll
        for (int r = 0; r < kRepL; ++r) {
          float part = 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) part += qr[r][k] * kf[k];
          sc[r][u] = part;
        }
      }
#pragma unroll
      for (int o = kLPR / 2; o >= 1; o >>= 1)
#pragma unroll
        for (int r = 0; r < kRepL; ++r)
#pragma unroll
          for (int u = 0; u < kBatch; ++u) sc[r][u] += __shfl_xor_sync(kFull, sc[r][u], o);

      // ---- online softmax per query head: rescale by exp(m_old - m_new)
#pragma unroll
      for (int r = 0; r < kRepL; ++r) {
        float mb = kMasked;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          sc[r][u] = ok[u] ? sc[r][u] * scale : kMasked;
          mb = fmaxf(mb, sc[r][u]);
        }
        const float m_new = fmaxf(m_run[r], mb);
        const float alpha = expf(m_run[r] - m_new);
        float den = 0.0f;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          sc[r][u] = ok[u] ? expf(sc[r][u] - m_new) : 0.0f;
          den += sc[r][u];
        }
        den_run[r] = den_run[r] * alpha + den;
        m_run[r] = m_new;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] *= alpha;
      }

      // ---- unnormalised output: acc += sum_u p[u] v[u] --------------------
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        float vf[8];
        bf16x8_to_float(vring[ring_at(step, u)], vf);
#pragma unroll
        for (int r = 0; r < kRepL; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(sc[r][u], vf[k], acc[r][k]);
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every group is done with the ring: it holds the merge next

  // ---- the CTA's (m, den, o): its slot groups merged in order, pushed
  // into rank 0's receive slot for this rank
  float* red = reinterpret_cast<float*>(dyn);    // [kSlotGroups][kRep][kD] accumulators
  float* red_m = red + kSlotGroups * kRep * kD;  // [kSlotGroups][kRep] maxima
  float* red_den = red_m + kSlotGroups * kRep;   // [kSlotGroups][kRep] denominators
  // the merge over slot groups unrolled whole up to 16 of them; 8 at a time
  // for the 32 of d_head 64 (and 32, 16) and for padded groups (d_head 112,
  // 32, 16; whole, ptxas spilled 16 bytes at rep 1 in K4 at 64 and 112)
  constexpr int kMergeUnroll =
      kSlotGroups > 16 || L::kLanesUsed != kLPR || kAny ? 8 : kSlotGroups;
#pragma unroll
  for (int r = 0; r < kRepL; ++r) {
    const int hr = sg * kRep + h0 + r;
    if (lane_on) {
#pragma unroll
      for (int k = 0; k < 8; ++k) red[hr * kD + sl * 8 + k] = acc[r][k];
    }
    if (sl == 0) {
      red_m[hr] = m_run[r];
      red_den[hr] = den_run[r];
    }
  }
  __syncthreads();
  cluster_wait();  // every CTA of the cluster is running
  float* to_o = cluster.map_shared_rank(recv_o, 0) + rank * kRep * kD;
  float* to_md = cluster.map_shared_rank(recv_md, 0) + rank * kRep * 2;
  for (int i = tid; i < kRep * kD; i += kThreads) {
    const int r = i / kD;
    float M = kMasked;
#pragma unroll kMergeUnroll
    for (int g = 0; g < kSlotGroups; ++g) M = fmaxf(M, red_m[g * kRep + r]);
    float o = 0.0f, den = 0.0f;
#pragma unroll kMergeUnroll
    for (int g = 0; g < kSlotGroups; ++g) {
      const float w = expf(red_m[g * kRep + r] - M);
      o += red[g * kRep * kD + i] * w;
      den += red_den[g * kRep + r] * w;
    }
    to_o[i] = o;
    if (i % kD == 0) {
      to_md[r * 2] = M;
      to_md[r * 2 + 1] = den;
    }
  }

  // ---- combine over the cluster: rank 0 merges the ranks in rank order --
  cluster_arrive();  // release: this CTA's pushes reach rank 0 before the barrier
  cluster_wait();
  if (rank != 0) return;  // no CTA reads another's shared memory after the barrier
  for (int i = tid; i < kRep * kD; i += kThreads) {
    const int r = i / kD;
    if (kAny && (hb0 + r >= rep || i - r * kD >= D)) continue;  // an idle head or lane's channel
    float M = kMasked;
    for (int c = 0; c < C; ++c) M = fmaxf(M, recv_md[(c * kRep + r) * 2]);
    float num = 0.0f, den = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float w = expf(recv_md[(c * kRep + r) * 2] - M);
      num += recv_o[c * kRep * kD + i] * w;
      den += recv_md[(c * kRep + r) * 2 + 1] * w;
    }
    const size_t o =
        kAny ? ((size_t)bh * rep + hb0 + r) * D + (i - r * kD) : (size_t)bh * kRep * D + i;
    out[o] = num / fmaxf(den, 1e-30f);
  }
}

template <int kAddr, int kD, int kRep, bool kAny>
cudaError_t launch(const void* q, const void* K, const void* V, const void* table,
                   const void* idx, const void* lengths, const void* mask, void* out, int B,
                   int S, int Hkv, int rep, int D, int budget, float scale, int bs, long long sb,
                   long long st, long long sh, int C, int chunk, int q_bf16,
                   cudaStream_t stream) {
  auto kernel = fier_attend_kernel<kAddr, kD, kRep, kAny>;
  // the ring is above the 48 KiB default: raise the limit once per
  // instantiation, to the most any chunk needs
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<kD, kRep>(kMaxCluster, kMaxChunk));
  if (attr != cudaSuccess) return attr;
  const int bsh = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;
  const int n_blk = kAny ? (rep + kRep - 1) / kRep : 1;  // blocks of query heads per row
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * n_blk * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<kD, kRep>(C, chunk);
  cfg.stream = stream;
  cudaLaunchAttribute attr_c[1];
  attr_c[0].id = cudaLaunchAttributeClusterDimension;
  attr_c[0].val.clusterDim.x = C;
  attr_c[0].val.clusterDim.y = 1;
  attr_c[0].val.clusterDim.z = 1;
  cfg.attrs = attr_c;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const __nv_bfloat16*>(K),
      static_cast<const __nv_bfloat16*>(V), static_cast<const int*>(table),
      static_cast<const int*>(idx), static_cast<const int*>(lengths),
      static_cast<const int8_t*>(mask), static_cast<float*>(out), S, Hkv, budget, scale, bs,
      bsh, sb, st, sh, chunk, q_bf16, D, rep);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation for rep (1, 2, 4, 8, 12 or 16; sparse_attention.KERNEL_REPS)
// at d_head kD.
template <int kAddr, int kD>
decltype(&launch<kAddr, kD, 1, false>) pick_rep(int rep) {
  switch (rep) {
    case 1: return &launch<kAddr, kD, 1, false>;
    case 2: return &launch<kAddr, kD, 2, false>;
    case 4: return &launch<kAddr, kD, 4, false>;
    case 8: return &launch<kAddr, kD, 8, false>;
    case 12: return &launch<kAddr, kD, 12, false>;
    case 16: return &launch<kAddr, kD, 16, false>;
    default: return nullptr;
  }
}

// The generic instantiation of layout class kW (64, 128, 256) whose block of
// query heads takes rep: the next power of two up to 16 (8 in the 256
// class), sparse_attention.head_block.
template <int kAddr, int kW>
decltype(&launch<kAddr, kW, 1, true>) pick_any(int rep) {
  if (rep <= 1) return &launch<kAddr, kW, 1, true>;
  if (rep <= 2) return &launch<kAddr, kW, 2, true>;
  if (rep <= 4) return &launch<kAddr, kW, 4, true>;
  if (rep <= 8 || kW == 256) return &launch<kAddr, kW, 8, true>;
  return &launch<kAddr, kW, kW == 256 ? 8 : 16, true>;
}

// C CTAs per row, each holding the rows of `chunk` slots at once
bool plan_ok(int C, int chunk) {
  return C >= 1 && C <= kMaxCluster && (C & (C - 1)) == 0 && chunk >= 1 && chunk <= kMaxChunk;
}

using LaunchFn = decltype(&launch<kSlab, 128, 1, false>);

// The fixed instantiations (sparse_attention.KERNEL_HEAD_DIMS x
// KERNEL_REPS, d_head 112 at rep 1 only: KERNEL_REPS_AT) of one address
// policy: the slab (K2: fier_attend.cu), the pool (K4:
// fier_attend_paged.cu) or gathered rows (K8: fier_attend_gathered.cu), one
// library each so that they compile in parallel.
template <int kOnly>
struct Fixed {
  template <int kAddr>
  static LaunchFn get(int D, int rep) {
    if constexpr (kAddr != kOnly) {
      return nullptr;
    } else {
      switch (D) {
        case 16: return pick_rep<kAddr, 16>(rep);
        case 32: return pick_rep<kAddr, 32>(rep);
        case 64: return pick_rep<kAddr, 64>(rep);
        case 112: return rep == 1 ? &launch<kAddr, 112, 1, false> : nullptr;
        case 128: return pick_rep<kAddr, 128>(rep);
        default: return nullptr;
      }
    }
  }
};

// The bodies of a source file's entry points: the arguments checked, then
// the instantiation Pick::get<kAddr>(D, rep) returns (nullptr: none in this
// library) launched.  table == nullptr: K2, K/V are the slabs [B, S, Hkv, D].
// Otherwise K4: K/V are block pools [N, bs, Hkv, D] walked through table
// [B, S / bs].  cluster: CTAs per (b, h) row; chunk: slots whose rows a CTA
// holds at once (sparse_attention.attend_plan).  q is bf16 when q_bf16, else
// f32.
template <class Pick>
int attend_launch(const void* q, const void* K, const void* V, const void* table,
                  const void* idx, const void* lengths, void* out, int B, int S, int bs, int Hkv,
                  int rep, int D, int budget, float scale, int cluster, int chunk, int q_bf16,
                  void* stream) {
  if (budget <= 0 || !plan_ok(cluster, chunk) || rep < 1 || D < 8 || D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
  const bool paged = table != nullptr;
  if (paged && (bs < 1 || S % bs)) return (int)cudaErrorInvalidValue;
  const LaunchFn go =
      paged ? Pick::template get<kPaged>(D, rep) : Pick::template get<kSlab>(D, rep);
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return (int)go(q, K, V, table, idx, lengths, nullptr, out, B, S, Hkv, rep, D, budget, scale,
                 paged ? bs : 1, 0, 0, 0, cluster, chunk, q_bf16,
                 static_cast<cudaStream_t>(stream));
}

// K8: k_sel/v_sel [B, budget, Hkv, D] gathered rows with element strides
// (sb, st, sh) and contiguous channels (both tensors alike; each a multiple
// of 8, for the 16-byte copies), mask int8 [B, Hkv, budget].
template <class Pick>
int attend_gathered_launch(const void* q, const void* k_sel, const void* v_sel, const void* mask,
                           void* out, int B, int budget, int Hkv, int rep, int D, long long sb,
                           long long st, long long sh, float scale, int cluster, int chunk,
                           int q_bf16, void* stream) {
  if (budget <= 0 || !plan_ok(cluster, chunk) || sb % 8 || st % 8 || sh % 8 || rep < 1 ||
      D < 8 || D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
  const LaunchFn go = Pick::template get<kGathered>(D, rep);
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return (int)go(q, k_sel, v_sel, nullptr, nullptr, nullptr, mask, out, B, budget, Hkv, rep, D,
                 budget, scale, 1, sb, st, sh, cluster, chunk, q_bf16,
                 static_cast<cudaStream_t>(stream));
}

}  // namespace
