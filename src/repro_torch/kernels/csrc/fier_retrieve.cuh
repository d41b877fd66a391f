// K1 fier_retrieve and K3 fier_retrieve_paged: one-pass FIER retrieval for
// Hopper (sm_90a), over a slab cache (K1) or a paged block pool (K3): the
// kernel body and its launch, built by fier_retrieve.cu and
// fier_retrieve_paged.cu (the fixed instantiations of K1 and of K3) and
// fier_retrieve_any.cu (the generic layout of both), one library each, so
// that they compile in parallel.
//
// K1 replaces the TPU kernel repro/kernels/fused_retrieval.py::fused_retrieve_hm
// (pallas_call at :284, body _kernel :168, _threshold_select :70,
// _masked_block_keys :147).  K3 replaces paged_fused_retrieve_hm (pallas_call
// at :435, body _paged_kernel :320).  The TPU kernel streams the codes
// HBM -> VMEM through a two-slot buffer and re-scores them on each of its
// five sweeps, so it has no row-length limit; neither has this one.
//
// What bounds it on the card: bytes.  Per (batch, kv-head) row it must read
// the packed sign codes (length/8 x D bytes) and the bf16 group scale/zero
// (2 x length/g x D x 2 bytes) of the valid positions once, and write
// `budget` int32 indices.  At the serving shape (B = 4, Hkv = 16, S = 8192,
// D = 128, g = 32) the full rows are 17.1 MB (~5.1 us at 3.35 TB/s); the
// valid rows at lengths 8192/5003/2100/700 about half that.  The scoring
// arithmetic is the next limit: per chunk, query head and lane, 16 channel
// sums built once per group, 32 lookups and a 31-step reduce-scatter, ~10 us
// of issue slots over the full rows.
//
// d_head and rep.  d_head is a template parameter (16, 32, 64, 112 or 128:
// the scoring warp's lane owns lane_channels(D) channels, fier_common.cuh; at
// 112 lanes 0-27 own 4 each and lanes 28-31 add exact zeros, so zamba2-7b's
// shared attention block runs 128's loads and sums; at 16, the reduced
// configs' d_head, lanes 0-15 own one each and lanes 16-31 add exact zeros,
// on 32's one-channel loads and 2-entry tables), and so is the capacity
// kMaxRep of the query heads staged in shared memory (rep_slots: 8 for
// d_head 128 up to rep 8, 16 otherwise, so rep 12 and 16 run: starcoder2-3b,
// qwen3-moe).  Scoring grows with rep (one score_chunk per query head and
// chunk), the bytes do not: at rep 12-16 the row's issue slots, not its
// bytes, bound it.
//
// Every other d_head that is a multiple of 8 up to 256, and every rep above
// 16, runs the generic instantiation of its layout class (kMaxRep = 0,
// fier_common.cuh: fixed_shape, any_class, score_chunk_any) with d_head a
// run-time value: 256 threads, the query heads staged in q_s in blocks of
// kAnyQFloats / D (32 at d_head 128, 16 at 256), each block folded into the
// group max or sum in head order, the partial reduction of a token kept in
// its key slot between blocks (score_any).  A block past the first re-reads
// the range's side-car, mostly from L2.  Those shapes take no other path.
//
// Design.  A row is split over a thread-block cluster of C CTAs of 512
// threads (256 when g is not a multiple of 32; C in {1, 2, 4, 8}; fused_retrieval.py::retrieval_plan picks C and
// the token range of each CTA from S, B x Hkv and the SM count: up to 4 CTAs
// to fill the SMs in one wave of one CTA each, up to 8 for the keys to fit a
// CTA's shared memory; C = 2 at the serving shape).  CTA r owns tokens
// [r T, min((r+1) T, S)), T a multiple of 32:
//   * Score once.  Each warp scores 32-token chunks of the range (lane l
//     owns lane_channels(D) channels: coalesced loads straight from the seq-major
//     [B, S/8, Hkv, D] / [B, S/g, Hkv, D] side-car; fier_common.cuh's
//     load_chunk / score_chunk, the score_block expression, exact bf16 x bf16
//     products summed in f32 in the order K1 has always used, looked up in a
//     per-lane table of the 2^lane_channels(D) sums its channels' code bits can select).  The next
//     chunk's loads are issued before the current chunk is scored (a
//     register double buffer), so a warp keeps two chunks in flight.  A
//     chunk that starts at or past the row's length is not read: its keys
//     are the mask's (-1e30, or +inf below `sink`), as _masked_block_keys
//     orders them.  The query-group reduction (max/sum), the mask and the
//     sink/recent overrides follow, and the score is stored as a monotone
//     uint32 key in the CTA's shared memory (4 bytes/token: 16 KiB at
//     S = 8192, C = 2).  No per-token score reaches device memory.
//   * tau and m by 4 radix-256 passes (radix_select).  Each CTA builds the
//     histogram of its own keys (pass 0 while scoring, from registers);
//     after a cluster barrier every CTA sums the C histograms through
//     distributed shared memory (map_shared_rank) and derives the same
//     digit.  Pass p has its own histogram buffer, kept to the end, so one
//     cluster barrier per pass suffices.
//   * Compaction.  A CTA's offsets into idx are the lower ranks' counts of
//     { key > tau } and of ties, which their kept histograms give (a key
//     above tau sits in a bucket above tau's digit in exactly one pass), read
//     through DSMEM with no further barrier.  Each CTA then writes its own
//     part of idx: { key > tau } in ascending position at [0, m), then the
//     first (budget - m) ties at [m, budget) — the reference's order, since
//     the ranks own contiguous ranges.  Eight consecutive keys per thread and
//     one block scan per 4096 keys.
// The result (idx, tau, m) equals that of the earlier one-block-per-row
// kernel bit for bit: the keys are the same (same scoring arithmetic), and tau, m and the
// order follow from the multiset of keys and the positions.
//
// Long rows.  C <= 8 CTAs of 227 KB hold about 379k keys.  Beyond that
// (long_500k: S = 524,288) the plan takes C = 8 and the keys go to a device
// scratch [B x Hkv, C x T] uint32 that the wrapper allocates: 4 bytes per
// token and kv head (32 MiB at long_500k, B = 1, Hkv = 16) written once and
// read by radix passes 1-3 and the compaction, mostly from L2.  The same
// kernel body runs with the key store as a template policy (kSmemKeys), so
// the result is the same function.  Chosen over re-scoring the side-car on
// every pass, as the TPU kernel does: that would read 268 MB four or five
// times there, against 32 MiB of keys written once and read four times.
//
// K3 is the same kernel body with another address policy (the template
// flag kPaged): the side-car lives in a pool [N, bs/8 | bs/g, Hkv, D], and a
// CTA stages only its range's entries of row b's block table in shared
// memory (after the keys).  Byte-row i (tokens 8i..8i+7) is read from pool
// block table[8i / bs], row (8i % bs) / 8, and group grp from block
// table[grp*g / bs], row (grp*g % bs) / g: the translation is per cache
// block (shifts when bs and g are powers of two), so any bs that
// check_block_size admits works.  Scoring, the radix
// passes and the compaction are shared, so on the same logical contents K3
// returns K1's idx, tau and m bit for bit.  Unallocated entries (and the
// holes shed_middle_blocks leaves) point at the null block 0, which is
// scored like any other block and masked only by length, as the plain
// version's gather does.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fier_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fier;

// Threads per CTA: 512 (one CTA per SM, 128 registers) when a chunk has one
// group, else 256, so that the 4-group chunk's double buffer fits registers.
// The generic layout (kAny) takes 256 at every group size: its two-part
// chunks and run-time d_head do not fit 128 registers.
template <int kGroups, bool kAny = false>
__host__ __device__ constexpr int threads_for() { return kGroups == 1 && !kAny ? 512 : 256; }
constexpr int kPerThread = 8;                   // compaction: consecutive keys per thread
constexpr int kMaxCluster = 8;
constexpr int kSmemLimit = 232448;              // shared memory a CTA may use on sm_90

// The kernel's static shared memory (q_s, 16 warps' tables, the histograms,
// the scan scratch) rounded up to a KiB: fused_retrieval.smem_static counts
// the same, and the plan adds the dynamic part to it.  kMaxRep = 0 is the
// generic layout of class kD: kAnyQFloats of query heads and 8 warps.
template <int kD, int kMaxRep>
constexpr int smem_static() {
  constexpr int q = kMaxRep == 0 ? kAnyQFloats : kMaxRep * kD;
  constexpr int warps = kMaxRep == 0 ? 8 : 16;
  return ((q + warps * table_floats<kD>() + kPasses * kRadix + kRadix + warps + 4) * 4 + 1023) /
         1024 * 1024;
}
static_assert(smem_static<128, 8>() == 43008, "the serving instantiation's count moved");
static_assert(smem_static<112, 16>() == 46080, "fused_retrieval.smem_static counts 46,080");
static_assert(smem_static<32, 16>() == 12288, "fused_retrieval.smem_static counts 12,288");
static_assert(smem_static<16, 16>() == 11264, "fused_retrieval.smem_static counts 11,264");
static_assert(smem_static<256, 0>() == 38912 && smem_static<128, 0>() == 38912 &&
                  smem_static<64, 0>() == 26624 && smem_static<32, 0>() == 24576,
              "fused_retrieval.smem_static counts the generic classes alike");

// Block-table entries a range of T tokens (starting at a multiple of 32)
// can touch: fused_retrieval.retrieval_plan counts the same.
inline int table_words(int T, int bs) { return (T + bs - 1) / bs + 1; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic layout's scoring of a CTA's range [t0, t1) (chunks up to c1;
// live(c): chunk c lies below the row's length, else it is not read): the
// query heads in blocks of kAnyQFloats / D staged in q_s, each block's
// scores folded into the group reduction in head order.  Between blocks
// the partial reduction of token pos waits in keys[pos - t0] as f32 bits,
// read back by the thread that wrote it; the last block hands every
// token's reduced score to store_key.  The next chunk's loads are issued
// before the current one is scored only when a chunk has one group (the
// 4-group two-part chunk's double buffer would not fit 255 registers).
// Every thread of the CTA calls it.
template <int kGroups, int kW, int kWarps, class Live, class CodeRow, class GroupRow,
          class StoreKey>
__device__ __forceinline__ void score_any(const __nv_bfloat16* q, float* q_s, float* tab, int row,
                                          int rep, int D, int reduce_sum, int t0, int t1, int c1,
                                          Live live, int S8, const uint8_t* codes_h,
                                          const __nv_bfloat16* scale_h,
                                          const __nv_bfloat16* zero_h, size_t row_stride,
                                          CodeRow code_row, GroupRow group_row, uint32_t* keys,
                                          StoreKey store_key) {
  constexpr bool kPrefetch = kGroups == 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hb = kAnyQFloats / D;  // query heads per block (16 at D 256)
  auto load = [&](AnyChunk<kGroups, kW>& ch, int c) {
    load_chunk_any(ch, D, c, S8, codes_h, scale_h, zero_h, row_stride, code_row, group_row);
  };
  for (int r0 = 0; r0 < rep; r0 += hb) {
    const int nr = min(hb, rep - r0);  // this block's query heads
    const bool first = r0 == 0, last = r0 + hb >= rep;
    __syncthreads();  // every warp is done with the previous block's q_s
    for (int i = tid; i < nr * D; i += kWarps * 32)
      q_s[i] = __bfloat162float(q[((size_t)row * rep + r0) * D + i]);
    __syncthreads();
    int c = t0 / 32 + warp;
    AnyChunk<kGroups, kW> cur, nxt;
    bool cur_live = live(c);
    if (cur_live) load(cur, c);
    for (; c < c1; c += kWarps) {  // warp-uniform trip count
      bool nxt_live = live(c + kWarps);
      if (kPrefetch && nxt_live) load(nxt, c + kWarps);
      const int pos = c * 32 + lane;
      float kv = -1e30f;
      if (cur_live) {
        if (!first && pos < t1) kv = __uint_as_float(keys[pos - t0]);
        for (int r = 0; r < nr; ++r) {
          const float s = score_chunk_any(cur, q_s + r * D, D, lane, tab);
          kv = (first && r == 0) ? s : (reduce_sum ? kv + s : fmaxf(kv, s));
        }
      }
      if (last)
        store_key(pos, kv);
      else if (pos < t1)
        keys[pos - t0] = __float_as_uint(kv);
      if constexpr (kPrefetch) {
        cur = nxt;
      } else if (nxt_live) {
        load(cur, c + kWarps);
      }
      cur_live = nxt_live;
    }
  }
}

// kPaged = false (K1): codes [B, S/8, Hkv, D], scale/zero [B, S/g, Hkv, D],
// table unused.  kPaged = true (K3): codes [N, bs/8, Hkv, D], scale/zero
// [N, bs/g, Hkv, D], table [B, n_btab] with S = n_btab * bs.
// kSmemKeys = false: keys_g [B * Hkv, C * T] holds the keys (long rows).
// kGroups: Chunk<1> when group % 32 == 0 (512 threads), else Chunk<4> (256).
// kD: d_head; kMaxRep: query heads q_s holds (rep_slots).  kMaxRep = 0: the
// generic layout, kD its class (32, 64, 128, 256) and D the d_head, the
// query heads staged and folded in blocks of kAnyQFloats / D.
template <bool kPaged, bool kSmemKeys, int kGroups, int kD, int kMaxRep>
__global__ void __launch_bounds__(threads_for<kGroups, kMaxRep == 0>(), 1)
fier_retrieve_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv, rep, D]
                     const uint8_t* __restrict__ codes,
                     const __nv_bfloat16* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ zero,
                     const int* __restrict__ table,            // [B, n_btab] (K3)
                     const int* __restrict__ lengths,          // [B]
                     uint32_t* __restrict__ keys_g,            // [B * Hkv, C * T] (long rows)
                     int* __restrict__ idx_out,                // [B, Hkv, budget]
                     float* __restrict__ tau_out,              // [B, Hkv]
                     int* __restrict__ m_out,                  // [B, Hkv]
                     int S, int Hkv, int rep, int group, int budget,
                     int reduce_sum, int sink, int recent, int bs, int T, int D_any) {
  constexpr bool kAny = kMaxRep == 0;
  const int D = kAny ? D_any : kD;
  constexpr int kDPL = lane_channels(kD);  // channels per lane of the scoring warp
  constexpr int kThreads = threads_for<kGroups, kAny>();
  constexpr int kWarps = kThreads / 32;
  constexpr int kTile = kThreads * kPerThread;  // keys per compaction tile
  constexpr int kTableFloats = table_floats<kD>();
  extern __shared__ __align__(16) uint32_t dyn[];  // keys [T] (kSmemKeys), then the table range
  __shared__ float q_s[kAny ? kAnyQFloats : kMaxRep * kD];
  __shared__ float tabs[kWarps * kTableFloats];  // score_chunk's sums, per warp
  __shared__ int hist[kPasses * kRadix];
  __shared__ int tot[kRadix];
  __shared__ int warp_sum[kWarps];
  __shared__ int base[2];  // |{ key > tau }| and ties over the lower ranks
  __shared__ int sel[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;  // b * Hkv + h
  const int b = row / Hkv;
  const int h = row - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int S8 = S >> 3;
  const int t0 = min(rank * T, S);
  const int t1 = min(t0 + T, S);
  const int n = t1 - t0;  // keys of this CTA

  uint32_t* keys = kSmemKeys ? dyn : keys_g + ((size_t)row * C + rank) * T;
  int* table_s = reinterpret_cast<int*>(kSmemKeys ? dyn + T : dyn);
  const int e0 = kPaged ? t0 / bs : 0;  // first table entry of the range

  if constexpr (!kAny) {
    for (int i = tid; i < rep * D; i += kThreads)
      q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);
  }
  if constexpr (kPaged) {
    if (n > 0) {
      const int e1 = (t1 - 1) / bs + 1;
      const int* trow = table + (size_t)b * (S / bs);
      for (int i = e0 + tid; i < e1; i += kThreads) table_s[i - e0] = trow[i];
    }
  }
  for (int i = tid; i < kPasses * kRadix; i += kThreads) hist[i] = 0;
  if (tid < 2) base[tid] = 0;
  __syncthreads();

  // The seq row (in units of Hkv*D elements) of byte-row i and of the group
  // holding token t; shifts for the power-of-two block and group sizes.
  const int bsh = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  const int gsh = (group & (group - 1)) == 0 ? __ffs(group) - 1 : -1;
  auto div_bs = [&](int t) { return bsh >= 0 ? t >> bsh : t / bs; };
  auto div_g = [&](int t) { return gsh >= 0 ? t >> gsh : t / group; };
  auto code_row = [&](int i) -> size_t {
    if constexpr (kPaged) {
      const int t = i * 8;
      const int blk = div_bs(t);
      return (size_t)table_s[blk - e0] * (bs >> 3) + ((t - blk * bs) >> 3);
    } else {
      return (size_t)b * S8 + i;
    }
  };
  auto group_row = [&](int t) -> size_t {
    if constexpr (kPaged) {
      const int blk = div_bs(t);
      return (size_t)table_s[blk - e0] * (bs / group) + div_g(t - blk * bs);
    } else {
      return (size_t)b * (S / group) + div_g(t);
    }
  };

  // ---- score the range once; keys to shared memory (or the scratch) ----
  const size_t row_stride = (size_t)Hkv * D;  // elements between seq rows
  const size_t lane_off = (size_t)h * D + lane * kDPL;
  const uint8_t* codes_h = codes + lane_off;
  const __nv_bfloat16* scale_h = scale + lane_off;
  const __nv_bfloat16* zero_h = zero + lane_off;
  const float inf = __int_as_float(0x7f800000);

  const int c1 = n > 0 ? (t1 + 31) / 32 : 0;  // chunks [t0 / 32, c1)
  auto live = [&](int c) { return c < c1 && c * 32 < length; };  // read only below length
  // the key of token pos from its group-reduced score kv: the mask and the
  // guard rails, then radix pass 0's histogram, from registers
  auto store_key = [&](int pos, float kv) {
    if (pos >= length) kv = -1e30f;
    if (sink > 0 && pos < sink) kv = inf;
    if (recent > 0 && pos >= length - recent && pos < length) kv = inf;
    const uint32_t key = sortable_key(kv);
    if (pos < t1) keys[pos - t0] = key;
    count_digit(hist, key, pos < t1, 0u, 0u, 24, lane);
  };
  if constexpr (kAny) {
    score_any<kGroups, kD, kWarps>(q, q_s, tabs + warp * kTableFloats, row, rep, D, reduce_sum,
                                   t0, t1, c1, live, S8, codes_h, scale_h, zero_h, row_stride,
                                   code_row, group_row, keys, store_key);
  } else {
    int c = t0 / 32 + warp;
    Chunk<kGroups, kD> cur, nxt;
    bool cur_live = live(c);
    if (cur_live)
      load_chunk(cur, c, S8, codes_h, scale_h, zero_h, row_stride, code_row, group_row);
    for (; c < c1; c += kWarps) {  // warp-uniform trip count
      const bool nxt_live = live(c + kWarps);
      if (nxt_live)
        load_chunk(nxt, c + kWarps, S8, codes_h, scale_h, zero_h, row_stride, code_row,
                   group_row);
      float kv = -1e30f;
      if (cur_live) {
        for (int r = 0; r < rep; ++r) {
          const float s = score_chunk(cur, q_s + r * D, lane, tabs + warp * kTableFloats);
          kv = (r == 0) ? s : (reduce_sum ? kv + s : fmaxf(kv, s));
        }
      }
      store_key(c * 32 + lane, kv);
      cur = nxt;
      cur_live = nxt_live;
    }
  }
  __syncthreads();

  // ---- tau: 4 radix-256 passes, histograms summed over the cluster ------
  auto cluster_total = [&](int, const int* hp) -> const int* {
    cluster.sync();  // every CTA's histogram of this pass is complete
    int* own = const_cast<int*>(hp);
    for (int i = tid; i < kRadix; i += kThreads) {
      int s = 0;
      for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(own, r)[i];
      tot[i] = s;
    }
    __syncthreads();
    return tot;
  };
  uint32_t tau_key;
  int m;  // |{ key > tau }| over the row
  radix_select<kThreads>([&](int i) { return keys[i]; }, n, budget, hist, sel, cluster_total,
                         true, tau_key, m);

  // ---- |{ key > tau }| and ties of the lower ranks, from their histograms:
  // a key above tau is counted once, in the first pass whose digit exceeds
  // tau's; a tie matches all four digits.
  int gt = 0, tie = 0;
  for (int i = tid; i < kRadix; i += kThreads) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int jp = (tau_key >> (24 - 8 * p)) & 0xFF;
      if (i > jp || (p == kPasses - 1 && i == jp)) {
        int s = 0;
        for (int r = 0; r < rank; ++r) s += cluster.map_shared_rank(hist + p * kRadix, r)[i];
        if (i > jp) gt += s; else tie += s;
      }
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    gt += __shfl_xor_sync(kFull, gt, o);
    tie += __shfl_xor_sync(kFull, tie, o);
  }
  if (lane == 0 && (gt | tie)) {
    atomicAdd(&base[0], gt);
    atomicAdd(&base[1], tie);
  }
  cluster_arrive();  // done reading the other CTAs' shared memory
  __syncthreads();

  // ---- compaction: { key > tau } then the first (budget - m) ties ------
  int* out = idx_out + (size_t)row * budget;
  const int tie_cap = budget - m;
  int n_gt = base[0], n_tie = base[1];  // row-wide counts before this tile
  for (int tb = 0; tb < n; tb += kTile) {
    const int l0 = tb + tid * kPerThread;  // a multiple of 8 inside the T slots
    uint32_t k8[kPerThread];
    if (l0 < n) {
      const uint4 a = *reinterpret_cast<const uint4*>(keys + l0);
      const uint4 z = *reinterpret_cast<const uint4*>(keys + l0 + 4);
      k8[0] = a.x; k8[1] = a.y; k8[2] = a.z; k8[3] = a.w;
      k8[4] = z.x; k8[5] = z.y; k8[6] = z.z; k8[7] = z.w;
    }
    unsigned gtm = 0, tiem = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (l0 + e < n) {
        gtm |= (unsigned)(k8[e] > tau_key) << e;
        tiem |= (unsigned)(k8[e] == tau_key) << e;
      }
    }
    const int packed = __popc(gtm) | (__popc(tiem) << 16);  // < 2^16 each per tile
    int incl = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_sum[w];
      before += w < warp ? v : 0;
      tile += v;
    }
    const int excl = incl - packed + before;
    int g = n_gt + (excl & 0xFFFF);
    int t = n_tie + (excl >> 16);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int pos = t0 + l0 + e;
      if ((gtm >> e) & 1u) {
        out[g++] = pos;
      } else if ((tiem >> e) & 1u) {
        if (t < tie_cap) out[m + t] = pos;
        ++t;
      }
    }
    n_gt += tile & 0xFFFF;
    n_tie += tile >> 16;
    __syncthreads();  // warp_sum is rewritten by the next tile
  }
  if (rank == 0 && tid == 0) {
    tau_out[row] = unsortable(tau_key);
    m_out[row] = m;
  }
  cluster_wait();  // no CTA leaves while another may still read its shared memory
}

template <bool kPaged, bool kSmemKeys, int kGroups, int kD, int kMaxRep>
cudaError_t launch(const void* q, const void* codes, const void* scale, const void* zero,
                   const void* table, const void* lengths, void* keys, void* idx, void* tau,
                   void* m, int B, int S, int Hkv, int rep, int D, int group, int budget,
                   int reduce_sum, int sink, int recent, int bs, int C, int T,
                   cudaStream_t stream) {
  const size_t smem = (kSmemKeys ? (size_t)T * 4 : 0) + (kPaged ? (size_t)table_words(T, bs) * 4 : 0);
  if (smem + smem_static<kD, kMaxRep>() > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = fier_retrieve_kernel<kPaged, kSmemKeys, kGroups, kD, kMaxRep>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * C);
  cfg.blockDim = dim3(threads_for<kGroups, kMaxRep == 0>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(zero),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<uint32_t*>(keys), static_cast<int*>(idx), static_cast<float*>(tau),
      static_cast<int*>(m), S, Hkv, rep, group, budget, reduce_sum, sink, recent, bs, T, D);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation for the key store (keys == nullptr: shared memory), the
// group size, d_head (or the generic class) and the query heads it holds.
template <bool kPaged, int kD, int kMaxRep>
decltype(&launch<kPaged, true, 1, kD, kMaxRep>) pick(bool smem_keys, bool one) {
  if (smem_keys)
    return one ? &launch<kPaged, true, 1, kD, kMaxRep> : &launch<kPaged, true, 4, kD, kMaxRep>;
  return one ? &launch<kPaged, false, 1, kD, kMaxRep> : &launch<kPaged, false, 4, kD, kMaxRep>;
}

using LaunchFn = decltype(&launch<false, true, 1, 128, 8>);

// The fixed instantiations (fier_common.cuh: fixed_shape) of one layout,
// the slab (K1, kOnPool false: fier_retrieve.cu) or the pool (K3:
// fier_retrieve_paged.cu), one library each so that they compile in
// parallel; the other layout has none in that library.
template <bool kOnPool>
struct Fixed {
  template <bool kPaged>
  static LaunchFn get(bool smem_keys, bool one, int D, int rep) {
    if constexpr (kPaged != kOnPool) {
      return nullptr;
    } else {
      if (!fixed_shape(D, rep)) return nullptr;
      if (D == 16) return pick<kPaged, 16, 16>(smem_keys, one);
      if (D == 32) return pick<kPaged, 32, 16>(smem_keys, one);
      if (D == 64) return pick<kPaged, 64, 16>(smem_keys, one);
      if (D == 112) return pick<kPaged, 112, 16>(smem_keys, one);
      if (rep_slots(D, rep) == 8) return pick<kPaged, 128, 8>(smem_keys, one);
      return pick<kPaged, 128, 16>(smem_keys, one);
    }
  }
};

// The body of a source file's entry point: the arguments checked, then the
// instantiation Pick::get<kPaged>(smem_keys, one, D, rep) returns (nullptr:
// none in this library) launched.  table == nullptr: K1, the side-car is
// the slab [B, S/8 | S/g, Hkv, D].
// Otherwise K3: the side-car is a block pool [N, bs/8 | bs/g, Hkv, D] walked
// through table [B, S / bs].  cluster CTAs split each row, cta_tokens tokens
// each (fused_retrieval.retrieval_plan); keys == nullptr keeps the keys in
// shared memory, else keys is the [B * Hkv, cluster * cta_tokens] uint32
// scratch of the long-row path.
template <class Pick>
int retrieve_launch(const void* q, const void* codes, const void* scale, const void* zero,
                    const void* table, const void* lengths, void* idx, void* tau, void* m, int B,
                    int S, int bs, int Hkv, int rep, int D, int group, int budget, int reduce_sum,
                    int sink, int recent, int cluster, int cta_tokens, void* keys, void* stream) {
  if (rep < 1 || D < 8 || D > 256 || D % 8 || group <= 0 || group % 8 || S % 8)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || cta_tokens <= 0 ||
      cta_tokens % 32 || (long long)cluster * cta_tokens < S || budget <= 0 || budget > S)
    return (int)cudaErrorInvalidValue;
  const bool paged = table != nullptr;
  if (!paged)
    bs = 8;
  else if (bs < 8 || bs % 8 || bs % group || S % bs)
    return (int)cudaErrorInvalidValue;
  const bool one = group % 32 == 0, smem_keys = keys == nullptr;
  const LaunchFn go = paged ? Pick::template get<true>(smem_keys, one, D, rep)
                            : Pick::template get<false>(smem_keys, one, D, rep);
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return (int)go(q, codes, scale, zero, table, lengths, keys, idx, tau, m, B, S, Hkv, rep, D,
                 group, budget, reduce_sum, sink, recent, bs, cluster, cta_tokens,
                 static_cast<cudaStream_t>(stream));
}

}  // namespace
