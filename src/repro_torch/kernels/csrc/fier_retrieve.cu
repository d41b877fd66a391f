// K1 fier_retrieve and K3 fier_retrieve_paged: one-pass FIER retrieval for
// Hopper (sm_90a), over a slab cache (K1) or a paged block pool (K3).
//
// K1 replaces the TPU kernel repro/kernels/fused_retrieval.py::fused_retrieve_hm
// (pallas_call at :284, body _kernel :168, _threshold_select :70,
// _masked_block_keys :147).  K3 replaces paged_fused_retrieve_hm (pallas_call
// at :435, body _paged_kernel :320).
//
// What bounds it on the card: bytes.  Per (batch, kv-head) row it must read
// the packed sign codes (S/8 x D bytes) and the bf16 group scale/zero
// (2 x S/g x D x 2 bytes) once, and write `budget` int32 indices; at the
// serving shape (S = 8192, D = 128, g = 32) that is 256 KiB per row and
// ~17 MB per call for B = 4, Hkv = 16, about 5 us at 3.35 TB/s.  The scoring
// arithmetic (D multiply-adds per token and query head) is far below the
// card's rate.
//
// Design.  One thread block owns one (b, h) row, so the whole selection
// (tau search and compaction) stays inside the block:
//   * Score once.  A warp scores 32 consecutive tokens (4 code bytes per
//     channel): lane l owns D/32 channels, reads their code bytes and the
//     group's scale/zero with coalesced loads straight from the seq-major
//     [B, S/8, Hkv, D] / [B, S/g, Hkv, D] side-car, forms the two possible
//     dequantized keys bf16(z + s) and bf16(z - s) exactly as score_block
//     does, and accumulates q*a in f32 (each bf16 x bf16 product is exact in
//     f32, so picking the precomputed product by the sign bit is the same
//     arithmetic).  A butterfly reduce-scatter over the 32 lanes leaves lane
//     l with the full score of token l.  The query-group reduction
//     (max/sum), the length mask (-1e30) and the sink/recent overrides
//     (+inf) follow, and the score is stored as a monotone uint32 key in
//     shared memory (4 bytes/token: 32 KiB at S = 8192).  No per-token score
//     or key ever reaches device memory.
//   * tau and m by 4 radix-256 passes over the shared-memory keys, with
//     warp-aggregated shared-memory histograms (__match_any_sync), so the
//     codes are read once instead of the TPU kernel's five sweeps.
//   * Compaction by block-wide prefix sums: { key > tau } in ascending
//     position at [0, m), then the first (budget - m) ties at [m, budget) —
//     the reference's order.
// The scoring warp (load_chunk, score_chunk) and the radix search
// (radix_select) live in fier_common.cuh: K6 writes the scores of the same
// device function and K7 runs the same search over them, so the two-pass
// pipeline selects what this kernel selects.
// Rows longer than the shared memory allows (about 56k tokens) are refused
// by the wrapper; a variant that re-scores per sweep is a later kernel.
// Only 64 blocks run at the serving shape (B x Hkv), fewer than the 132 SMs:
// splitting a row across a cluster is later work.
//
// K3 is the same kernel body with another address policy (the template
// flag kPaged): the side-car lives in a pool [N, bs/8 | bs/g, Hkv, D] and
// row b's block table [n_btab] is staged in shared memory once per block,
// after the keys.  Byte-row i (tokens 8i..8i+7) is read from pool block
// table[8i / bs], row (8i % bs) / 8, and group grp from block
// table[grp*g / bs], row (grp*g % bs) / g: the translation is per cache
// block, so any bs that check_block_size admits works, and at bs = 32 a
// warp's 32-token chunk is exactly one cache block.  Scoring, the radix
// passes and the compaction are shared, so on the same logical contents K3
// returns K1's idx, tau and m bit for bit.  Unallocated entries (and the
// holes shed_middle_blocks leaves) point at the null block 0, which is
// scored like any other block and masked only by length, as the plain
// version's gather does.  K3 reads K1's bytes plus the table (1 KiB per
// row at capacity 8192).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fier_common.cuh"

namespace {

using namespace fier;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// kPaged = false (K1): codes [B, S/8, Hkv, D], scale/zero [B, S/g, Hkv, D],
// table unused.  kPaged = true (K3): codes [N, bs/8, Hkv, D], scale/zero
// [N, bs/g, Hkv, D], table [B, n_btab] with S = n_btab * bs.
template <bool kPaged>
__global__ void __launch_bounds__(kThreads)
fier_retrieve_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv, rep, D]
                     const uint8_t* __restrict__ codes,
                     const __nv_bfloat16* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ zero,
                     const int* __restrict__ table,            // [B, n_btab] (K3)
                     const int* __restrict__ lengths,          // [B]
                     int* __restrict__ idx_out,                // [B, Hkv, budget]
                     float* __restrict__ tau_out,              // [B, Hkv]
                     int* __restrict__ m_out,                  // [B, Hkv]
                     int S, int Hkv, int rep, int group, int budget,
                     int reduce_sum, int sink, int recent, int bs) {
  constexpr int D = kD;
  constexpr int DPL = kDPL;
  extern __shared__ uint32_t keys[];  // [S], then (K3) the table row [n_btab]
  int* table_s = reinterpret_cast<int*>(keys + S);
  __shared__ float q_s[kMaxRep * kD];
  __shared__ int hist[kRadix];
  __shared__ int warp_pre[kWarps + 1];
  __shared__ int sel[2];

  const int row = blockIdx.x;  // b * Hkv + h
  const int b = row / Hkv;
  const int h = row - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int S8 = S >> 3;

  for (int i = tid; i < rep * D; i += kThreads)
    q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);
  if constexpr (kPaged) {
    const int n_btab = S / bs;
    for (int i = tid; i < n_btab; i += kThreads) table_s[i] = table[(size_t)b * n_btab + i];
  }
  __syncthreads();

  // The seq row (in units of Hkv*D elements) of byte-row i and of group grp.
  auto code_row = [&](int i) -> size_t {
    if constexpr (kPaged) {
      const int t = i * 8;
      return (size_t)table_s[t / bs] * (bs >> 3) + ((t % bs) >> 3);
    } else {
      return (size_t)b * S8 + i;
    }
  };
  auto group_row = [&](int grp) -> size_t {
    if constexpr (kPaged) {
      const int t = grp * group;
      return (size_t)table_s[t / bs] * (bs / group) + (t % bs) / group;
    } else {
      return (size_t)b * (S / group) + grp;
    }
  };

  // ---- score every token once; keys to shared memory -----------------
  const size_t row_stride = (size_t)Hkv * D;  // elements between seq rows
  const size_t lane_off = (size_t)h * D + lane * DPL;
  const uint8_t* codes_h = codes + lane_off;
  const __nv_bfloat16* scale_h = scale + lane_off;
  const __nv_bfloat16* zero_h = zero + lane_off;

  const int n_chunks = (S + 31) / 32;
  for (int c = warp; c < n_chunks; c += kWarps) {
    Chunk ch;
    load_chunk(ch, c, S8, group, codes_h, scale_h, zero_h, row_stride, code_row, group_row);
    float kv = 0.0f;
    for (int r = 0; r < rep; ++r) {
      const float s = score_chunk(ch, q_s + r * D, lane);
      kv = (r == 0) ? s : (reduce_sum ? kv + s : fmaxf(kv, s));
    }
    const int pos = c * 32 + lane;
    if (pos < S) {
      if (pos >= length) kv = -1e30f;
      if (sink > 0 && pos < sink) kv = __int_as_float(0x7f800000);
      if (recent > 0 && pos >= length - recent && pos < length) kv = __int_as_float(0x7f800000);
      keys[pos] = sortable_key(kv);
    }
  }
  __syncthreads();

  // ---- tau: 4 radix-256 passes over the keys --------------------------
  uint32_t tau_key;
  int m;  // |{ key > tau }|
  radix_select<kThreads>([&](int pos) { return keys[pos]; }, S, budget, hist, sel, tau_key, m);

  // ---- compaction: { key > tau } then the first (budget - m) ties -----
  int* out = idx_out + (size_t)row * budget;
  int n_gt = 0, n_tie = 0;
  for (int base = 0; base < S; base += kThreads) {
    const int pos = base + tid;
    int gt = 0, tie = 0;
    if (pos < S) {
      const uint32_t key = keys[pos];
      gt = key > tau_key;
      tie = key == tau_key;
    }
    const int packed = gt | (tie << 16);  // two counters, < 2^16 each per tile
    int incl = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += n;
    }
    if (lane == 31) warp_pre[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kWarps ? warp_pre[lane] : 0;
      int inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += n;
      }
      __syncwarp();
      if (lane < kWarps) warp_pre[lane] = inc - v;
      if (lane == kWarps - 1) warp_pre[kWarps] = inc;
    }
    __syncthreads();
    const int excl = incl - packed + warp_pre[warp];
    const int e_gt = excl & 0xFFFF;
    const int e_tie = excl >> 16;
    if (gt) {
      out[n_gt + e_gt] = pos;
    } else if (tie && n_tie + e_tie < budget - m) {
      out[m + n_tie + e_tie] = pos;
    }
    const int tile = warp_pre[kWarps];
    n_gt += tile & 0xFFFF;
    n_tie += tile >> 16;
    __syncthreads();
  }
  if (tid == 0) {
    tau_out[row] = unsortable(tau_key);
    m_out[row] = m;
  }
}

template <bool kPaged>
cudaError_t launch(const void* q, const void* codes, const void* scale, const void* zero,
                   const void* table, const void* lengths, void* idx, void* tau, void* m,
                   int B, int S, int Hkv, int rep, int group, int budget, int reduce_sum,
                   int sink, int recent, int bs, cudaStream_t stream) {
  const size_t smem = (size_t)S * sizeof(uint32_t) + (kPaged ? (size_t)(S / bs) * sizeof(int) : 0);
  auto kernel = fier_retrieve_kernel<kPaged>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(zero),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<int*>(idx), static_cast<float*>(tau), static_cast<int*>(m), S, Hkv, rep,
      group, budget, reduce_sum, sink, recent, bs);
  return cudaGetLastError();
}

}  // namespace

// table == nullptr: K1, the side-car is the slab [B, S/8 | S/g, Hkv, D].
// Otherwise K3: the side-car is a block pool [N, bs/8 | bs/g, Hkv, D] walked
// through table [B, S / bs].
extern "C" int fier_retrieve_launch(const void* q, const void* codes, const void* scale,
                                    const void* zero, const void* table, const void* lengths,
                                    void* idx, void* tau, void* m, int B, int S, int bs,
                                    int Hkv, int rep, int D, int group, int budget,
                                    int reduce_sum, int sink, int recent, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1 || rep > kMaxRep || D != kD) return (int)cudaErrorInvalidValue;
  if (table == nullptr)
    return (int)launch<false>(q, codes, scale, zero, nullptr, lengths, idx, tau, m, B, S, Hkv,
                              rep, group, budget, reduce_sum, sink, recent, 8, st);
  if (bs < 8 || bs % 8 || bs % group || S % bs) return (int)cudaErrorInvalidValue;
  return (int)launch<true>(q, codes, scale, zero, table, lengths, idx, tau, m, B, S, Hkv, rep,
                           group, budget, reduce_sum, sink, recent, bs, st);
}
