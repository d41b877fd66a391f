// K1 fier_retrieve: one-pass FIER retrieval for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_retrieval.py::fused_retrieve_hm
// (pallas_call at :284, body _kernel :168, _threshold_select :70,
// _masked_block_keys :147).
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
// Rows longer than the shared memory allows (about 56k tokens) are refused
// by the wrapper; a variant that re-scores per sweep is a later kernel.
// Only 64 blocks run at the serving shape (B x Hkv), fewer than the 132 SMs:
// splitting a row across a cluster is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kMaxRep = 8;
constexpr int kD = 128;          // d_head: the only one a model of the port has
constexpr int kDPL = kD / 32;    // channels per lane
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t sortable_key(float s) {
  uint32_t u = (s == 0.0f) ? 0u : __float_as_uint(s);  // -0.0 -> +0.0
  return (u >> 31) == 0 ? (u | 0x80000000u) : ~u;
}

__device__ __forceinline__ float unsortable(uint32_t key) {
  uint32_t u = (key >> 31) == 1 ? (key ^ 0x80000000u) : ~key;
  return __uint_as_float(u);
}

// The kDPL = 4 code bytes of one byte-row owned by a lane, as one word.
__device__ __forceinline__ uint32_t load_code_bytes(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// kDPL = 4 bf16 values as f32.
__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float (&out)[kDPL]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  out[0] = bf16_bits_to_float(w.x & 0xFFFFu);
  out[1] = bf16_bits_to_float(w.x >> 16);
  out[2] = bf16_bits_to_float(w.y & 0xFFFFu);
  out[3] = bf16_bits_to_float(w.y >> 16);
}

// 32 partial sums per lane -> lane l holds the warp-wide sum of entry l.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return v[0];
}

__global__ void __launch_bounds__(kThreads)
fier_retrieve_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv, rep, D]
                     const uint8_t* __restrict__ codes,        // [B, S/8, Hkv, D]
                     const __nv_bfloat16* __restrict__ scale,  // [B, S/g, Hkv, D]
                     const __nv_bfloat16* __restrict__ zero,   // [B, S/g, Hkv, D]
                     const int* __restrict__ lengths,          // [B]
                     int* __restrict__ idx_out,                // [B, Hkv, budget]
                     float* __restrict__ tau_out,              // [B, Hkv]
                     int* __restrict__ m_out,                  // [B, Hkv]
                     int S, int Hkv, int rep, int group, int budget,
                     int reduce_sum, int sink, int recent) {
  constexpr int D = kD;
  constexpr int DPL = kDPL;
  extern __shared__ uint32_t keys[];  // [S]
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
  __syncthreads();

  // ---- score every token once; keys to shared memory -----------------
  const size_t row_stride = (size_t)Hkv * D;  // elements between seq rows
  const uint8_t* codes_bh = codes + (size_t)b * S8 * row_stride + (size_t)h * D + lane * DPL;
  const size_t sz_off = (size_t)b * (S / group) * row_stride + (size_t)h * D + lane * DPL;
  const __nv_bfloat16* scale_bh = scale + sz_off;
  const __nv_bfloat16* zero_bh = zero + sz_off;

  const int n_chunks = (S + 31) / 32;
  for (int c = warp; c < n_chunks; c += kWarps) {
    float hi[4][DPL], lo[4][DPL];
    uint32_t word[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = c * 4 + j;  // byte-row: tokens 8i .. 8i+7
      if (i < S8) {
        const int grp = (i * 8) / group;
        word[j] = load_code_bytes(codes_bh + (size_t)i * row_stride);
        float sc[DPL], zr[DPL];
        load_bf16x4(scale_bh + (size_t)grp * row_stride, sc);
        load_bf16x4(zero_bh + (size_t)grp * row_stride, zr);
#pragma unroll
        for (int k = 0; k < DPL; ++k) {
          hi[j][k] = round_bf16(zr[k] + sc[k]);  // bf16(+1 * s + z)
          lo[j][k] = round_bf16(zr[k] - sc[k]);  // bf16(-1 * s + z)
        }
      } else {
        word[j] = 0;
#pragma unroll
        for (int k = 0; k < DPL; ++k) hi[j][k] = lo[j][k] = 0.0f;
      }
    }
    float kv = 0.0f;
    for (int r = 0; r < rep; ++r) {
      float acc[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) acc[t] = 0.0f;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const float qv = q_s[r * D + lane * DPL + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ph = qv * hi[j][k];  // exact: bf16 x bf16 in f32
          const float pl = qv * lo[j][k];
          const uint32_t byte = (word[j] >> (8 * k)) & 0xFFu;
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[8 * j + t] += ((byte >> t) & 1u) ? ph : pl;
        }
      }
      const float s = reduce_scatter32(acc, lane);
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
  uint32_t prefix = 0;
  int remaining = budget;
  int greater = 0;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    const uint32_t himask = p == 0 ? 0u : (0xFFFFFFFFu << (32 - 8 * p));
    for (int i = tid; i < kRadix; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < S; base += kThreads) {
      const int pos = base + tid;
      int digit = kRadix;  // sentinel: not taking part
      if (pos < S) {
        const uint32_t key = keys[pos];
        if ((key & himask) == prefix) digit = (key >> shift) & 0xFF;
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < kRadix && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane owns buckets 8*lane .. 8*lane+7; ge[j] = count(digit >= j)
      int v[8];
      int tot = 0;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        tot += hist[lane * 8 + k];
        v[k] = tot;
      }
      int incl = tot;  // sum over lanes >= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += n;
      }
      const int excl = incl - tot;  // buckets above this lane's
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ge = v[k] + excl;
        const int ge_next = (k < 7 ? v[k + 1] : 0) + excl;
        if (ge >= remaining && ge_next < remaining) {
          sel[0] = lane * 8 + k;  // tau's digit: highest bucket reaching `remaining`
          sel[1] = ge_next;       // participating keys strictly above it
        }
      }
    }
    __syncthreads();
    const int jstar = sel[0];
    const int above = sel[1];
    prefix |= (uint32_t)jstar << shift;
    remaining -= above;
    greater += above;
    __syncthreads();
  }
  const uint32_t tau_key = prefix;
  const int m = greater;  // |{ key > tau }|

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

cudaError_t launch(const void* q, const void* codes, const void* scale, const void* zero,
                   const void* lengths, void* idx, void* tau, void* m, int B, int S,
                   int Hkv, int rep, int group, int budget, int reduce_sum, int sink,
                   int recent, cudaStream_t stream) {
  const size_t smem = (size_t)S * sizeof(uint32_t);
  auto kernel = fier_retrieve_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(zero),
      static_cast<const int*>(lengths), static_cast<int*>(idx), static_cast<float*>(tau),
      static_cast<int*>(m), S, Hkv, rep, group, budget, reduce_sum, sink, recent);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fier_retrieve_launch(const void* q, const void* codes, const void* scale,
                                    const void* zero, const void* lengths, void* idx,
                                    void* tau, void* m, int B, int S, int Hkv, int rep,
                                    int D, int group, int budget, int reduce_sum, int sink,
                                    int recent, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1 || rep > kMaxRep || D != kD) return (int)cudaErrorInvalidValue;
  return (int)launch(q, codes, scale, zero, lengths, idx, tau, m, B, S, Hkv, rep, group,
                     budget, reduce_sum, sink, recent, st);
}
