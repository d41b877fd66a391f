// Device code shared by the FIER kernels for Hopper (sm_90a):
//   * the warp that scores 32 consecutive tokens from the packed 1-bit
//     side-car (K1/K3 in fier_retrieve.cu, K6 in fier_score.cu), so the
//     two-pass score scan writes exactly the per-token scores the one-pass
//     retrieval kernel keeps in registers;
//   * the monotone uint32 score keys and the radix-256 threshold search
//     (K1/K3 over shared-memory keys, K7 in fier_topk.cu over a score row in
//     device memory), so both find the same tau and m.
// Every helper here is the code K1 ran before it was shared, unchanged.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fier {

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

// One 32-token chunk (4 byte-rows) as lane l holds it: the code bytes of its
// kDPL channels and the two possible dequantized keys bf16(z + s) and
// bf16(z - s) of each, exactly the score_block expression.
struct Chunk {
  uint32_t word[4];
  float hi[4][kDPL], lo[4][kDPL];
};

// Load chunk c.  codes_h/scale_h/zero_h point at this lane's channels of the
// (batch, kv-head) row; code_row(i) / group_row(grp) give the seq row (in
// units of row_stride elements) of byte-row i and of group grp: the address
// policy (slab or paged) is the caller's.  Byte-rows past S8 load as zeros.
template <class CodeRow, class GroupRow>
__device__ __forceinline__ void load_chunk(Chunk& ch, int c, int S8, int group,
                                           const uint8_t* codes_h,
                                           const __nv_bfloat16* scale_h,
                                           const __nv_bfloat16* zero_h, size_t row_stride,
                                           CodeRow code_row, GroupRow group_row) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = c * 4 + j;  // byte-row: tokens 8i .. 8i+7
    if (i < S8) {
      const int grp = (i * 8) / group;
      ch.word[j] = load_code_bytes(codes_h + code_row(i) * row_stride);
      const size_t gr = group_row(grp) * row_stride;
      float sc[kDPL], zr[kDPL];
      load_bf16x4(scale_h + gr, sc);
      load_bf16x4(zero_h + gr, zr);
#pragma unroll
      for (int k = 0; k < kDPL; ++k) {
        ch.hi[j][k] = round_bf16(zr[k] + sc[k]);  // bf16(+1 * s + z)
        ch.lo[j][k] = round_bf16(zr[k] - sc[k]);  // bf16(-1 * s + z)
      }
    } else {
      ch.word[j] = 0;
#pragma unroll
      for (int k = 0; k < kDPL; ++k) ch.hi[j][k] = ch.lo[j][k] = 0.0f;
    }
  }
}

// The f32 score q_r . a of token 32c + lane for one query head q_r [kD] (f32
// holding bf16 values).  Lane l accumulates its channels' products for all 32
// tokens (each bf16 x bf16 product is exact in f32, so picking the
// precomputed product by the sign bit is the same arithmetic), and a
// butterfly reduce-scatter leaves lane l with token l's sum.
__device__ __forceinline__ float score_chunk(const Chunk& ch, const float* q_r, int lane) {
  float acc[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) acc[t] = 0.0f;
#pragma unroll
  for (int k = 0; k < kDPL; ++k) {
    const float qv = q_r[lane * kDPL + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ph = qv * ch.hi[j][k];  // exact: bf16 x bf16 in f32
      const float pl = qv * ch.lo[j][k];
      const uint32_t byte = (ch.word[j] >> (8 * k)) & 0xFFu;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[8 * j + t] += ((byte >> t) & 1u) ? ph : pl;
    }
  }
  return reduce_scatter32(acc, lane);
}

// tau (as a key) and m = |{ key > tau }| of the budget-th largest of the S
// keys key_at(0 .. S-1), by 4 radix-256 passes with warp-aggregated
// shared-memory histograms (__match_any_sync).  Every thread of the
// kThreads-thread block calls it and gets the result; hist [kRadix] and
// sel [2] are shared scratch.
template <int kThreads, class KeyAt>
__device__ __forceinline__ void radix_select(KeyAt key_at, int S, int budget, int* hist, int* sel,
                                             uint32_t& tau_key, int& m) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
        const uint32_t key = key_at(pos);
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
  tau_key = prefix;
  m = greater;
}

}  // namespace fier
