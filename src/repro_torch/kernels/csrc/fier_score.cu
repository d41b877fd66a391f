// K6 fier_score_scan: the two-pass FIER score scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fier_score.py::fier_score_hm
// (pallas_call at :110, body _kernel :87, expression score_block :35).
//
// What bounds it on the card: bytes.  Per (batch, kv-head) row it reads the
// packed sign codes (S/8 x D bytes) and the bf16 group scale/zero
// (2 x S/g x D x 2 bytes) once and writes rep x S f32 scores; at the serving
// shape (B = 4, Hkv = 16, rep = 1, S = 8192, D = 128, g = 32) that is
// 18.9 MB per call, about 5.6 us at 3.35 TB/s.  The arithmetic (D
// multiply-adds per token and query head) is far below the card's rate.
//
// Design.  Unlike K1, tokens are independent here, so a row is spread over
// many blocks: block (row, y) scores tokens [512y, 512y + 512) with 8 warps,
// each warp a 32-token chunk at a time.  A chunk is loaded and scored by the
// device functions K1 uses (fier_common.cuh: load_chunk, score_chunk), from
// the seq-major [B, S/8, Hkv, D] / [B, S/g, Hkv, D] side-car directly, so
// every score equals K1's internal score of that token and query head bit
// for bit.  Lane l stores token 32c + l of each query head: 128 contiguous
// bytes per warp and head.  B x Hkv x S/512 blocks (1024 at the serving
// shape) fill the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fier_common.cuh"

namespace {

using namespace fier;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockTokens = 512;
constexpr int kBlockChunks = kBlockTokens / 32;

__global__ void __launch_bounds__(kThreads)
fier_score_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv, rep, D]
                  const uint8_t* __restrict__ codes,        // [B, S/8, Hkv, D]
                  const __nv_bfloat16* __restrict__ scale,  // [B, S/g, Hkv, D]
                  const __nv_bfloat16* __restrict__ zero,   // [B, S/g, Hkv, D]
                  float* __restrict__ out,                  // [B, Hkv, rep, S]
                  int S, int Hkv, int rep, int group) {
  constexpr int D = kD;
  __shared__ float q_s[kMaxRep * kD];

  const int row = blockIdx.x;  // b * Hkv + h
  const int b = row / Hkv;
  const int h = row - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S8 = S >> 3;

  for (int i = tid; i < rep * D; i += kThreads)
    q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);
  __syncthreads();

  auto code_row = [&](int i) -> size_t { return (size_t)b * S8 + i; };
  auto group_row = [&](int grp) -> size_t { return (size_t)b * (S / group) + grp; };
  const size_t row_stride = (size_t)Hkv * D;
  const size_t lane_off = (size_t)h * D + lane * kDPL;
  float* out_row = out + (size_t)row * rep * S;

  const int n_chunks = (S + 31) / 32;
  const int c0 = blockIdx.y * kBlockChunks;
  const int c1 = min(n_chunks, c0 + kBlockChunks);
  for (int c = c0 + warp; c < c1; c += kWarps) {  // warp-uniform trip count
    Chunk ch;
    load_chunk(ch, c, S8, group, codes + lane_off, scale + lane_off, zero + lane_off,
               row_stride, code_row, group_row);
    const int pos = c * 32 + lane;
    for (int r = 0; r < rep; ++r) {
      const float s = score_chunk(ch, q_s + r * D, lane);
      if (pos < S) out_row[(size_t)r * S + pos] = s;
    }
  }
}

}  // namespace

extern "C" int fier_score_launch(const void* q, const void* codes, const void* scale,
                                 const void* zero, void* out, int B, int S, int Hkv, int rep,
                                 int D, int group, void* stream) {
  if (rep < 1 || rep > kMaxRep || D != kD || group <= 0 || group % 8 || S % group)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B * Hkv, (S + kBlockTokens - 1) / kBlockTokens);
  fier_score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(zero),
      static_cast<float*>(out), S, Hkv, rep, group);
  return (int)cudaGetLastError();
}
