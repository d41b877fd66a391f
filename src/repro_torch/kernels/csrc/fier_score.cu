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
// multiply-adds per token and query head) is far below the card's f32 rate,
// but the scoring warp's issue slots (a 16-entry sum table, 32 lookups and
// a 31-step reduce-scatter per chunk and query head) come close to the
// byte time.
//
// Design.  One resident wave: fier_score.score_plan splits each row into
// `parts` contiguous runs of `part_chunks` 32-token chunks and launches at
// most one CTA per SM (512 threads, 256 when g is not a multiple of 32); a
// CTA walks the (row, part) units blockIdx.x, + gridDim.x, ... (one unit
// per CTA when rows x parts <= the SM count: 2 x 64 = 128 CTAs at the
// serving shape).  Per unit the CTA stages q once; each warp then scores
// the unit's chunks c0 + warp, + kWarps, ... and loads the next chunk's
// code words and scale/zero (a register double buffer, as K1's) before it
// scores the current one, so every warp keeps a chunk's bytes in flight.  A
// chunk is loaded and scored by the device functions K1 uses
// (fier_common.cuh: load_chunk, score_chunk), from the seq-major
// [B, S/8, Hkv, D] / [B, S/g, Hkv, D] side-car directly, so every score
// equals K1's internal score of that token and query head bit for bit.
// Lane l stores token 32c + l of each query head: 128 contiguous bytes per
// warp and head.  A warp reads 128 contiguous code bytes per byte-row and
// 256 of scale and of zero per group: every 32-byte sector it touches is
// used whole, so a CTA keeps to one kv head (q of one head staged, the rows
// split evenly) rather than reading whole 2 KB byte-rows of all heads.
//
// d_head (16, 32, 64, 112 or 128) and the query heads q_s holds (rep_slots: 8 at d_head
// 128 up to rep 8, else 16) are template parameters, instantiated as K1's
// are, so the scores stay K1's at every shape either takes.  Every other
// (d_head, rep) runs the generic instantiation of its layout class, as K1's
// does (kMaxRep = 0: 256 threads, d_head at run time, score_chunk_any; the
// query heads staged in blocks of kAnyQFloats / D, each block a pass over
// the unit's chunks that writes its heads' scores), so its scores are K1's
// generic scores bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fier_common.cuh"

namespace {

using namespace fier;

// Threads per CTA: 512 (one CTA per SM, 128 registers) when a chunk has one
// group, else 256, so that the 4-group chunk's double buffer fits registers;
// 256 for the generic layout (kAny), as K1's.
template <int kGroups, bool kAny = false>
__host__ __device__ constexpr int threads_for() { return kGroups == 1 && !kAny ? 512 : 256; }

// Chunk<kGroups, kD>: kGroups 1 when group % 32 == 0, else 4; kD d_head;
// kMaxRep the query heads q_s holds.  kMaxRep = 0: the generic layout of
// class kD at d_head D_any.
template <int kGroups, int kD, int kMaxRep>
__global__ void __launch_bounds__(threads_for<kGroups, kMaxRep == 0>(), 1)
fier_score_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv, rep, D]
                  const uint8_t* __restrict__ codes,        // [B, S/8, Hkv, D]
                  const __nv_bfloat16* __restrict__ scale,  // [B, S/g, Hkv, D]
                  const __nv_bfloat16* __restrict__ zero,   // [B, S/g, Hkv, D]
                  float* __restrict__ out,                  // [B, Hkv, rep, S]
                  int rows, int S, int Hkv, int rep, int group, int parts, int part_chunks,
                  int D_any) {
  constexpr bool kAny = kMaxRep == 0;
  const int D = kAny ? D_any : kD;
  constexpr int kDPL = lane_channels(kD);  // channels per lane of the scoring warp
  constexpr int kThreads = threads_for<kGroups, kAny>();
  constexpr int kWarps = kThreads / 32;
  constexpr int kTableFloats = table_floats<kD>();
  __shared__ float q_s[kAny ? kAnyQFloats : kMaxRep * kD];
  __shared__ float tabs[kWarps * kTableFloats];  // score_chunk's sums, per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S8 = S >> 3;
  const int n_chunks = (S + 31) / 32;
  const size_t row_stride = (size_t)Hkv * D;  // elements between seq rows

  for (int u = blockIdx.x; u < rows * parts; u += gridDim.x) {
    const int row = u / parts;  // b * Hkv + h
    const int b = row / Hkv;
    const int h = row - b * Hkv;
    if constexpr (!kAny) {
      __syncthreads();  // every warp is done with the previous unit's q
      for (int i = tid; i < rep * D; i += kThreads)
        q_s[i] = __bfloat162float(q[(size_t)row * rep * D + i]);
      __syncthreads();
    }

    auto code_row = [&](int i) -> size_t { return (size_t)b * S8 + i; };
    auto group_row = [&](int t) -> size_t { return (size_t)b * (S / group) + t / group; };
    const size_t lane_off = (size_t)h * D + lane * kDPL;
    const uint8_t* codes_h = codes + lane_off;
    const __nv_bfloat16* scale_h = scale + lane_off;
    const __nv_bfloat16* zero_h = zero + lane_off;
    float* out_row = out + (size_t)row * rep * S;

    const int c0 = (u - row * parts) * part_chunks;
    const int c1 = min(n_chunks, c0 + part_chunks);
    if constexpr (kAny) {
      const int hb = kAnyQFloats / D;  // query heads per block (16 at D 256)
      auto load = [&](AnyChunk<kGroups, kD>& ch, int c) {
        load_chunk_any(ch, D, c, S8, codes_h, scale_h, zero_h, row_stride, code_row, group_row);
      };
      for (int r0 = 0; r0 < rep; r0 += hb) {
        const int nr = min(hb, rep - r0);  // this block's query heads
        __syncthreads();  // every warp is done with the previous block's q
        for (int i = tid; i < nr * D; i += kThreads)
          q_s[i] = __bfloat162float(q[((size_t)row * rep + r0) * D + i]);
        __syncthreads();
        int c = c0 + warp;
        AnyChunk<kGroups, kD> cur, nxt;
        if (c < c1) load(cur, c);
        for (; c < c1; c += kWarps) {  // warp-uniform trip count
          if (kGroups == 1 && c + kWarps < c1) load(nxt, c + kWarps);
          const int pos = c * 32 + lane;
          for (int r = 0; r < nr; ++r) {
            const float s =
                score_chunk_any(cur, q_s + r * D, D, lane, tabs + warp * kTableFloats);
            if (pos < S) out_row[(size_t)(r0 + r) * S + pos] = s;
          }
          if constexpr (kGroups == 1) {
            cur = nxt;
          } else if (c + kWarps < c1) {
            load(cur, c + kWarps);
          }
        }
      }
    } else {
      int c = c0 + warp;
      Chunk<kGroups, kD> cur, nxt;
      if (c < c1)
        load_chunk(cur, c, S8, codes_h, scale_h, zero_h, row_stride, code_row, group_row);
      for (; c < c1; c += kWarps) {  // warp-uniform trip count
        if (c + kWarps < c1)
          load_chunk(nxt, c + kWarps, S8, codes_h, scale_h, zero_h, row_stride, code_row,
                     group_row);
        const int pos = c * 32 + lane;
        for (int r = 0; r < rep; ++r) {
          const float s = score_chunk(cur, q_s + r * D, lane, tabs + warp * kTableFloats);
          if (pos < S) out_row[(size_t)r * S + pos] = s;
        }
        cur = nxt;
      }
    }
  }
}

template <int kD, int kMaxRep>
cudaError_t launch(const void* q, const void* codes, const void* scale, const void* zero,
                   void* out, int rows, int S, int Hkv, int rep, int D, int group, int parts,
                   int part_chunks, int grid, cudaStream_t stream) {
  const bool one = group % 32 == 0;
  constexpr bool kAny = kMaxRep == 0;
  auto kernel = one ? &fier_score_kernel<1, kD, kMaxRep> : &fier_score_kernel<4, kD, kMaxRep>;
  kernel<<<grid, one ? threads_for<1, kAny>() : threads_for<4, kAny>(), 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(zero),
      static_cast<float*>(out), rows, S, Hkv, rep, group, parts, part_chunks, D);
  return cudaGetLastError();
}

}  // namespace

// Each of the B x Hkv rows is split into `parts` runs of `part_chunks`
// 32-token chunks, and `grid` CTAs walk the units (fier_score.score_plan).
extern "C" int fier_score_launch(const void* q, const void* codes, const void* scale,
                                 const void* zero, void* out, int B, int S, int Hkv, int rep,
                                 int D, int group, int parts, int part_chunks, int grid,
                                 void* stream) {
  if (rep < 1 || D < 8 || D > 256 || D % 8 || group <= 0 || group % 8 || S % group)
    return (int)cudaErrorInvalidValue;
  if (parts < 1 || part_chunks < 1 || (long long)parts * part_chunks * 32 < S || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int w = any_class(D);
  auto go = !fixed_shape(D, rep) ? (w == 32    ? &launch<32, 0>
                                    : w == 64  ? &launch<64, 0>
                                    : w == 128 ? &launch<128, 0>
                                               : &launch<256, 0>)
            : D == 16  ? &launch<16, 16>
            : D == 32  ? &launch<32, 16>
            : D == 64  ? &launch<64, 16>
            : D == 112 ? &launch<112, 16>
            : rep_slots(D, rep) == 8 ? &launch<128, 8>
                                     : &launch<128, 16>;
  return (int)go(q, codes, scale, zero, out, B * Hkv, S, Hkv, rep, D, group, parts, part_chunks,
                 grid, static_cast<cudaStream_t>(stream));
}
