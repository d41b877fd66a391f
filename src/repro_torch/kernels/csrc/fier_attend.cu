// K2 fier_attend_selected: fused select-and-attend decode attention for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/sparse_attention.py::fused_sparse_attention_hm (pallas_call at
// :228, body _fused_kernel :133, online softmax _softmax_accumulate :39).
//
// What bounds it on the card: bytes.  Per (batch, kv-head) it reads the
// `budget` selected K rows and V rows (2 x budget x D x 2 bytes) straight from
// the seq-major [B, S, Hkv, D] cache slabs; at the serving shape (B = 4,
// Hkv = 16, budget = 1024, D = 128) that is 33.6 MB per call, about 10 us at
// 3.35 TB/s.  The arithmetic (2 x rep x D multiply-adds per row) is far below
// the card's rate.
//
// Design.  The (b, h) rows are split into tiles of 64 selected rows so that
// B x Hkv x budget/64 blocks (1024 at the serving shape) keep every SM busy
// with loads in flight; the TPU kernel's sequential grid carry becomes a
// second, small combine kernel:
//   * attend_partial: a tile's rows are gathered with 16-byte loads (D/8
//     lanes per row; each row is 2*D contiguous bytes of the slab) — no K'/V'
//     copy is made.  q.k is accumulated in f32 and scaled by 1/sqrt(D); slots
//     with idx >= length are masked to -1e30 (and their rows never loaded).
//     The tile's max m, its denominator sum(exp(s - m)) and its unnormalised
//     output sum(p v) go to a small f32 scratch (rep x (D + 2) per tile).
//   * attend_combine: per (b, h, query head) the tiles merge with the usual
//     rescaling exp(m_j - M), and the output is out / max(den, 1e-30), f32.
// With one tile (budget <= 64) the arithmetic is the reference's single-block
// online softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // selected rows per block
constexpr int kMaxRep = 8;
constexpr int kD = 128;         // d_head: the only one a model of the port has
constexpr int kLPR = kD / 8;    // lanes per row (each lane holds 8 channels = 16 bytes)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void bf16x8_to_float(const uint4& w, float (&out)[8]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(v[i] << 16);
    out[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
  }
}

__global__ void __launch_bounds__(kThreads)
attend_partial(const float* __restrict__ q,              // [B, Hkv, rep, D]
               const __nv_bfloat16* __restrict__ K,      // [B, S, Hkv, D]
               const __nv_bfloat16* __restrict__ V,      // [B, S, Hkv, D]
               const int* __restrict__ idx,              // [B, Hkv, budget]
               const int* __restrict__ lengths,          // [B]
               float* __restrict__ part_o,               // [B*Hkv, n_tiles, rep, D]
               float* __restrict__ part_md,              // [B*Hkv, n_tiles, rep, 2]
               int S, int Hkv, int rep, int budget, float scale) {
  constexpr int D = kD;
  constexpr int LPR = kLPR;
  constexpr int kGroups = kThreads / LPR;  // rows in flight per block
  extern __shared__ float smem[];
  float* q_s = smem;                  // [rep][D]
  float* p_s = q_s + rep * D;         // [rep][kTile] scores, then probabilities
  float* o_s = p_s + rep * kTile;     // [kGroups][rep][D]
  __shared__ int rows_s[kTile];
  __shared__ int valid_s[kTile];
  __shared__ float md_s[kMaxRep][2];

  const int bh = blockIdx.x;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int gid = tid / LPR;   // row slot within the block
  const int sl = tid % LPR;    // lane within the row: channels 8*sl .. 8*sl+7
  const int t0 = tile * kTile;
  const int nrows = min(kTile, budget - t0);
  const int length = lengths[b];

  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = q[(size_t)bh * rep * D + i];
  for (int t = tid; t < nrows; t += kThreads) {
    const int r = idx[(size_t)bh * budget + t0 + t];
    rows_s[t] = r;
    valid_s[t] = (r < length) && (r >= 0) && (r < S);
  }
  __syncthreads();

  const size_t row_elems = (size_t)Hkv * D;
  const __nv_bfloat16* Kbh = K + (size_t)b * S * row_elems + (size_t)h * D + sl * 8;
  const __nv_bfloat16* Vbh = V + (size_t)b * S * row_elems + (size_t)h * D + sl * 8;

  // ---- scores s = (q . k) * scale, masked --------------------------------
  for (int base = 0; base < nrows; base += kGroups) {  // uniform trip count
    const int t = base + gid;
    const bool in = t < nrows;
    const bool valid = in && valid_s[t];
    float kf[8];
    if (valid) {
      const uint4 w = *reinterpret_cast<const uint4*>(Kbh + (size_t)rows_s[t] * row_elems);
      bf16x8_to_float(w, kf);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) kf[k] = 0.0f;
    }
    for (int r = 0; r < rep; ++r) {
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) part += q_s[r * D + sl * 8 + k] * kf[k];
#pragma unroll
      for (int o = LPR / 2; o >= 1; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      if (in && sl == 0) p_s[r * kTile + t] = valid ? part * scale : -1e30f;
    }
  }
  __syncthreads();

  // ---- per query head: tile max, probabilities, denominator --------------
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < rep; r += kThreads / 32) {
    float mx = -__int_as_float(0x7f800000);
    for (int t = lane; t < nrows; t += 32) mx = fmaxf(mx, p_s[r * kTile + t]);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float den = 0.0f;
    for (int t = lane; t < nrows; t += 32) {
      const float p = valid_s[t] ? expf(p_s[r * kTile + t] - mx) : 0.0f;
      p_s[r * kTile + t] = p;
      den += p;
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) den += __shfl_xor_sync(kFull, den, o);
    if (lane == 0) {
      md_s[r][0] = mx;
      md_s[r][1] = den;
    }
  }
  __syncthreads();

  // ---- unnormalised output sum_t p[t] v[t] --------------------------------
  float acc[kMaxRep][8];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;
  for (int t = gid; t < nrows; t += kGroups) {
    if (!valid_s[t]) continue;
    float vf[8];
    const uint4 w = *reinterpret_cast<const uint4*>(Vbh + (size_t)rows_s[t] * row_elems);
    bf16x8_to_float(w, vf);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        const float p = p_s[r * kTile + t];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] += p * vf[k];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int k = 0; k < 8; ++k) o_s[(gid * rep + r) * D + sl * 8 + k] = acc[r][k];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bh * n_tiles + tile;
  for (int i = tid; i < rep * D; i += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < kGroups; ++g) s += o_s[g * rep * D + i];
    part_o[part * rep * D + i] = s;
  }
  for (int r = tid; r < rep; r += kThreads) {
    part_md[(part * rep + r) * 2 + 0] = md_s[r][0];
    part_md[(part * rep + r) * 2 + 1] = md_s[r][1];
  }
}

__global__ void attend_combine(const float* __restrict__ part_o,   // [BH, n_tiles, rep, D]
                               const float* __restrict__ part_md,  // [BH, n_tiles, rep, 2]
                               float* __restrict__ out,            // [BH, rep, D]
                               int n_tiles, int rep, int D) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    const int r = i / D;
    float M = -__int_as_float(0x7f800000);
    for (int j = 0; j < n_tiles; ++j)
      M = fmaxf(M, part_md[(((size_t)bh * n_tiles + j) * rep + r) * 2]);
    float num = 0.0f, den = 0.0f;
    for (int j = 0; j < n_tiles; ++j) {
      const size_t pj = (size_t)bh * n_tiles + j;
      const float w = expf(part_md[(pj * rep + r) * 2] - M);
      den += part_md[(pj * rep + r) * 2 + 1] * w;
      num += part_o[pj * rep * D + i] * w;
    }
    out[(size_t)bh * rep * D + i] = num / fmaxf(den, 1e-30f);
  }
}

cudaError_t launch(const void* q, const void* K, const void* V, const void* idx,
                   const void* lengths, void* part_o, void* part_md, void* out, int B,
                   int S, int Hkv, int rep, int budget, float scale, cudaStream_t stream) {
  constexpr int D = kD;
  constexpr int kGroups = kThreads / kLPR;
  const int n_tiles = (budget + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * ((size_t)rep * D + (size_t)rep * kTile +
                                       (size_t)kGroups * rep * D);
  auto kernel = attend_partial;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(K),
      static_cast<const __nv_bfloat16*>(V), static_cast<const int*>(idx),
      static_cast<const int*>(lengths), static_cast<float*>(part_o),
      static_cast<float*>(part_md), S, Hkv, rep, budget, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = rep * D < 1024 ? rep * D : 1024;
  attend_combine<<<B * Hkv, threads, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_md),
      static_cast<float*>(out), n_tiles, rep, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fier_attend_launch(const void* q, const void* K, const void* V,
                                  const void* idx, const void* lengths, void* part_o,
                                  void* part_md, void* out, int B, int S, int Hkv, int rep,
                                  int D, int budget, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1 || rep > kMaxRep || D != kD) return (int)cudaErrorInvalidValue;
  return (int)launch(q, K, V, idx, lengths, part_o, part_md, out, B, S, Hkv, rep, budget,
                     scale, st);
}
