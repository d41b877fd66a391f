// K7 fier_topk_threshold: the two-pass threshold search for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/topk_select.py::topk_threshold_hm
// (pallas_call at :101, body _kernel :53).
//
// Per row of masked f32 scores [BH, S] it finds tau, the budget-th largest
// score (-0.0 taken as +0.0), and m, the count strictly greater.  The index
// set { s > tau } + the first (budget - m) ties is compact_indices' work
// (plain torch, as the JAX package leaves it to jnp).
//
// What bounds it on the card: bytes, and at the serving shape latency.  It
// must read the row once (32 KiB at S = 8192; 2 MiB for B x Hkv = 64 rows,
// 0.63 us at 3.35 TB/s) and write 8 bytes.  What it does beyond that read is
// four rounds of a histogram and a scan, each behind a barrier.
//
// Design.  The TPU kernel runs a 32-step bit-by-bit binary search over the
// monotone uint32 keys, counting keys >= candidate over the whole
// VMEM-resident row each step.  Here K1's 4 radix-256 passes
// (fier_common.cuh: radix_select) find tau and m, so the two pipelines
// share the search code:
//   * A row takes C CTAs of 512 threads, each a contiguous range of it
//     (topk_select.topk_plan): one CTA up to 12,288 scores (the serving
//     rows), else a thread-block cluster of up to 8, as many as one wave of
//     one CTA per SM allows, and more where the keys need the shared memory.
//     A pass's cluster barrier and DSMEM sum cost about 1 us on an H100
//     (tools/probe_score_topk.py), more than a split of a short row saves.
//   * Read once.  Each CTA issues every copy of its range at once, 16-byte
//     cp.async into shared memory (4-byte copies at a range's unaligned
//     ends), and waits once: all of a CTA's bytes are in flight together.
//     It then forms the keys in place and counts radix pass 0 while it
//     forms them; passes 1-3 read shared memory.
//   * In a cluster, each pass's histogram is summed through distributed
//     shared memory (map_shared_rank) after a cluster barrier, as K1 does;
//     every CTA derives the same digit, and rank 0 writes tau and m.  One
//     CTA uses its own histogram and no cluster barrier.
// Where 8 CTAs cannot hold a row's keys (about 450k tokens; long_500k:
// S = 524,288) the same kernel body re-reads the f32 row from device memory
// on every pass (the template flag kSmemKeys): the row is already in device
// memory, so there is still no row-length limit and no scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fier_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fier;

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kSmemLimit = 232448;  // shared memory a CTA may use on sm_90
constexpr int kSmemStatic = 6144;   // topk_select.SMEM_STATIC
static_assert((kPasses * kRadix + kRadix + 2) * 4 <= kSmemStatic,
              "static shared memory outgrew the wrapper's SMEM_STATIC");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kSmemKeys: the CTA's keys in shared memory (dynamic, T + 4 words);
// otherwise every pass reads its range of the row from device memory.
template <bool kSmemKeys>
__global__ void __launch_bounds__(kThreads, 1)
topk_threshold_kernel(const float* __restrict__ scores,  // [BH, S]
                      float* __restrict__ tau_out,       // [BH]
                      int* __restrict__ m_out,           // [BH]
                      int S, int budget, int T) {
  extern __shared__ __align__(16) uint32_t keys_s[];
  __shared__ int hist[kPasses * kRadix];
  __shared__ int tot[kRadix];
  __shared__ int sel[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t0 = min(rank * T, S);
  const int n = min(t0 + T, S) - t0;  // keys of this CTA
  const float* s = scores + (size_t)row * S + t0;

  for (int i = tid; i < kPasses * kRadix; i += kThreads) hist[i] = 0;

  // s[i] lands at keys_s[lead + i]: lead puts 16-byte aligned runs of s on
  // 16-byte aligned words of keys_s
  const int lead = kSmemKeys ? (int)((reinterpret_cast<uintptr_t>(s) >> 2) & 3) : 0;
  if constexpr (kSmemKeys) {
    // vector v holds s[4v - lead .. 4v - lead + 3] at keys_s[4v .. 4v + 3]
    const float* base = s - lead;  // 16-byte aligned; read only inside [s, s + n)
    const int n_vec = (lead + n + 3) / 4;
    for (int v = tid; v < n_vec; v += kThreads) {
      const int i0 = 4 * v - lead;
      if (i0 >= 0 && i0 + 4 <= n) {
        cp_async16(keys_s + 4 * v, base + 4 * v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i0 + e >= 0 && i0 + e < n) cp_async4(keys_s + 4 * v + e, base + 4 * v + e);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the whole range has landed; hist is zeroed
    for (int v0 = 0; v0 < n_vec; v0 += kThreads) {  // warp-uniform trip count
      const int v = v0 + tid;
      const uint4 w = v < n_vec ? reinterpret_cast<const uint4*>(keys_s)[v] : make_uint4(0, 0, 0, 0);
      uint32_t k[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = v < n_vec && 4 * v + e - lead >= 0 && 4 * v + e - lead < n;
        k[e] = in ? sortable_key(__uint_as_float(k[e])) : 0u;
        count_digit(hist, k[e], in, 0u, 0u, 24, lane);  // radix pass 0
      }
      if (v < n_vec) reinterpret_cast<uint4*>(keys_s)[v] = make_uint4(k[0], k[1], k[2], k[3]);
    }
  }
  __syncthreads();

  auto key_at = [&](int i) -> uint32_t {
    if constexpr (kSmemKeys) return keys_s[lead + i];
    else return sortable_key(s[i]);
  };
  auto cluster_total = [&](int, const int* hp) -> const int* {
    if (C == 1) return hp;  // the CTA's own histogram is the row's
    cluster.sync();  // every CTA's histogram of this pass is complete
    int* own = const_cast<int*>(hp);
    for (int i = tid; i < kRadix; i += kThreads) {
      int sum = 0;
      for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(own, r)[i];
      tot[i] = sum;
    }
    __syncthreads();
    return tot;
  };
  uint32_t tau_key;
  int m;
  radix_select<kThreads>(key_at, n, budget, hist, sel, cluster_total, kSmemKeys, tau_key, m);
  if (rank == 0 && tid == 0) {
    tau_out[row] = unsortable(tau_key);
    m_out[row] = m;
  }
  if (C > 1) cluster.sync();  // no CTA leaves while another may still read its histograms
}

template <bool kSmemKeys>
cudaError_t launch(const float* scores, float* tau, int* m, int rows, int S, int budget, int C,
                   int T, cudaStream_t stream) {
  const size_t smem = kSmemKeys ? ((size_t)T + 4) * 4 : 0;
  if (smem + kSmemStatic > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = topk_threshold_kernel<kSmemKeys>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one CTA per row: no cluster, no cluster barrier
  err = cudaLaunchKernelEx(&cfg, kernel, scores, tau, m, S, budget, T);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// cluster CTAs split each row, cta_tokens each (topk_select.topk_plan);
// smem_keys != 0 keeps a CTA's keys in shared memory, else every pass
// re-reads the row.
extern "C" int fier_topk_launch(const void* scores, void* tau, void* m, int rows, int S,
                                int budget, int cluster, int cta_tokens, int smem_keys,
                                void* stream) {
  if (budget <= 0 || budget > S || rows <= 0) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || cta_tokens <= 0 ||
      (long long)cluster * cta_tokens < S)
    return (int)cudaErrorInvalidValue;
  auto go = smem_keys ? &launch<true> : &launch<false>;
  return (int)go(static_cast<const float*>(scores), static_cast<float*>(tau),
                 static_cast<int*>(m), rows, S, budget, cluster, cta_tokens,
                 static_cast<cudaStream_t>(stream));
}
