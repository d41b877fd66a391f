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
// What bounds it on the card: bytes, and at the serving shape launch
// latency.  It must read the row once (32 KiB at S = 8192; 2 MiB for
// B x Hkv = 64 rows, 0.63 us at 3.35 TB/s) and write 8 bytes.
//
// Design.  The TPU kernel runs a 32-step bit-by-bit binary search over the
// monotone uint32 keys, counting keys >= candidate over the whole
// VMEM-resident row each step.  Here one block of 512 threads owns a row
// and runs K1's 4 radix-256 passes (fier_common.cuh: radix_select), so the
// two pipelines find tau and m by the same code.  Each pass re-reads the f32
// row from device memory (L2-resident after the first) and forms the keys in
// registers, so there is no shared-memory row and no row-length limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fier_common.cuh"

namespace {

using namespace fier;

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const float* __restrict__ scores,  // [BH, S]
                      float* __restrict__ tau_out,       // [BH]
                      int* __restrict__ m_out,           // [BH]
                      int S, int budget) {
  __shared__ int hist[kRadix];
  __shared__ int sel[2];
  const float* s = scores + (size_t)blockIdx.x * S;
  uint32_t tau_key;
  int m;
  radix_select<kThreads>([&](int pos) { return sortable_key(s[pos]); }, S, budget, hist, sel,
                         tau_key, m);
  if (threadIdx.x == 0) {
    tau_out[blockIdx.x] = unsortable(tau_key);
    m_out[blockIdx.x] = m;
  }
}

}  // namespace

extern "C" int fier_topk_launch(const void* scores, void* tau, void* m, int rows, int S,
                                int budget, void* stream) {
  if (budget <= 0 || budget > S) return (int)cudaErrorInvalidValue;
  topk_threshold_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(tau), static_cast<int*>(m), S,
      budget);
  return (int)cudaGetLastError();
}
