// K5 fier_pack_quantize: 1-bit group quantize and bit-pack of a key slab
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pack_quantize.py::pack_quantize_hm
// (pallas_call at :52, body _kernel :20), with its arithmetic: per
// (group of g tokens, channel) the min and max in f32, zero = (max+min)/2
// and scale = (max-min)/2 in f32, both stored bf16; bit t of code byte i is
// k[8i+t] >= f32(bf16(zero)), the zero as stored.  That is not quite
// core/quantize.quantize, which takes the midpoint in the key's dtype (bf16
// on the serving path), so nothing on the serving path calls this kernel.
//
// What bounds it on the card: bytes.  It reads the key slab once (B x S x
// Hkv x D elements: 134 MB of bf16 at the serving shape B = 4, S = 8192,
// Hkv = 16, D = 128) and writes 1/16 of that as codes plus 1/g of it twice
// as bf16 scale/zero: 151 MB, 45 us at 3.35 TB/s.
//
// Design.  One thread per (b, group, kv-head, channel) on the seq-major
// [B, S, Hkv, D] slab: neighbouring threads own neighbouring channels, so
// every load of a token row is coalesced, and the outputs land in the
// seq-major side-car layout [B, S/8 | S/g, Hkv, D] with no transpose.  The
// thread reads its g values for min/max, then again (from L1/L2) for the
// sign bits, and writes g/8 code bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_quantize_kernel(const T* __restrict__ k,              // [B, S, Hkv, D]
                     uint8_t* __restrict__ codes,          // [B, S/8, Hkv, D]
                     __nv_bfloat16* __restrict__ scale,    // [B, S/g, Hkv, D]
                     __nv_bfloat16* __restrict__ zero,     // [B, S/g, Hkv, D]
                     size_t n_cells, int HD, int group) {
  const size_t cell = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (cell >= n_cells) return;
  const size_t bg = cell / HD;  // b * (S/g) + grp
  const int hd = (int)(cell - bg * HD);
  const T* kp = k + bg * group * HD + hd;
  float mx = -__int_as_float(0x7f800000);
  float mn = __int_as_float(0x7f800000);
  for (int t = 0; t < group; ++t) {
    const float v = to_f32(kp[(size_t)t * HD]);
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
  const __nv_bfloat16 zb = __float2bfloat16_rn((mx + mn) * 0.5f);
  const float z = __bfloat162float(zb);  // compare against the stored zero
  uint8_t* cp = codes + bg * (group / 8) * HD + hd;
  for (int i = 0; i < group / 8; ++i) {
    uint32_t byte = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) byte |= (to_f32(kp[(size_t)(8 * i + t) * HD]) >= z ? 1u : 0u) << t;
    cp[(size_t)i * HD] = (uint8_t)byte;
  }
  scale[cell] = __float2bfloat16_rn((mx - mn) * 0.5f);
  zero[cell] = zb;
}

template <typename T>
cudaError_t launch(const void* k, void* codes, void* scale, void* zero, int B, int S, int HD,
                   int group, cudaStream_t stream) {
  const size_t n_cells = (size_t)B * (S / group) * HD;
  const unsigned blocks = (unsigned)((n_cells + kThreads - 1) / kThreads);
  pack_quantize_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<uint8_t*>(codes),
      static_cast<__nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(zero), n_cells, HD, group);
  return cudaGetLastError();
}

}  // namespace

// k_is_f32 != 0: k holds f32 values, else bf16.
extern "C" int fier_pack_launch(const void* k, void* codes, void* scale, void* zero, int B,
                                int S, int Hkv, int D, int group, int k_is_f32, void* stream) {
  if (group <= 0 || group % 8 || S % group) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_is_f32) return (int)launch<float>(k, codes, scale, zero, B, S, Hkv * D, group, st);
  return (int)launch<__nv_bfloat16>(k, codes, scale, zero, B, S, Hkv * D, group, st);
}
