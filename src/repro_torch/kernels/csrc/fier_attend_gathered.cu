// K8's fixed instantiations (fier_attend.cuh has the kernel and its design):
// K2's shapes over rows gathered beforehand (k_sel/v_sel [B, budget, Hkv, D]
// with element strides, each a multiple of 8, and an int8 validity mask).

#include "fier_attend.cuh"

extern "C" int fier_attend_gathered_launch(const void* q, const void* k_sel, const void* v_sel,
                                           const void* mask, void* out, int B, int budget,
                                           int Hkv, int rep, int D, long long sb, long long st,
                                           long long sh, float scale, int cluster, int chunk,
                                           int q_bf16, void* stream) {
  using Pick = Fixed<kGathered>;
  return attend_gathered_launch<Pick>(q, k_sel, v_sel, mask, out, B, budget, Hkv, rep, D, sb, st,
                                      sh, scale, cluster, chunk, q_bf16, stream);
}
