// K2's fixed instantiations (fier_attend.cuh has the kernel and its design):
// d_head 16, 32, 64 and 128 at reps 1, 2, 4, 8, 12 and 16, d_head 112 at rep
// 1, over the slab; K4's and K8's are fier_attend_paged.cu's and
// fier_attend_gathered.cu's, and fier_attend_any.cu builds the generic
// layout that takes every other shape.

#include "fier_attend.cuh"

extern "C" int fier_attend_launch(const void* q, const void* K, const void* V,
                                  const void* table, const void* idx, const void* lengths,
                                  void* out, int B, int S, int bs, int Hkv, int rep, int D,
                                  int budget, float scale, int cluster, int chunk, int q_bf16,
                                  void* stream) {
  using Pick = Fixed<kSlab>;
  return attend_launch<Pick>(q, K, V, table, idx, lengths, out, B, S, bs, Hkv, rep, D, budget,
                             scale, cluster, chunk, q_bf16, stream);
}
