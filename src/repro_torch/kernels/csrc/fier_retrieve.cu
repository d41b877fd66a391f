// K1's fixed instantiations (fier_retrieve.cuh has the kernel and its
// design): d_head 16, 32, 64, 112 and 128 at reps up to 16 on the slab; K3's
// are fier_retrieve_paged.cu's, and fier_retrieve_any.cu builds the generic
// layout that takes every other shape.

#include "fier_retrieve.cuh"

extern "C" int fier_retrieve_launch(const void* q, const void* codes, const void* scale,
                                    const void* zero, const void* table, const void* lengths,
                                    void* idx, void* tau, void* m, int B, int S, int bs,
                                    int Hkv, int rep, int D, int group, int budget,
                                    int reduce_sum, int sink, int recent, int cluster,
                                    int cta_tokens, void* keys, void* stream) {
  using Pick = Fixed<false>;
  return retrieve_launch<Pick>(q, codes, scale, zero, table, lengths, idx, tau, m, B, S, bs, Hkv,
                               rep, D, group, budget, reduce_sum, sink, recent, cluster,
                               cta_tokens, keys, stream);
}
