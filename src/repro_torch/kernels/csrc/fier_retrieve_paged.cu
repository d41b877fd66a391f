// K3's fixed instantiations (fier_retrieve.cuh has the kernel and its
// design): K1's shapes on a block pool walked through a block table; K1's
// are fier_retrieve.cu's.

#include "fier_retrieve.cuh"

extern "C" int fier_retrieve_paged_launch(const void* q, const void* codes, const void* scale,
                                          const void* zero, const void* table, const void* lengths,
                                          void* idx, void* tau, void* m, int B, int S, int bs,
                                          int Hkv, int rep, int D, int group, int budget,
                                          int reduce_sum, int sink, int recent, int cluster,
                                          int cta_tokens, void* keys, void* stream) {
  using Pick = Fixed<true>;
  return retrieve_launch<Pick>(q, codes, scale, zero, table, lengths, idx, tau, m, B, S, bs, Hkv,
                               rep, D, group, budget, reduce_sum, sink, recent, cluster,
                               cta_tokens, keys, stream);
}
