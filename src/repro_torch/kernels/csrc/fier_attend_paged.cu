// K4's fixed instantiations (fier_attend.cuh has the kernel and its design):
// K2's shapes over a block pool walked through a block table.

#include "fier_attend.cuh"

extern "C" int fier_attend_paged_launch(const void* q, const void* K, const void* V,
                                        const void* table, const void* idx, const void* lengths,
                                        void* out, int B, int S, int bs, int Hkv, int rep, int D,
                                        int budget, float scale, int cluster, int chunk, int q_bf16,
                                        void* stream) {
  using Pick = Fixed<kPaged>;
  return attend_launch<Pick>(q, K, V, table, idx, lengths, out, B, S, bs, Hkv, rep, D, budget,
                             scale, cluster, chunk, q_bf16, stream);
}
