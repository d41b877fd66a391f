// K1/K3's generic layout (fier_retrieve.cuh has the kernel and its design):
// every d_head that is a multiple of 8 up to 256 at every rep, d_head a
// run-time value inside its layout class (fier_common.cuh: any_class), the
// query heads staged in blocks, slab and pool; the fixed instantiations
// are fier_retrieve.cu's and fier_retrieve_paged.cu's, and the wrapper
// sends each shape to one library.

#include "fier_retrieve.cuh"

namespace {

struct Any {
  template <bool kPaged>
  static LaunchFn get(bool smem_keys, bool one, int D, int) {
    switch (fier::any_class(D)) {
      case 32: return pick<kPaged, 32, 0>(smem_keys, one);
      case 64: return pick<kPaged, 64, 0>(smem_keys, one);
      case 128: return pick<kPaged, 128, 0>(smem_keys, one);
      default: return pick<kPaged, 256, 0>(smem_keys, one);
    }
  }
};

}  // namespace

extern "C" int fier_retrieve_any_launch(const void* q, const void* codes, const void* scale,
                                        const void* zero, const void* table, const void* lengths,
                                        void* idx, void* tau, void* m, int B, int S, int bs,
                                        int Hkv, int rep, int D, int group, int budget,
                                        int reduce_sum, int sink, int recent, int cluster,
                                        int cta_tokens, void* keys, void* stream) {
  return retrieve_launch<Any>(q, codes, scale, zero, table, lengths, idx, tau, m, B, S, bs,
                             Hkv, rep, D, group, budget, reduce_sum, sink, recent, cluster,
                             cta_tokens, keys, stream);
}
