// K2/K4/K8's generic layout (fier_attend.cuh has the kernel and its design):
// every d_head that is a multiple of 8 up to 256 at every rep, d_head and rep
// run-time values inside a layout class of 64, 128 or 256 channels, the CTAs
// of a row split over blocks of query heads (pick_any), for K2, K4 and K8;
// the fixed instantiations are fier_attend.cu's, fier_attend_paged.cu's and
// fier_attend_gathered.cu's, and the wrapper sends each shape to one library.

#include "fier_attend.cuh"

namespace {

struct Any {
  template <int kAddr>
  static LaunchFn get(int D, int rep) {
    if (D <= 64) return pick_any<kAddr, 64>(rep);
    if (D <= 128) return pick_any<kAddr, 128>(rep);
    return pick_any<kAddr, 256>(rep);
  }
};

}  // namespace

extern "C" int fier_attend_any_launch(const void* q, const void* K, const void* V,
                                      const void* table, const void* idx, const void* lengths,
                                      void* out, int B, int S, int bs, int Hkv, int rep, int D,
                                      int budget, float scale, int cluster, int chunk, int q_bf16,
                                      void* stream) {
  return attend_launch<Any>(q, K, V, table, idx, lengths, out, B, S, bs, Hkv, rep, D, budget,
                            scale, cluster, chunk, q_bf16, stream);
}

extern "C" int fier_attend_any_gathered_launch(const void* q, const void* k_sel, const void* v_sel,
                                               const void* mask, void* out, int B, int budget,
                                               int Hkv, int rep, int D, long long sb, long long st,
                                               long long sh, float scale, int cluster, int chunk,
                                               int q_bf16, void* stream) {
  return attend_gathered_launch<Any>(q, k_sel, v_sel, mask, out, B, budget, Hkv, rep, D, sb,
                                     st, sh, scale, cluster, chunk, q_bf16, stream);
}
