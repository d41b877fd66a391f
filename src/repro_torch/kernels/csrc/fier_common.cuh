// Device code shared by the FIER kernels for Hopper (sm_90a):
//   * the warp that scores 32 consecutive tokens from the packed 1-bit
//     side-car (K1/K3 in fier_retrieve.cuh, K6 in fier_score.cu), so the
//     two-pass score scan writes exactly the per-token scores the one-pass
//     retrieval kernel keeps on chip;
//   * the monotone uint32 score keys and the radix-256 threshold search
//     (K1/K3 over a row split across a thread-block cluster, K7 in
//     fier_topk.cu over a score row in device memory), so both find the same
//     tau and m.
// The scoring warp keeps no array in local memory: a chunk is held in
// registers as its raw loads (Chunk: code words and bf16 scale/zero), each
// lane looks its 32 partial sums up in a shared-memory table of its
// channels' sums, and the reduce-scatter is unrolled at compile time.  The
// arithmetic, and the order of every f32 sum, are those of the first K1
// (a select-and-add per token and channel), so scores and selections are
// the same bit for bit.
//
// d_head is a template parameter kD (16, 32, 64, 112 or 128): lane l owns
// lane_channels(kD) consecutive channels (4 at 128 and 112, 2 at 64, 1 at 32
// and 16), so at 128 a byte-row's code bytes of a lane are one uint32 and its
// scale/zero 4 bf16 (a uint2), at 64 a uint16 and 2 bf16 (a uint32), at 32
// one byte and one bf16 (a uint16); the table has 2^lane_channels entries
// (16, 4 or 2).  112/32 is no integer, so d_head 112 (zamba2-7b's shared
// attention block) takes 128's lane layout on 28 lanes: lanes 0-27 own 4
// channels each, and lanes 28-31 load nothing and score with q = 0 and zero
// codes, scales and zeros, so they add exact zeros to the butterfly.  That
// keeps the warp, the table, the butterfly and every load of 128 (a head's
// code bytes start at h*112, its scale/zero at h*224 bytes: the 4- and
// 8-byte lane loads stay aligned), where 32 lanes of 3.5 channels would need
// split loads and a third table size.  d_head 16 (every reduced config) takes
// 32's one-channel layout the same way, on 16 lanes: lanes 16-31 would own
// the next head's channels, so they load nothing and add exact zeros.  At
// 32, 64 and 128 every lane is active and the code is what it was.
//
// Every other d_head D (a multiple of 8 up to 256), and every rep above 16,
// takes the generic layout at the end of this file: a layout class kW (32,
// 64, 128 or 256: the widest d_head it takes) fixes the channels a lane
// owns, lane_channels(kW), and D is a run-time value inside the class.  D
// up to 128 is one part on D / lane_channels(kW) active lanes; D above 128
// is two 128-wide parts (32 lanes, then (D - 128) / 4 lanes) whose lane
// sums are added before the one butterfly, since 8 channels a lane would
// need a 256-entry table.  Because D % 8 == 0, a head's code bytes start at
// h*D (4-byte aligned) and its scale/zero at h*2D bytes (8-byte aligned),
// so every lane load of every class stays aligned.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fier {

constexpr int kRadix = 256;
constexpr int kPasses = 4;       // radix-256 digits of a uint32 key
constexpr unsigned kFull = 0xFFFFFFFFu;

// What a lane of the scoring warp loads per byte-row (Code: the code bytes of
// its lane_channels(kD) channels) and per group (Pair: their bf16 scale or
// zero values).
template <int kD>
struct LaneLoads;
template <>
struct LaneLoads<128> {
  using Code = uint32_t;
  using Pair = uint2;
};
template <>
struct LaneLoads<112> {  // 128's layout, on lanes 0-27
  using Code = uint32_t;
  using Pair = uint2;
};
template <>
struct LaneLoads<64> {
  using Code = uint16_t;
  using Pair = uint32_t;
};
template <>
struct LaneLoads<32> {
  using Code = uint8_t;
  using Pair = uint16_t;  // one bf16
};
template <>
struct LaneLoads<16> {  // 32's layout, on lanes 0-15
  using Code = uint8_t;
  using Pair = uint16_t;
};
template <>
struct LaneLoads<256> : LaneLoads<128> {};  // the generic class of two 128-wide parts

// Channels a lane of the scoring warp owns at d_head D, and the lanes that
// own any (kD / lane_channels: 32, or 28 at d_head 112, 16 at d_head 16).
__host__ __device__ constexpr int lane_channels(int D) {
  return D <= 32 ? 1 : D == 64 ? 2 : 4;
}
__host__ __device__ constexpr int active_lanes(int D) { return D / lane_channels(D); }

// Whether this thread's lane owns channels: a constant true unless d_head
// leaves lanes idle (112, 16), so the other instantiations carry no test.
template <int kD>
__device__ __forceinline__ bool lane_active() {
  return active_lanes(kD) == 32 || (int)(threadIdx.x & 31) < active_lanes(kD);
}

// The query heads per kv head (kMaxRep) of the K1/K6 instantiation that
// takes d_head D and rep query heads: 8 at d_head 128 up to rep 8 (the
// instantiation that served before reps 12 and 16 came, its shared memory
// unchanged), else 16 (fused_retrieval.smem_static counts the same).
__host__ __device__ constexpr int rep_slots(int D, int rep) {
  return D == 128 && rep <= 8 ? 8 : 16;
}
constexpr int kMaxRepAll = 16;

// Whether (D, rep) runs on a fixed instantiation above (the shapes served
// before the generic layout came; each keeps its code and bits), and
// otherwise the generic layout class that takes D.
__host__ __device__ constexpr bool fixed_shape(int D, int rep) {
  return (D == 16 || D == 32 || D == 64 || D == 112 || D == 128) && rep >= 1 && rep <= kMaxRepAll;
}
__host__ __device__ constexpr int any_class(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}
// Query-head floats the generic scoring kernels stage in shared memory at
// once: blocks of kAnyQFloats / D heads (16 at d_head 256, 32 at 128), each
// folded into the group reduction in head order, so the f32 sums run in the
// order an unblocked loop would take.
constexpr int kAnyQFloats = 4096;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The lane_channels(kD) bf16 values of a lane's Pair, in channel order.
__device__ __forceinline__ void unpack_bf16(const uint2& p, float (&v)[4]) {
  v[0] = bf16_bits_to_float(p.x & 0xFFFFu);
  v[1] = bf16_bits_to_float(p.x >> 16);
  v[2] = bf16_bits_to_float(p.y & 0xFFFFu);
  v[3] = bf16_bits_to_float(p.y >> 16);
}
__device__ __forceinline__ void unpack_bf16(uint32_t p, float (&v)[2]) {
  v[0] = bf16_bits_to_float(p & 0xFFFFu);
  v[1] = bf16_bits_to_float(p >> 16);
}
__device__ __forceinline__ void unpack_bf16(uint16_t p, float (&v)[1]) {
  v[0] = bf16_bits_to_float(p);
}

__device__ __forceinline__ uint32_t sortable_key(float s) {
  uint32_t u = (s == 0.0f) ? 0u : __float_as_uint(s);  // -0.0 -> +0.0
  return (u >> 31) == 0 ? (u | 0x80000000u) : ~u;
}

__device__ __forceinline__ float unsortable(uint32_t key) {
  uint32_t u = (key >> 31) == 1 ? (key ^ 0x80000000u) : ~key;
  return __uint_as_float(u);
}

// One 32-token chunk (4 byte-rows) as lane l loaded it: the code bytes of
// its lane_channels(kD) channels per byte-row (one word each) and the bf16
// scale and zero of the groups (lane_channels(kD) bf16 values per Pair).
// kGroups = 1 when the group spans the whole chunk (group % 32 == 0), else 4:
// one entry per byte-row.
template <int kGroups, int kD>
struct Chunk {
  using Pair = typename LaneLoads<kD>::Pair;
  uint32_t word[4];
  Pair sc[kGroups], zr[kGroups];
};

// Load chunk c.  codes_h/scale_h/zero_h point at this lane's channels of the
// (batch, kv-head) row; code_row(i) / group_row(t) give the seq row (in
// units of row_stride elements) of byte-row i and of the group holding token
// t: the address policy (slab or paged) is the caller's.  Byte-rows past S8,
// and every byte-row of an idle lane (`on` false), load as zeros.
template <int kGroups, int kD, class CodeRow, class GroupRow>
__device__ __forceinline__ void load_chunk(Chunk<kGroups, kD>& ch, int c, int S8,
                                           const uint8_t* codes_h,
                                           const __nv_bfloat16* scale_h,
                                           const __nv_bfloat16* zero_h, size_t row_stride,
                                           CodeRow code_row, GroupRow group_row,
                                           bool on = lane_active<kD>()) {
  using Code = typename LaneLoads<kD>::Code;
  using Pair = typename LaneLoads<kD>::Pair;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = c * 4 + j;  // byte-row: tokens 8i .. 8i+7
    if (on && i < S8) {
      ch.word[j] = *reinterpret_cast<const Code*>(codes_h + code_row(i) * row_stride);
      if (j < kGroups) {
        const size_t gr = group_row(i * 8) * row_stride;
        ch.sc[j] = *reinterpret_cast<const Pair*>(scale_h + gr);
        ch.zr[j] = *reinterpret_cast<const Pair*>(zero_h + gr);
      }
    } else {
      ch.word[j] = 0;
      if (j < kGroups) ch.sc[j] = ch.zr[j] = Pair{};
    }
  }
}

// One step of the butterfly: lanes that differ in bit O trade halves.
template <int O>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// The same step when every lane keeps entries [0, O) and sends [O, 2O): the
// entries of a lane whose bit O is set were stored swapped in advance.
template <int O>
__device__ __forceinline__ void reduce_step_swapped(float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < O; ++i) v[i] = v[i] + __shfl_xor_sync(kFull, v[i + O], O);
}

// The lane_channels(kD) (channel) x 8 (token) code bits of one byte-row word
// -> the channel index of token b: bit k of the result is bit b of byte k (bytes
// past the lane's lane_channels are zero, so at kD = 64 the result is below 4,
// at 32 and 16 below 2).
__device__ __forceinline__ uint32_t token_nibble(uint32_t word, int b) {
  const uint32_t x = (word >> b) & 0x01010101u;  // bit b of each byte at 8k
  return (x * 0x10204080u) >> 28;                // bit 8k -> bit 28 + k, no carries
}

// Scratch a warp's score_chunk needs in shared memory: 2^lane_channels sums per lane.
template <int kD>
__host__ __device__ constexpr int table_floats() { return (1 << lane_channels(kD)) * 32; }

// The f32 score q_r . a of token 32c + lane for one query head q_r [kD] (f32
// holding bf16 values), a = bf16(+-s + z) as score_block forms it.  Lane l
// owns channels kDPL l .. kDPL l + kDPL - 1 (kDPL = lane_channels(kD): 4 at
// 128 and 112, 2 at 64, 1 at 32 and 16; an idle lane at 112 or 16 takes q = 0
// and its zero loads, so each of its sums is +0) and, for each of the 32
// tokens, sums their exact products (bf16 x
// bf16 in f32) in channel order starting from 0: (((0 + c0) + c1) + c2) + c3
// at 128 with c_k = q_k * (bit ? hi_k : lo_k).  The sum depends on the token
// only through its kDPL code bits, so the lane forms the 2^kDPL possible
// sums once per group (`tab`, this warp's table_floats<kD>() of shared
// memory, laid out [index][lane]) and looks each token's up.  A butterfly
// reduce-scatter then leaves lane l with token l's sum; lanes whose bit 4
// or 3 is set hold their byte-rows in swapped order, so the first two steps
// need no select.  The arithmetic, and the order of every f32 sum, are those
// of the plain select-and-add loop over channels the first K1 ran.
// The lookups of one chunk into acc[32] (entry block jj holds byte-row
// jj ^ ((lane >> 3) & 3)), the lane's channel sums built in `tl` (its
// column of the warp's table) once per group; kAdd adds them to acc (a
// second 128-wide part of the generic layout).
template <bool kAdd, int kGroups, int kD>
__device__ __forceinline__ void chunk_lookups(const Chunk<kGroups, kD>& ch,
                                              const float (&qv)[lane_channels(kD)], int lane,
                                              float* tl, float (&acc)[32]) {
  constexpr int kDPL = lane_channels(kD);  // channels per lane
  constexpr int kEntries = 1 << kDPL;
  const int sw = (lane >> 3) & 3;  // entry block jj holds byte-row jj ^ sw
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = jj ^ sw;
    if (jj < kGroups) {  // the sums of byte-row j's group
      auto s = ch.sc[0], z = ch.zr[0];
      if (kGroups > 1) {
#pragma unroll
        for (int g = 1; g < kGroups; ++g)
          if (j == g) s = ch.sc[g], z = ch.zr[g];
      }
      float sc[kDPL], zr[kDPL];
      unpack_bf16(s, sc);
      unpack_bf16(z, zr);
      float t[kEntries];
#pragma unroll
      for (int k = 0; k < kDPL; ++k) {
        const float ph = qv[k] * round_bf16(zr[k] + sc[k]);  // bf16(+1 * s + z): exact product
        const float pl = qv[k] * round_bf16(zr[k] - sc[k]);  // bf16(-1 * s + z)
        if (k == 0) {
          t[0] = 0.0f + pl;
          t[1] = 0.0f + ph;
        } else {
#pragma unroll
          for (int n = 0; n < kEntries / 2; ++n) {
            if (n < (1 << k)) {
              t[n | (1 << k)] = t[n] + ph;
              t[n] = t[n] + pl;
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kEntries; ++n) tl[n * 32] = t[n];
    }
    uint32_t w = ch.word[0];
#pragma unroll
    for (int g = 1; g < 4; ++g)
      if (j == g) w = ch.word[g];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float v = tl[token_nibble(w, b) * 32];
      acc[8 * jj + b] = kAdd ? acc[8 * jj + b] + v : v;
    }
  }
}

// The butterfly reduce-scatter of the 32 lanes' lookups: lane l ends with
// token l's sum in acc[0] (lanes whose bit 4 or 3 is set hold their
// byte-rows in swapped order, so the first two steps need no select).
__device__ __forceinline__ float reduce_scatter(float (&acc)[32], int lane) {
  reduce_step_swapped<16>(acc);
  reduce_step_swapped<8>(acc);
  reduce_step<4>(acc, lane);
  reduce_step<2>(acc, lane);
  reduce_step<1>(acc, lane);
  return acc[0];
}

// The f32 score q_r . a of token 32c + lane for one query head q_r [kD] (f32
// holding bf16 values), a = bf16(+-s + z) as score_block forms it.  Lane l
// owns channels kDPL l .. kDPL l + kDPL - 1 (kDPL = lane_channels(kD): 4 at
// 128 and 112, 2 at 64, 1 at 32 and 16; an idle lane at 112 or 16 takes q = 0
// and its zero loads, so each of its sums is +0) and, for each of the 32
// tokens, sums their exact products (bf16 x
// bf16 in f32) in channel order starting from 0: (((0 + c0) + c1) + c2) + c3
// at 128 with c_k = q_k * (bit ? hi_k : lo_k).  The sum depends on the token
// only through its kDPL code bits, so the lane forms the 2^kDPL possible
// sums once per group (`tab`, this warp's table_floats<kD>() of shared
// memory, laid out [index][lane]) and looks each token's up
// (chunk_lookups); reduce_scatter then leaves lane l with token l's sum.
// The arithmetic, and the order of every f32 sum, are those of the plain
// select-and-add loop over channels the first K1 ran.
template <int kGroups, int kD>
__device__ __forceinline__ float score_chunk(const Chunk<kGroups, kD>& ch, const float* q_r,
                                             int lane, float* tab) {
  constexpr int kDPL = lane_channels(kD);  // channels per lane
  const bool on = lane_active<kD>();
  float qv[kDPL];
#pragma unroll
  for (int k = 0; k < kDPL; ++k) qv[k] = on ? q_r[lane * kDPL + k] : 0.0f;
  float acc[32];
  chunk_lookups<false>(ch, qv, lane, tab + lane, acc);
  return reduce_scatter(acc, lane);
}

// ---- the generic layout (d_head D at run time inside the class kW) -------

// 128-wide parts of a head in class kW, and the lanes of part p that own
// channels at d_head D.
__host__ __device__ constexpr int any_parts(int kW) { return kW > 128 ? 2 : 1; }
__device__ __forceinline__ bool any_lane_on(int kW, int D, int p, int lane) {
  return lane * lane_channels(kW) < D - 128 * p;
}

// A chunk of the generic layout: one Chunk per 128-wide part.
template <int kGroups, int kW>
struct AnyChunk {
  Chunk<kGroups, kW> part[any_parts(kW)];
};

// load_chunk for each part: part p of this lane sits 128 p channels past
// codes_h/scale_h/zero_h (the lane's channels of part 0); an idle lane's
// loads are zeros.
template <int kGroups, int kW, class CodeRow, class GroupRow>
__device__ __forceinline__ void load_chunk_any(AnyChunk<kGroups, kW>& ch, int D, int c, int S8,
                                               const uint8_t* codes_h,
                                               const __nv_bfloat16* scale_h,
                                               const __nv_bfloat16* zero_h, size_t row_stride,
                                               CodeRow code_row, GroupRow group_row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < any_parts(kW); ++p)
    load_chunk(ch.part[p], c, S8, codes_h + 128 * p, scale_h + 128 * p, zero_h + 128 * p,
               row_stride, code_row, group_row, any_lane_on(kW, D, p, lane));
}

// score_chunk at a run-time d_head D of class kW: each part's lookups (an
// idle lane adds exact zeros) added in part order, then the butterfly.
// Within a part each lookup is score_chunk's channel-order sum; the parts'
// and the lanes' sums run in another order than the plain version's,
// inside score_eps's bound.
template <int kGroups, int kW>
__device__ __forceinline__ float score_chunk_any(const AnyChunk<kGroups, kW>& ch, const float* q_r,
                                                 int D, int lane, float* tab) {
  constexpr int kDPL = lane_channels(kW);
  float acc[32];
#pragma unroll
  for (int p = 0; p < any_parts(kW); ++p) {
    const bool on = any_lane_on(kW, D, p, lane);
    float qv[kDPL];
#pragma unroll
    for (int k = 0; k < kDPL; ++k) qv[k] = on ? q_r[128 * p + lane * kDPL + k] : 0.0f;
    if (p == 0)
      chunk_lookups<false>(ch.part[p], qv, lane, tab + lane, acc);
    else
      chunk_lookups<true>(ch.part[p], qv, lane, tab + lane, acc);
  }
  return reduce_scatter(acc, lane);
}

// Add the keys of one warp (one per lane, `in` false: not a key) to the
// histogram h of digit (key >> shift) & 0xFF over the keys whose digits
// above it equal prefix's (himask).  Pass 0 (shift 24), where most of a
// warp's keys share a digit, takes one atomic per distinct digit
// (__match_any_sync); later passes, whose few keys spread over many
// digits, one atomic per key.
__device__ __forceinline__ void count_digit(int* h, uint32_t key, bool in, uint32_t himask,
                                            uint32_t prefix, int shift, int lane) {
  const int digit = (in && (key & himask) == prefix) ? (int)((key >> shift) & 0xFF) : kRadix;
  if (shift == 24) {
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit < kRadix && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
  } else if (digit < kRadix) {
    atomicAdd(&h[digit], 1);
  }
}

// tau (as a key) and m = |{ key > tau }| of the budget-th largest of the
// keys key_at(0 .. n-1) and of those of the blocks that share the search,
// by 4 radix-256 passes with warp-aggregated shared-memory histograms
// (__match_any_sync).  Every thread of the kThreads-thread block calls it.
// Pass p counts into hist + p * kRadix (shared, [kPasses][kRadix], zeroed by
// the caller before a __syncthreads, never rewritten after the pass; with
// first_counted the caller has already counted pass 0 there), then
// total(p, hist_p) returns the histogram of the whole row (shared memory
// every thread can read, valid after a __syncthreads): the pass's own for
// one block, the sum over a cluster's blocks for a split row.  sel [2] is
// shared scratch.
template <int kThreads, class KeyAt, class Total>
__device__ __forceinline__ void radix_select(KeyAt key_at, int n, int budget, int* hist, int* sel,
                                             Total total, bool first_counted, uint32_t& tau_key,
                                             int& m) {
  constexpr int kUnroll = 4;  // independent keys in flight per thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t prefix = 0;
  int remaining = budget;
  int greater = 0;
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 24 - 8 * p;
    const uint32_t himask = p == 0 ? 0u : (0xFFFFFFFFu << (32 - 8 * p));
    int* h = hist + p * kRadix;
    if (p > 0 || !first_counted) {
      for (int base = 0; base < n; base += kThreads * kUnroll) {
        uint32_t key[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = base + u * kThreads + tid;
          key[u] = pos < n ? key_at(pos) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          count_digit(h, key[u], base + u * kThreads + tid < n, himask, prefix, shift, lane);
      }
      __syncthreads();
    }
    const int* t = total(p, h);
    if (warp == 0) {
      // lane owns buckets 8*lane .. 8*lane+7; ge[j] = count(digit >= j)
      int v[8];
      int tot = 0;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        tot += t[lane * 8 + k];
        v[k] = tot;
      }
      int incl = tot;  // sum over lanes >= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int nb = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += nb;
      }
      const int excl = incl - tot;  // buckets above this lane's
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ge = v[k] + excl;
        const int ge_next = (k < 7 ? v[k + 1] : 0) + excl;
        if (ge >= remaining && ge_next < remaining) {
          sel[0] = lane * 8 + k;  // tau's digit: highest bucket reaching `remaining`
          sel[1] = ge_next;       // participating keys strictly above it
        }
      }
    }
    // sel is rewritten only after the next pass's histogram barrier, which
    // every thread reaches after reading it here
    __syncthreads();
    const int jstar = sel[0];
    const int above = sel[1];
    prefix |= (uint32_t)jstar << shift;
    remaining -= above;
    greater += above;
  }
  tau_key = prefix;
  m = greater;
}

}  // namespace fier
