// The GF(2^8) matrix product shared by the Reed-Solomon encode (rs_encode.cu)
// and the erasure decode (rs_decode.cu): out[j] = XOR_i C[j][i] * in[i] over
// GF(2^8) (polynomial 0x11D), 4 packed field bytes per uint32 word (SWAR).
//
// Bit-plane formulation. For any coefficient c and field byte x,
//   c * x = XOR_s bit_s(x) * (c * alpha^s),   s = 0..7,
// so with plane_s(x) = (x >> s) & 0x01010101 (one 0/1 byte per field byte)
// each term is one integer multiply of the plane by the byte c * alpha^s:
// a 0/1 byte times a byte has no carries. The per-term multipliers
// ("terms", (M, K, 8) uint32) are resolved before the grid-stride loop: by
// the host for the encode's static generator (they travel in the parameter
// space), by each block in shared memory for the decode's runtime matrix.
// A matrix of 0s and 1s (the xor decode) takes the same body: at (K=4, M=1)
// it issues 64.25 ALU and 48.25 FMA instructions per word, 1.78 ms on the
// ALU pipe against the 2.77 ms its bytes take, so it too is bound by bytes
// (a separate XOR-only body timed the same, tools/gf_ab.py).
//
// The body is templated on K (inputs, 1..16) and M (outputs, 1..8): every
// loop over inputs, planes and outputs unrolls at compile time, and the
// grid-stride loop holds no coefficient test and no output predicate. One
// C entry point per kernel dispatches (k, m) to its instantiation.
#pragma once

#include <array>
#include <utility>

#include "common.cuh"

namespace repro {

constexpr uint32_t kPlaneMask = 0x01010101u;  // bit 0 of each packed byte

// c * alpha^s in GF(2^8) (0x11D), on one byte: s xtime steps
__host__ __device__ __forceinline__ uint32_t gf_mul_alpha_pow(uint32_t c, int s) {
  for (int r = 0; r < s; ++r) c = ((c << 1) ^ ((c >> 7) * 0x11Du)) & 0xFFu;
  return c;
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int s) {
  return (s & 3) == 0 ? v.x : (s & 3) == 1 ? v.y : (s & 3) == 2 ? v.z : v.w;
}

// 2^(32 - s) for each plane s, passed as a kernel argument: the odd planes'
// shifts run as multiply-highs on the FMA pipe, the even ones as shifts on
// the ALU pipe, which balances the two (the compiler would turn a
// multiply-high by a constant power of two back into a shift).
struct PlaneShifts {
  uint32_t hi[8];
};

inline PlaneShifts plane_shifts() {
  PlaneShifts p{};
  for (int s = 1; s < 8; ++s) p.hi[s] = 1u << (32 - s);
  return p;
}

// plane s of 4 packed field bytes: (x >> s) & 0x01010101
__device__ __forceinline__ uint32_t plane(uint32_t x, int s, const PlaneShifts& sh) {
  return ((s & 1) ? __umulhi(x, sh.hi[s]) : x >> s) & kPlaneMask;
}

// Words 4q..4q+3 of every row: load the K inputs, form the M outputs, store
// them. 16-byte loads and stores when the rows are aligned and the quad is
// whole (q < nv); else plain words, masked at the row's end (the ragged
// tail, or whole rows that are not 16-byte aligned). One copy of the body
// serves both, which keeps the 128 instantiations' build short.
// Terms::quad(j, i, h) holds the multipliers of planes 4h..4h+3 of input i in
// output j (compile-time indices after unrolling).
template <int K, int M, class Terms>
__device__ __forceinline__ void gf_quad(const Rows& rows, const Terms& terms, const PlaneShifts& sh, int64_t q,
                                        int64_t nv, int64_t n) {
  constexpr int NW = 4;
  const bool vec = q < nv;
  uint32_t x[K][NW];
  if (vec) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint4 v = load_word<uint4>(rows.in[i], q);
      x[i][0] = v.x, x[i][1] = v.y, x[i][2] = v.z, x[i][3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int w = 0; w < NW; ++w) x[i][w] = 4 * q + w < n ? load_word<uint32_t>(rows.in[i], 4 * q + w) : 0u;
  }
  uint32_t acc[M][NW];
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[j][w] = 0u;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 q[M];
#pragma unroll
      for (int j = 0; j < M; ++j) q[j] = terms.quad(j, i, h);
#pragma unroll
      for (int s = 4 * h; s < 4 * h + 4; ++s) {
        uint32_t p[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) p[w] = plane(x[i][w], s, sh);
#pragma unroll
        for (int j = 0; j < M; ++j)
#pragma unroll
          for (int w = 0; w < NW; ++w) acc[j][w] ^= p[w] * lane(q[j], s);
      }
    }
  if (vec) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      store_word<uint4>(rows.out[j], q, make_uint4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int w = 0; w < NW; ++w)
        if (4 * q + w < n) store_word<uint32_t>(rows.out[j], 4 * q + w, acc[j][w]);
  }
}

// every quad of words in one grid-stride loop, [0, nv) as 16-byte vectors
template <int K, int M, class Terms>
__device__ __forceinline__ void gf_run(const Rows& rows, const Terms& terms, const PlaneShifts& sh, int64_t nv,
                                       int64_t n) {
  const int64_t quads = (n + 3) / 4;
  for (int64_t q = first_index(); q < quads; q += grid_stride()) gf_quad<K, M>(rows, terms, sh, q, nv, n);
}

// blocks for n words: one thread per quad, at most kMaxBlocks
inline int gf_grid(int64_t n) { return grid_for((n + 3) / 4); }

// The 128 instantiations of a library compile in GF_PARTS objects at once
// (kernels/_build.py passes -DGF_PARTS=n and -DGF_PART=p): the object built
// with GF_PART=p holds the Launch<K, M>::run (and so the kernels) of every K
// in part p, the one built without GF_PART the C entry point and its
// dispatch table, which names every Launch<K, M>::run without instantiating
// it (each source defines run only under GF_PART).
template <template <int, int> class Launch>
using GfRun = decltype(&Launch<1, 1>::run);

// Launch<K, M>::run for every (K, M) in 1..kMaxK x 1..kMaxM, indexed
// (K - 1) * kMaxM + (M - 1)
template <template <int, int> class Launch, int... I>
constexpr auto gf_table(std::integer_sequence<int, I...>) {
  return std::array<GfRun<Launch>, sizeof...(I)>{&Launch<I / kMaxM + 1, I % kMaxM + 1>::run...};
}

template <template <int, int> class Launch>
inline GfRun<Launch> gf_launcher(int k, int m) {
  static constexpr auto table = gf_table<Launch>(std::make_integer_sequence<int, kMaxK * kMaxM>{});
  return table[(k - 1) * kMaxM + (m - 1)];
}

#ifdef GF_PART
#ifndef GF_PARTS
#error "a part of a GF(2^8) library needs -DGF_PARTS=<number of parts>"
#endif
static_assert(0 <= GF_PART && GF_PART < GF_PARTS, "GF_PART out of range");

// the part of K: K and 17 - K pair up (equal sums), pairs spread over the
// parts, so every part compiles the same share of the work
constexpr int gf_part_of(int k) { return (k - 1 < kMaxK - k ? k - 1 : kMaxK - k) % GF_PARTS; }

template <template <int, int> class Launch, int I>
constexpr GfRun<Launch> gf_part_entry() {
  if constexpr (gf_part_of(I / kMaxM + 1) == GF_PART)
    return &Launch<I / kMaxM + 1, I % kMaxM + 1>::run;
  else
    return nullptr;
}

template <template <int, int> class Launch, int... I>
constexpr auto gf_part_table(std::integer_sequence<int, I...>) {
  return std::array<GfRun<Launch>, sizeof...(I)>{gf_part_entry<Launch, I>()...};
}

// Names this part's Launch<K, M>::run, which instantiates them here; each
// source explicitly instantiates it for its Launch.
template <template <int, int> class Launch>
const void* gf_part_instances() {
  static constexpr auto table = gf_part_table<Launch>(std::make_integer_sequence<int, kMaxK * kMaxM>{});
  return table.data();
}
#endif

}  // namespace repro
