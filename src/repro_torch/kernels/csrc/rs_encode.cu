// Reed-Solomon parity encode over GF(2^8) (polynomial 0x11D), static generator:
// out[j] = XOR_i C[j][i] * in[i], 4 packed field bytes per uint32 word (SWAR).
//
// Replaces the TPU kernel repro/kernels/rs_encode.py::rs_encode_pallas
// (_rs_kernel). The generator is fixed for a program, so it travels as a
// kernel argument (parameter space, uniform across the warp: no divergence).
// Multiplication by a constant is the xtime chain over its set bits. One
// chain per input row serves all m outputs: each xtime power of in[i] is
// XORed into every output whose coefficient has that bit, and the chain
// stops after the highest bit any coefficient of the column uses.
// Bound: bytes for small m (k reads + m writes per word); at most 8 xtime
// steps of 6 integer ops each per input word plus one XOR per set
// coefficient bit, which stays below the card's integer rate for m <= 8.
#include "common.cuh"

namespace repro {

struct Coefs {
  uint8_t c[kMaxM][kMaxK];
  uint8_t column_or[kMaxK];  // OR of column i's coefficients: where its chain may stop
};

// word (or uint4 of words) i of every output
template <typename W>
__device__ __forceinline__ void rs_encode_at(const Rows& rows, const Coefs& coefs, int k, int m, int64_t i) {
  W acc[kMaxM];
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) acc[j] = zero_word<W>();
  for (int s = 0; s < k; ++s) {
    const uint32_t any = coefs.column_or[s];
    if (any == 0) continue;
    W t = load_word<W>(rows.in[s], i);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
      for (int j = 0; j < kMaxM; ++j)
        if (j < m && ((coefs.c[j][s] >> bit) & 1u)) acc[j] = acc[j] ^ t;
      if ((any >> (bit + 1)) == 0) break;
      t = xtime(t);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxM; ++j)
    if (j < m) store_word<W>(rows.out[j], i, acc[j]);
}

__global__ void __launch_bounds__(kThreads) rs_encode_kernel(Rows rows, Coefs coefs, int k, int m, int64_t nv,
                                                             int64_t n) {
  for (int64_t i = first_index(); i < nv; i += grid_stride()) rs_encode_at<uint4>(rows, coefs, k, m, i);
  for (int64_t i = 4 * nv + first_index(); i < n; i += grid_stride()) rs_encode_at<uint32_t>(rows, coefs, k, m, i);
}

}  // namespace repro

// coefs: host (m, k) uint8 row-major. Launches one kernel and returns the
// launch status.
extern "C" int repro_rs_encode(const uint64_t* in, int k, const uint64_t* out, int m,
                               const uint8_t* coefs, int64_t n, uint64_t stream) {
  using namespace repro;
  if (k < 1 || k > kMaxK || m < 1 || m > kMaxM || n < 0) return -1;
  Coefs c{};
  for (int j = 0; j < m; ++j)
    for (int s = 0; s < k; ++s) {
      c.c[j][s] = coefs[j * k + s];
      c.column_or[s] |= coefs[j * k + s];
    }
  const Rows r = make_rows(in, k, out, m);
  const int64_t nv = vector_words(r, k, m, n);
  rs_encode_kernel<<<grid_for_split(nv, n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(r, c, k, m, nv, n);
  return static_cast<int>(cudaGetLastError());
}
