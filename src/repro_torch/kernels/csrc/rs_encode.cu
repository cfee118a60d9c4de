// Reed-Solomon parity encode over GF(2^8) (polynomial 0x11D), static generator:
// out[j] = XOR_i C[j][i] * in[i], 4 packed field bytes per uint32 word (SWAR).
//
// Replaces the TPU kernel repro/kernels/rs_encode.py::rs_encode_pallas
// (_rs_kernel). The generator is fixed for a program, so the host expands it
// (kernels/rs_encode.py::expand_generator) into the bit-plane body's per-term
// multipliers C[j][i] * alpha^s, and they travel in the kernel's parameter
// space: every multiplier is a constant-bank operand of
// its IMAD at a compile-time offset, and nothing about the coefficients is
// tested inside the loop (gf256.cuh has the body).
//
// Budget per uint32 word of each row at (K=4, M=2), the rs create's shape,
// as tools/sass_mix.py reads the compiled bit-plane loop (the path of a
// whole aligned quad): 81.5 on the ALU pipe (32 plane masks, 12 shifts for
// the even planes, 32 three-input XOR folds, loop work), 80.5 on the FMA pipe
// (64 term multiplies, 16 multiply-highs for the odd planes' shifts), 5.0
// uniform, 1.0 load (a 16-byte load covers 4 words of a row), 0.5 stores.
// At 64 lanes/clk/SM per pipe on 463.4 M words that is 2.26 ms on the ALU
// pipe, 2.23 ms on the FMA pipe, 2.38 ms of dispatch: under the 3.32 ms the
// bytes take, so the kernel is bound by bytes.
#include <cstring>

#include "gf256.cuh"

namespace repro {

template <int K, int M>
struct ParamTerms {
  uint32_t t[M][K][8];
  __device__ __forceinline__ uint4 quad(int j, int i, int h) const {
    return make_uint4(t[j][i][4 * h], t[j][i][4 * h + 1], t[j][i][4 * h + 2], t[j][i][4 * h + 3]);
  }
};

template <int K, int M>
__global__ void __launch_bounds__(kThreads) rs_encode_kernel(Rows rows, ParamTerms<K, M> terms, PlaneShifts sh,
                                                             int64_t nv, int64_t n) {
  gf_run<K, M>(rows, terms, sh, nv, n);
}

template <int K, int M>
struct EncodeLaunch {
  static void run(const Rows& rows, const uint32_t* terms, int64_t nv, int64_t n, cudaStream_t st);
};

#ifdef GF_PART
template <int K, int M>
void EncodeLaunch<K, M>::run(const Rows& rows, const uint32_t* terms, int64_t nv, int64_t n, cudaStream_t st) {
  ParamTerms<K, M> t;
  std::memcpy(t.t, terms, sizeof t.t);
  rs_encode_kernel<K, M><<<gf_grid(n), kThreads, 0, st>>>(rows, t, plane_shifts(), nv, n);
}

template const void* gf_part_instances<EncodeLaunch>();
#endif

}  // namespace repro

#ifndef GF_PART
// terms: host (m, k, 8) uint32 row-major, terms[j][i][s] = C[j][i] * alpha^s.
// Launches one kernel and returns the launch status (-1 for k or m out of
// range).
extern "C" int repro_rs_encode(const uint64_t* in, int k, const uint64_t* out, int m, const uint32_t* terms,
                               int64_t n, uint64_t stream) {
  using namespace repro;
  if (k < 1 || k > kMaxK || m < 1 || m > kMaxM || n < 0) return -1;
  const Rows r = make_rows(in, k, out, m);
  const int64_t nv = vector_words(r, k, m, n);
  gf_launcher<EncodeLaunch>(k, m)(r, terms, nv, n, reinterpret_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
#endif
