// Erasure decode over GF(2^8) with a runtime coefficient matrix:
// out[j] = XOR_i D[j][i] * in[i], 4 packed field bytes per uint32 word.
//
// Replaces the TPU kernel repro/kernels/rs_decode.py::rs_decode_pallas
// (_rs_decode_kernel). Which ranks died is data, so D (the
// erasure_decode_matrix rows, an (m, k) uint32 tensor on the card) is read at
// run time with no host sync, and one compiled kernel per (k, m) serves every
// failure pattern. Each block expands D once into the bit-plane body's
// per-term multipliers D[j][i] * alpha^s in shared memory (its threads one
// multiplier each) before one barrier, and the loop reads the multipliers
// with 16-byte broadcast loads (gf256.cuh has the body).
//
// Budget per uint32 word of each row at (K=4, M=2), the rs restore's shape,
// as tools/sass_mix.py reads the compiled bit-plane loop (the path of a
// whole aligned quad): 80.75 on the ALU pipe, 80.75 on the FMA pipe (the
// same body as the encode), 5.25 loads (1.0 global, 16-byte; 4 shared, the
// 16-byte broadcasts of the multipliers), 0.5 stores. 2.24 ms on each pipe
// on 463.4 M words, under the 3.32 ms the bytes take: bound by bytes. The
// xor restore's shape (K=4, M=1, all ones) takes the same loop: 64.25 ALU,
// 48.25 FMA, 3.0 loads per word, 1.78 ms on the ALU pipe against the
// 2.77 ms its bytes take.
#include "gf256.cuh"

namespace repro {

template <int K, int M>
struct SharedTerms {
  uint32_t base;  // shared-space address of the (M, K, 8) uint32 multipliers
  // one 16-byte broadcast load per use: volatile, so the compiler keeps it
  // in the loop rather than holding all M*K*8 multipliers in registers; the
  // "memory" clobber orders it after the barrier that publishes them
  __device__ __forceinline__ uint4 quad(int j, int i, int h) const {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(base + 16u * static_cast<uint32_t>((j * K + i) * 2 + h))
                 : "memory");
    return v;
  }
};

template <int K, int M>
__global__ void __launch_bounds__(kThreads) rs_decode_kernel(Rows rows, const uint32_t* __restrict__ coefs,
                                                             PlaneShifts sh, int64_t nv, int64_t n) {
  __shared__ uint4 terms[M * K * 2];
  uint32_t* t = reinterpret_cast<uint32_t*>(terms);
  for (int e = threadIdx.x; e < M * K * 8; e += blockDim.x)
    // field element: the low byte, as the plain version reads it
    t[e] = gf_mul_alpha_pow(coefs[e >> 3] & 0xFFu, e & 7);
  __syncthreads();
  gf_run<K, M>(rows, SharedTerms<K, M>{static_cast<uint32_t>(__cvta_generic_to_shared(terms))}, sh, nv, n);
}

template <int K, int M>
struct DecodeLaunch {
  static void run(const Rows& rows, const uint32_t* coefs, int64_t nv, int64_t n, cudaStream_t st);
};

#ifdef GF_PART
template <int K, int M>
void DecodeLaunch<K, M>::run(const Rows& rows, const uint32_t* coefs, int64_t nv, int64_t n, cudaStream_t st) {
  rs_decode_kernel<K, M><<<gf_grid(n), kThreads, 0, st>>>(rows, coefs, plane_shifts(), nv, n);
}

template const void* gf_part_instances<DecodeLaunch>();
#endif

}  // namespace repro

#ifndef GF_PART
// coefs: device pointer to an (m, k) uint32 row-major matrix. Launches one
// kernel and returns the launch status (-1 for k or m out of range).
extern "C" int repro_rs_decode(const uint64_t* in, int k, const uint64_t* out, int m,
                               uint64_t coefs, int64_t n, uint64_t stream) {
  using namespace repro;
  if (k < 1 || k > kMaxK || m < 1 || m > kMaxM || n < 0) return -1;
  const Rows r = make_rows(in, k, out, m);
  const int64_t nv = vector_words(r, k, m, n);
  gf_launcher<DecodeLaunch>(k, m)(r, reinterpret_cast<const uint32_t*>(coefs), nv, n,
                                  reinterpret_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
#endif
