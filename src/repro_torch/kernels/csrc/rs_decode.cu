// Erasure decode over GF(2^8) with a runtime coefficient matrix:
// out[j] = XOR_i D[j][i] * in[i], 4 packed field bytes per uint32 word.
//
// Replaces the TPU kernel repro/kernels/rs_decode.py::rs_decode_pallas
// (_rs_decode_kernel). Which ranks died is data, so D (the
// erasure_decode_matrix rows, uint32 in device memory) is read at run time
// and one compiled kernel serves every failure pattern. Each block copies D
// to shared memory once. All 8 xtime steps run for every input word, each
// term masked by one coefficient bit (branch-free, like the TPU kernel).
// Bound: bytes for small m; per input word 7 xtime steps (6 integer ops
// each) plus 2 ops per (output, bit), i.e. about 42 + 16m integer ops per
// 4 bytes read, which stays below the card's integer rate for m <= 4 but
// approaches it for wider decode matrices.
#include "common.cuh"

namespace repro {

// word (or uint4 of words) i of every output; sc the (m, k) matrix in shared memory
template <typename W>
__device__ __forceinline__ void rs_decode_at(const Rows& rows, const uint32_t* sc, int k, int m, int64_t i) {
  W acc[kMaxM];
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) acc[j] = zero_word<W>();
  for (int s = 0; s < k; ++s) {
    W t = load_word<W>(rows.in[s], i);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
      for (int j = 0; j < kMaxM; ++j) {
        if (j < m) {
          const uint32_t sel = 0u - ((sc[j * k + s] >> bit) & 1u);
          acc[j] = acc[j] ^ (t & sel);
        }
      }
      if (bit < 7) t = xtime(t);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxM; ++j)
    if (j < m) store_word<W>(rows.out[j], i, acc[j]);
}

__global__ void __launch_bounds__(kThreads) rs_decode_kernel(Rows rows, const uint32_t* __restrict__ coefs,
                                                             int k, int m, int64_t nv, int64_t n) {
  __shared__ uint32_t sc[kMaxM * kMaxK];
  for (int t = threadIdx.x; t < m * k; t += blockDim.x) sc[t] = coefs[t];
  __syncthreads();
  for (int64_t i = first_index(); i < nv; i += grid_stride()) rs_decode_at<uint4>(rows, sc, k, m, i);
  for (int64_t i = 4 * nv + first_index(); i < n; i += grid_stride()) rs_decode_at<uint32_t>(rows, sc, k, m, i);
}

}  // namespace repro

// coefs: device pointer to an (m, k) uint32 row-major matrix. Launches one
// kernel and returns the launch status.
extern "C" int repro_rs_decode(const uint64_t* in, int k, const uint64_t* out, int m,
                               uint64_t coefs, int64_t n, uint64_t stream) {
  using namespace repro;
  if (k < 1 || k > kMaxK || m < 1 || m > kMaxM || n < 0) return -1;
  const Rows r = make_rows(in, k, out, m);
  const int64_t nv = vector_words(r, k, m, n);
  rs_decode_kernel<<<grid_for_split(nv, n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      r, reinterpret_cast<const uint32_t*>(coefs), k, m, nv, n);
  return static_cast<int>(cudaGetLastError());
}
