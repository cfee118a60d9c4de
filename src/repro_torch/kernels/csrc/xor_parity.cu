// XOR parity: out = in[0] ^ in[1] ^ ... ^ in[k-1] over n uint32 words.
//
// Replaces the TPU kernel repro/kernels/xor_parity.py::xor_reduce_pallas
// (_xor_kernel). Bound by bytes: k reads and one write per word, no
// arithmetic worth counting. The design streams each row once with 16-byte
// loads, k rows per thread in flight, and reads the rows in place (the
// parity group's members are views into the fused bucket, not a stacked
// copy).
#include "common.cuh"

namespace repro {

// word (or uint4 of words) i of the output
template <typename W>
__device__ __forceinline__ void xor_at(const Rows& rows, int k, int64_t i) {
  W acc = load_word<W>(rows.in[0], i);
  for (int s = 1; s < k; ++s) acc = acc ^ load_word<W>(rows.in[s], i);
  store_word<W>(rows.out[0], i, acc);
}

__global__ void __launch_bounds__(kThreads) xor_kernel(Rows rows, int k, int64_t nv, int64_t n) {
  for (int64_t i = first_index(); i < nv; i += grid_stride()) xor_at<uint4>(rows, k, i);
  for (int64_t i = 4 * nv + first_index(); i < n; i += grid_stride()) xor_at<uint32_t>(rows, k, i);
}

}  // namespace repro

// Launches one kernel and returns the launch status: a refused launch never
// runs and a later synchronize would not report it.
extern "C" int repro_xor_reduce(const uint64_t* in, int k, uint64_t out, int64_t n, uint64_t stream) {
  using namespace repro;
  if (k < 1 || k > kMaxK || n < 0) return -1;
  const uint64_t outs[1] = {out};
  const Rows r = make_rows(in, k, outs, 1);
  const int64_t nv = vector_words(r, k, 1, n);
  xor_kernel<<<grid_for_split(nv, n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(r, k, nv, n);
  return static_cast<int>(cudaGetLastError());
}
