// Fletcher dual checksum of each row of a (rows, n) uint32 buffer:
// s1 = sum x_i, s2 = sum (i+1) * x_i, both mod 2^32, i the word index in the row.
//
// Replaces the TPU kernel repro/kernels/checksum.py::checksum_pallas
// (_checksum_kernel). On the TPU the grid runs in order and per-tile partials
// are summed after the call; here blocks run in parallel and in no order, so
// each block reduces its span (warp shuffles, then shared memory) and adds its
// partial to the row's two output words with one atomicAdd each. Unsigned
// addition mod 2^32 is associative and commutative, so the result is exact
// and the same on every run. Batched over rows (the virtual mesh's
// coordinates of a fused bucket): blockIdx.y is the row. The word index is
// 64-bit while walking the row and cut to uint32 for the weight, as in
// np_checksum. Bound: bytes (one read per word; 3 integer ops per word).
#include "common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Vector part: words [0, 4*nv) of each row as uint4; the plain-word tail
// [4*nv, n) is read by the first block of each row.
__global__ void __launch_bounds__(kThreads) checksum_kernel(const uint32_t* __restrict__ x, int64_t nv,
                                                           int64_t n, int64_t row_stride, uint32_t* out) {
  const uint32_t* row = x + static_cast<int64_t>(blockIdx.y) * row_stride;
  uint32_t s1 = 0u, s2 = 0u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < nv; v += stride) {
    const uint4 q = reinterpret_cast<const uint4*>(row)[v];
    const uint32_t w = static_cast<uint32_t>(4 * v + 1);
    s1 += q.x + q.y + q.z + q.w;
    s2 += q.x * w + q.y * (w + 1u) + q.z * (w + 2u) + q.w * (w + 3u);
  }
  if (blockIdx.x == 0) {
    for (int64_t i = 4 * nv + threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t val = row[i];
      s1 += val;
      s2 += val * static_cast<uint32_t>(i + 1);
    }
  }
  __shared__ uint32_t part[2][kThreads / 32];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s1 = lane < nw ? part[0][lane] : 0u;
    s2 = lane < nw ? part[1][lane] : 0u;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      atomicAdd(out + 2 * static_cast<int64_t>(blockIdx.y), s1);
      atomicAdd(out + 2 * static_cast<int64_t>(blockIdx.y) + 1, s2);
    }
  }
}

}  // namespace repro

// x: device (rows, n) uint32 with row stride `row_stride` words; out: device
// (rows, 2) uint32, zeroed by the caller.
extern "C" int repro_checksum(uint64_t x, int64_t rows, int64_t n, int64_t row_stride, uint64_t out,
                              uint64_t stream) {
  using namespace repro;
  if (rows < 1 || rows > 65535 || n < 0) return -1;
  const uint32_t* px = reinterpret_cast<const uint32_t*>(x);
  // 16-byte loads need every row start aligned; otherwise the whole row is
  // the plain-word tail.
  const bool vec = aligned16(px) && (row_stride % 4 == 0);
  const int64_t nv = vec ? n / 4 : 0;
  int64_t bx = (nv + kThreads - 1) / kThreads;
  const int64_t cap = kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(rows));
  checksum_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      px, nv, n, row_stride, reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
