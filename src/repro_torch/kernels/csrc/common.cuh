// Shared helpers of the device-tier kernels (sm_90a, plain C interface).
//
// Every kernel streams uint32 words: 16-byte vector loads (uint4) when all of
// its row pointers are 16-byte aligned, plain 4-byte loads otherwise, and the
// ragged tail of a vector run as plain words in the same launch. A
// grid-stride loop covers any length, so the wrappers pad nothing. Row pointers travel by value in the
// kernel's parameter space, which lets a "row" be any contiguous view (a
// parity group's members inside the fused bucket, a stripe slot of the
// payload) with no gather copy.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxK = 16;  // input rows per launch
constexpr int kMaxM = 8;   // output rows per launch
constexpr int kThreads = 256;
// 132 SMs x 8 resident blocks of 256 threads: enough in flight to saturate
// HBM; the grid-stride loop covers the rest.
constexpr int64_t kMaxBlocks = 132 * 8;

struct Rows {
  const uint32_t* in[kMaxK];
  uint32_t* out[kMaxM];
};

__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <typename W>
__device__ __forceinline__ W load_word(const uint32_t* p, int64_t i) {
  return reinterpret_cast<const W*>(p)[i];
}

template <typename W>
__device__ __forceinline__ void store_word(uint32_t* p, int64_t i, W v) {
  reinterpret_cast<W*>(p)[i] = v;
}

inline int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline bool rows_aligned(const Rows& r, int k, int m) {
  for (int i = 0; i < k; ++i)
    if (!aligned16(r.in[i])) return false;
  for (int j = 0; j < m; ++j)
    if (!aligned16(r.out[j])) return false;
  return true;
}

inline Rows make_rows(const uint64_t* in, int k, const uint64_t* out, int m) {
  Rows r{};
  for (int i = 0; i < k; ++i) r.in[i] = reinterpret_cast<const uint32_t*>(in[i]);
  for (int j = 0; j < m; ++j) r.out[j] = reinterpret_cast<uint32_t*>(out[j]);
  return r;
}

// One launch covers n words: [0, 4*nv) as uint4 and the tail [4*nv, n) as
// plain words. nv = n/4 when every row is 16-byte aligned, else 0 (the whole
// row is the tail).
inline int64_t vector_words(const Rows& r, int k, int m, int64_t n) {
  return rows_aligned(r, k, m) ? n / 4 : 0;
}

inline int grid_for_split(int64_t nv, int64_t n) {
  const int64_t tail = n - 4 * nv;
  return grid_for(nv > tail ? nv : tail);
}

__device__ __forceinline__ int64_t first_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

}  // namespace repro
