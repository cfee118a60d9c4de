// Blockwise symmetric int8 quantization and its inverse, per 256-element
// block:
//   scale = max(max|x| * fl(1/127), 1e-30)
//   q     = clamp(round_half_even(x / scale), -127, 127)   (int8)
//   x'    = q * scale                                       (f32)
//
// Replaces the TPU kernels repro/kernels/quantize.py::quantize_pallas
// (_quant_kernel) and dequantize_pallas (_dequant_kernel). On the TPU a
// (32, 256) tile sits in VMEM and the row max is a vector reduction; here
// one warp owns one 256-element block: lane l holds elements 4l..4l+3 and
// 128+4l..128+4l+3 in registers, so every load and store instruction of the
// warp covers one contiguous span (512 bytes of f32, 128 bytes of codes)
// and no 32-byte sector is written in halves by two instructions. The
// block max is a 5-step shuffle reduction; lane 0 writes the scale. A
// grid-stride loop over blocks with 64-bit indices covers any length (the
// device-tier bucket holds 3.7 G elements). Elements at or past n read as
// 0, which is the reference's zero padding to a whole number of blocks, so
// the wrapper pads nothing.
//
// Bound: bytes. Quantize reads 4 (f32) or 2 (bf16/f16) bytes and writes 1
// byte per element plus 4 per block; dequantize reads 1 and writes 4. The
// arithmetic (one IEEE division per element) stays far below the memory
// time on this card.
//
// The bytes must equal the reference's. Its source divides the block max by
// 127.0, but XLA rewrites a division by a constant into a multiplication by
// the constant's f32 reciprocal (0x3c010204), so the reference's scale is
// that product, correctly rounded (__fmul_rn); the true quotient differs in
// the last bit on some blocks. The codes divide by a tensor, which XLA
// keeps as a true IEEE division (__fdiv_rn, never a multiply by the
// reciprocal). __float2int_rn rounds half to even like jnp.round, and the
// library is built without --use_fast_math (denormals kept, no approximate
// division).
// NaN/Inf inputs are unspecified in the reference (an int8 cast of NaN);
// here fmaxf drops a NaN from the block max and __float2int_rn(NaN) gives 0.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace repro {

constexpr int kBlock = 256;       // elements per scale (QBLOCK)
constexpr int kPerLane = kBlock / 32;
constexpr uint32_t kInv127Bits = 0x3c010204u;  // fl(1/127)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// The 4 elements of one lane's half-block, starting at element i (16-byte
// aligned for f32, 8-byte for bf16/f16).
template <typename T>
__device__ __forceinline__ void load4_vec(const T* x, int64_t i, float* v);

template <>
__device__ __forceinline__ void load4_vec<float>(const float* x, int64_t i, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(x + i);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <typename H>
__device__ __forceinline__ void load4_half(const H* x, int64_t i, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(x + i);
  const H* h = reinterpret_cast<const H*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_float(h[j]);
}

template <>
__device__ __forceinline__ void load4_vec<__nv_bfloat16>(const __nv_bfloat16* x, int64_t i, float* v) {
  load4_half(x, i, v);
}

template <>
__device__ __forceinline__ void load4_vec<__half>(const __half* x, int64_t i, float* v) {
  load4_half(x, i, v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// kVec: x is 16-byte aligned, so a lane whose elements all lie below n
// reads them as vectors; otherwise (and for the ragged last block) element
// by element, with zeros at and past n.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const T* __restrict__ x, int64_t n, int64_t n_blocks,
                                                            int8_t* __restrict__ q, float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = grid_stride() >> 5;
  for (int64_t b = first_index() >> 5; b < n_blocks; b += warps) {
    const int64_t lo = b * kBlock + 4 * lane, hi = lo + kBlock / 2;  // the lane's two half-block spans
    float v[kPerLane];
    if (kVec && hi + 4 <= n) {
      load4_vec(x, lo, v);
      load4_vec(x, hi, v + 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = lo + j < n ? to_float(x[lo + j]) : 0.0f;
        v[j + 4] = hi + j < n ? to_float(x[hi + j]) : 0.0f;
      }
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) amax = fmaxf(amax, fabsf(v[j]));
    const float s = fmaxf(__fmul_rn(warp_max(amax), __uint_as_float(kInv127Bits)), 1e-30f);
    uint32_t codes[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      int c = __float2int_rn(__fdiv_rn(v[j], s));
      c = c < -127 ? -127 : (c > 127 ? 127 : c);
      codes[j / 4] |= (static_cast<uint32_t>(c) & 0xFFu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint32_t*>(q + lo) = codes[0];
    *reinterpret_cast<uint32_t*>(q + hi) = codes[1];
    if (lane == 0) scale[b] = s;
  }
}

__device__ __forceinline__ float code_at(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * j))));
}

// kVec: q is 4-byte aligned (one 4-byte load per half-block span).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) dequantize_kernel(const int8_t* __restrict__ q,
                                                              const float* __restrict__ scale, int64_t n_blocks,
                                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = grid_stride() >> 5;
  for (int64_t b = first_index() >> 5; b < n_blocks; b += warps) {
    const int64_t lo = b * kBlock + 4 * lane, hi = lo + kBlock / 2;
    float c[kPerLane];
    if (kVec) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(q + lo);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(q + hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = code_at(w0, j);
        c[j + 4] = code_at(w1, j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = static_cast<float>(q[lo + j]);
        c[j + 4] = static_cast<float>(q[hi + j]);
      }
    }
    const float s = scale[b];  // the same address for the whole warp: one broadcast load
    *reinterpret_cast<float4*>(out + lo) = make_float4(c[0] * s, c[1] * s, c[2] * s, c[3] * s);
    *reinterpret_cast<float4*>(out + hi) = make_float4(c[4] * s, c[5] * s, c[6] * s, c[7] * s);
  }
}

inline int grid_for_blocks(int64_t n_blocks) {
  // one warp per block, kThreads / 32 warps per thread block
  return grid_for(n_blocks * 32);
}

template <typename T>
int launch_quantize(uint64_t x, int64_t n, int64_t n_blocks, uint64_t q, uint64_t scale, uint64_t stream) {
  const T* px = reinterpret_cast<const T*>(x);
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for_blocks(n_blocks);
  if (aligned16(px))
    quantize_kernel<T, true><<<grid, kThreads, 0, s>>>(px, n, n_blocks, reinterpret_cast<int8_t*>(q),
                                                       reinterpret_cast<float*>(scale));
  else
    quantize_kernel<T, false><<<grid, kThreads, 0, s>>>(px, n, n_blocks, reinterpret_cast<int8_t*>(q),
                                                        reinterpret_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// x: device (n,) elements of type `dtype` (0 f32, 1 bf16, 2 f16); q: device
// (n_blocks * 256,) int8, 4-byte aligned; scale: device (n_blocks,) f32;
// n <= n_blocks * 256. Returns the launch status.
extern "C" int repro_quantize(uint64_t x, int dtype, int64_t n, int64_t n_blocks, uint64_t q, uint64_t scale,
                              uint64_t stream) {
  using namespace repro;
  if (n < 0 || n_blocks < 0 || n > n_blocks * kBlock || (q & 3u) != 0) return -1;
  if (n_blocks == 0) return 0;
  switch (dtype) {
    case 0: return launch_quantize<float>(x, n, n_blocks, q, scale, stream);
    case 1: return launch_quantize<__nv_bfloat16>(x, n, n_blocks, q, scale, stream);
    case 2: return launch_quantize<__half>(x, n, n_blocks, q, scale, stream);
    default: return -1;
  }
}

// q: device (n_blocks * 256,) int8; scale: device (n_blocks,) f32; out:
// device (n_blocks * 256,) f32, 16-byte aligned. Returns the launch status.
extern "C" int repro_dequantize(uint64_t q, uint64_t scale, int64_t n_blocks, uint64_t out, uint64_t stream) {
  using namespace repro;
  if (n_blocks < 0 || (out & 15u) != 0) return -1;
  if (n_blocks == 0) return 0;
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for_blocks(n_blocks);
  const int8_t* pq = reinterpret_cast<const int8_t*>(q);
  if ((q & 3u) == 0)
    dequantize_kernel<true><<<grid, kThreads, 0, s>>>(pq, reinterpret_cast<const float*>(scale), n_blocks,
                                                      reinterpret_cast<float*>(out));
  else
    dequantize_kernel<false><<<grid, kThreads, 0, s>>>(pq, reinterpret_cast<const float*>(scale), n_blocks,
                                                       reinterpret_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
