// Row gather for the elastic N-to-M reshard: out[i] = src[idx[i]] for a
// (rows, row_bytes) source matrix and a (rows_out,) int32 index vector.
//
// Replaces the TPU kernel repro/kernels/reshard.py::gather_rows_pallas
// (_gather_kernel). What it computes is the same; the TPU kernel's tiling is
// not carried over: there, the index vector rides in as scalar prefetch, the
// columns are padded to 128 lanes and every grid step moves one (1, 128)
// block. Here nothing is padded. The wrapper views each row as units of the
// widest width (16, 8, 4, 2 or 1 bytes) that divides the row's byte length
// and both base addresses, and the kernel walks the flat (out_row, unit)
// space with a grid-stride loop: neighbouring threads copy neighbouring units
// of a row, and each thread reads idx[out_row] itself (no scalar prefetch on
// this card). The same launch serves 4-byte rows (a norm scale split along
// its only dim) and half-megabyte rows (an MLP weight split along its model
// dim) with every SM busy, where one block per output row would leave most
// SMs idle on the short rows and serialise the long ones. Offsets are 64-bit:
// one stacked leaf of the llama3.2-1b train state is over 2^31 bytes. The
// loop steps (row, col) by the grid stride's quotient and remainder by the
// row length, so no thread divides inside the loop.
//
// Bound: bytes. Each output byte is read once from the source and written
// once, 2 * rows_out * row_bytes over the card's memory rate; there is no
// arithmetic to speak of.
//
// The indices are not checked here: the wrapper checks 0 <= idx < rows on the
// host before the launch and raises (jnp.take in the reference clamps an
// out-of-range index, and the Pallas kernel reads out of bounds).
#include "common.cuh"

namespace repro {

template <typename U>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const U* __restrict__ src, const int32_t* __restrict__ idx, U* __restrict__ out,
                  int64_t rows_out, int64_t units, int64_t step_rows, int64_t step_units) {
  const int64_t i = first_index();
  int64_t row = i / units;
  int64_t col = i - row * units;
  while (row < rows_out) {
    const int64_t s = idx[row];
    out[row * units + col] = src[s * units + col];
    col += step_units;
    row += step_rows;
    if (col >= units) {
      col -= units;
      ++row;
    }
  }
}

template <typename U>
int launch(uint64_t src, uint64_t idx, uint64_t out, int64_t rows_out, int64_t units, cudaStream_t stream) {
  const int grid = grid_for(rows_out * units);
  const int64_t stride = static_cast<int64_t>(grid) * kThreads;
  gather_kernel<U><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const U*>(src), reinterpret_cast<const int32_t*>(idx), reinterpret_cast<U*>(out),
      rows_out, units, stride / units, stride % units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// One launch; returns its status. ``unit`` is the copy width in bytes (1, 2,
// 4, 8 or 16); it must divide ``row_bytes`` and both base addresses.
extern "C" int repro_gather_rows(uint64_t src, uint64_t idx, uint64_t out, int64_t rows_out, int64_t row_bytes,
                                 int unit, uint64_t stream) {
  using namespace repro;
  if (rows_out < 1 || row_bytes < 1 || unit < 1 || row_bytes % unit != 0 || src % unit != 0 || out % unit != 0)
    return -1;
  const int64_t units = row_bytes / unit;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch<uint4>(src, idx, out, rows_out, units, s);
    case 8: return launch<uint2>(src, idx, out, rows_out, units, s);
    case 4: return launch<uint32_t>(src, idx, out, rows_out, units, s);
    case 2: return launch<uint16_t>(src, idx, out, rows_out, units, s);
    case 1: return launch<uint8_t>(src, idx, out, rows_out, units, s);
    default: return -1;
  }
}
