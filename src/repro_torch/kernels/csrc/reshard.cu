// Row gather for the elastic N-to-M reshard, as one batched copy over a
// table of runs. Run r copies `rows` rows of `len` bytes: row j from
// src + j * src_step to dst + j * dst_step (one row is one contiguous run).
//
// Replaces the TPU kernel repro/kernels/reshard.py::gather_rows_pallas
// (_gather_kernel, out[i] = src[idx[i]] over a stacked (rows, cols) matrix).
// The bytes written are the same; the form is not. There, the index vector
// rides in as scalar prefetch and every grid step moves one (1, 128) block
// of one row, because a Pallas call takes one array. Here the wrapper turns
// the gather into runs on the host (kernels/reshard.py): consecutive indices
// merge into one run, and the elastic executor lists one strided run per
// plan segment, its rows the leaf's outer slices, reading each origin shard
// where it lies, so nothing is stacked first. The plan's w_up gather is two
// strided runs of 16 rows of 16.8 MB; the embedding's two of 128,256 rows of
// 2 KiB; a permuted index is one run per row.
//
// Bound: bytes. Each byte of a run is read once and written once, 2 * total
// over the card's memory rate. What the design does about it:
// - Each run's bytes, row after row, are cut into kChunk-byte chunks, one
//   CTA each. There is no persistent loop: the block scheduler keeps every
//   SM fed and the grid sweeps memory in order, which measured faster than
//   a persistent grid striding over chunks (PERF.md). A warp finds its
//   chunk's run in two or three rounds of 32 parallel loads.
// - Where every row of the run is 16-byte aligned on both sides (the
//   elastic runs of f32 leaves, any run of whole 16-byte rows): the chunk's
//   16-byte units over all threads, kDepth independent loads per thread
//   before its stores, each unit's row by a 32-bit quotient, so short
//   strided rows keep as many loads in flight as one long run.
// - Otherwise row by row: the part of a row inside the chunk whose two
//   addresses agree modulo 16 moves in 16-byte units the same way (by the
//   whole CTA from kCtaMin bytes, else by one warp, round robin), its head
//   and tail (under 16 bytes each) singly; a row whose addresses disagree
//   modulo 16 moves in the widest unit they share.
// - The table travels in the kernel's parameters up to kInlineRuns runs;
//   a longer one lies in a device tensor the wrapper uploaded.
// A variant moving the aligned units by TMA bulk copies (cp.async.bulk)
// through a ring in shared memory, issued by one thread, lost to this one
// on every shape measured, by 53% on 2 KiB rows (PERF.md), and was removed.
//
// The wrapper checks every run against its tensors' extents on the host
// (an out-of-range index raises there); runs are non-empty.
#include "common.cuh"

namespace repro {

constexpr int kColumns = 7;  // src, dst, len, rows, src_step, dst_step, chunk_end
constexpr int kInlineRuns = 64;
constexpr int64_t kChunk = 64 << 10;
constexpr int64_t kCtaMin = 8 << 10;
constexpr int kDepth = 8;

struct RunParams {
  int64_t n;
  const int64_t* table;  // device (kColumns, n); null when `inline_table` holds it
  int64_t inline_table[kColumns * kInlineRuns];  // (kColumns, n) in its first kColumns * n
};

// The first run r with end[r] > x, by one whole warp: each round reads 32
// boundaries of the remaining range at once and keeps the span between two
// of them, so 1,024 runs take two rounds of loads, not ten dependent ones.
__device__ __forceinline__ int64_t first_run_ending_after(const int64_t* end, int64_t n, int64_t x, int lane) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32, i = lo + lane * step;
    const unsigned above = __ballot_sync(0xffffffffu, i >= hi || end[i] > x);
    if (above == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(above) - 1;
      hi = min(hi, lo + f * step);
      lo = f == 0 ? hi : lo + (f - 1) * step + 1;
    }
  }
  const int64_t i = lo + lane;
  const unsigned above = __ballot_sync(0xffffffffu, i < hi && end[i] > x);
  return above == 0 ? hi : lo + __ffs(above) - 1;
}

template <typename U>
__device__ __forceinline__ void copy_units(const char* s, char* d, int64_t len, int t, int count) {
  const int64_t head = min(len, static_cast<int64_t>((sizeof(U) - reinterpret_cast<uintptr_t>(s) % sizeof(U)) %
                                                     sizeof(U)));
  const int64_t units = (len - head) / static_cast<int64_t>(sizeof(U));
  const int64_t tail = head + units * static_cast<int64_t>(sizeof(U));
  if (t < head) d[t] = s[t];
  if (tail + t < len) d[tail + t] = s[tail + t];
  const U* su = reinterpret_cast<const U*>(s + head);
  U* du = reinterpret_cast<U*>(d + head);
  for (int64_t i = t; i < units; i += count) du[i] = su[i];
}

// len bytes from s to d by `count` threads (this one is t, count >= 16), in
// the widest unit under 16 bytes the two addresses share.
__device__ __forceinline__ void copy_threads(const char* s, char* d, int64_t len, int t, int count) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(s) ^ reinterpret_cast<uintptr_t>(d);
  if ((x & 7) == 0)
    copy_units<uint2>(s, d, len, t, count);
  else if ((x & 3) == 0)
    copy_units<uint32_t>(s, d, len, t, count);
  else if ((x & 1) == 0)
    copy_units<uint16_t>(s, d, len, t, count);
  else
    copy_units<uint8_t>(s, d, len, t, count);
}

// `units` 16-byte units by `count` threads, kDepth loads in flight per
// thread.
__device__ __forceinline__ void copy_deep(const uint4* s, uint4* d, int64_t units, int t, int count) {
  for (int64_t base = t; base < units; base += static_cast<int64_t>(kDepth) * count) {
    uint4 v[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * count;
      if (i < units) v[k] = __ldcs(s + i);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * count;
      if (i < units) __stcs(d + i, v[k]);
    }
  }
}

// A strided run whose rows are all 16-byte aligned: its units [w0, w1)
// (per_row 16-byte units to a row, rows src_step and dst_step bytes apart;
// w1 - w0 <= kChunk / 16, per_row < 2^31) by `count` threads, kDepth loads
// in flight per thread, each unit's row by a 32-bit quotient.
__device__ __forceinline__ void copy_rows(const char* s, char* d, int64_t per_row, int64_t src_step,
                                          int64_t dst_step, int64_t w0, int64_t w1, int t, int count) {
  const int64_t row0 = w0 / per_row;
  const uint32_t per = static_cast<uint32_t>(per_row), col0 = static_cast<uint32_t>(w0 - row0 * per_row);
  const uint32_t units = static_cast<uint32_t>(w1 - w0);
  s += row0 * src_step;
  d += row0 * dst_step;
  for (uint32_t base = t; base < units; base += kDepth * count) {
    uint4 v[kDepth];
    uint32_t q[kDepth], c[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const uint32_t i = base + k * count, x = col0 + i;
      q[k] = x / per;
      c[k] = x - q[k] * per;
      if (i < units) v[k] = __ldcs(reinterpret_cast<const uint4*>(s + q[k] * src_step) + c[k]);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k)
      if (base + k * count < units) __stcs(reinterpret_cast<uint4*>(d + q[k] * dst_step) + c[k], v[k]);
  }
}

__global__ void __launch_bounds__(kThreads) copy_runs_kernel(const __grid_constant__ RunParams p) {
  const int64_t n = p.n;
  const int64_t* col = p.table ? p.table : p.inline_table;
  const int64_t *src = col, *dst = col + n, *len = col + 2 * n, *rows = col + 3 * n;
  const int64_t *src_step = col + 4 * n, *dst_step = col + 5 * n, *chunk_end = col + 6 * n;
  const int t = threadIdx.x, lane = t & 31;
  // this CTA's chunk: bytes [a, b) of one run's rows, in row order
  const int64_t r = first_run_ending_after(chunk_end, n, blockIdx.x, lane);  // every warp for itself
  const int64_t row = len[r], a = (blockIdx.x - (r ? chunk_end[r - 1] : 0)) * kChunk;
  const int64_t b = min(a + kChunk, rows[r] * row);
  const char* const s0 = reinterpret_cast<const char*>(src[r]);
  char* const d0 = reinterpret_cast<char*>(dst[r]);
  const int64_t ss = src_step[r], ds = dst_step[r];
  if (((src[r] | dst[r] | row | ss | ds) & 15) == 0) {  // every row 16-byte aligned on both sides
    if (rows[r] == 1)
      copy_deep(reinterpret_cast<const uint4*>(s0 + a), reinterpret_cast<uint4*>(d0 + a), (b - a) / 16, t, kThreads);
    else
      copy_rows(s0, d0, row / 16, ss, ds, a / 16, b / 16, t, kThreads);
    return;
  }
  // row by row: the piece of row j inside [a, b), the k-th of the chunk
  const int warps = kThreads / 32;
  for (int64_t j = a / row, k = 0; j * row < b; ++j, ++k) {
    const int64_t o = max(a, j * row) - j * row, piece = min(b, (j + 1) * row) - j * row - o;
    const char* s = s0 + j * ss + o;
    char* d = d0 + j * ds + o;
    const bool mine = (t >> 5) == k % warps;  // this warp's turn for short work
    const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
    if (((sa ^ reinterpret_cast<uintptr_t>(d)) & 15) == 0) {
      const int64_t head = min(piece, static_cast<int64_t>((16 - (sa & 15)) & 15));
      const int64_t mid = (piece - head) & ~static_cast<int64_t>(15), tail = head + mid;
      const uint4* su = reinterpret_cast<const uint4*>(s + head);
      uint4* du = reinterpret_cast<uint4*>(d + head);
      if (mid >= kCtaMin)
        copy_deep(su, du, mid / 16, t, kThreads);
      else if (mine)
        copy_deep(su, du, mid / 16, lane, 32);
      if (mine) {  // under 16 bytes on each side
        if (lane < head) d[lane] = s[lane];
        if (tail + lane < piece) d[tail + lane] = s[tail + lane];
      }
    } else if (piece >= kCtaMin) {
      copy_threads(s, d, piece, t, kThreads);
    } else if (mine) {
      copy_threads(s, d, piece, lane, 32);
    }
  }
}

}  // namespace repro

// One launch of `chunks` CTAs over n >= 1 runs; returns its status. The
// table is seven columns of n int64: source address, destination address,
// bytes per row, rows, source and destination step between rows, and the
// count of kChunk-byte chunks (64 KiB) of this run and all before it, the
// last of which is `chunks`. A row of a run of more than one row is under
// 2^35 bytes. The table is read at `host_table` (host memory, before this
// returns) when n <= 64, else at `device_table` (device memory, by the
// kernel).
extern "C" int repro_copy_runs(uint64_t host_table, uint64_t device_table, int64_t n, int64_t chunks,
                               uint64_t stream) {
  using namespace repro;
  if (n < 1 || chunks < 1 || chunks > 0x7fffffff) return -1;
  RunParams p{};
  p.n = n;
  if (n <= kInlineRuns) {
    if (host_table == 0) return -1;
    const int64_t* h = reinterpret_cast<const int64_t*>(host_table);
    for (int64_t i = 0; i < kColumns * n; ++i) p.inline_table[i] = h[i];
    if (p.inline_table[kColumns * n - 1] != chunks) return -1;
  } else {
    if (device_table == 0) return -1;
    p.table = reinterpret_cast<const int64_t*>(device_table);
  }
  copy_runs_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
