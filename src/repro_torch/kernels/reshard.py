"""Row gather for the elastic reshard as one batched copy over a table of
runs (CUDA kernel ``csrc/reshard.cu``, replacing ``repro/kernels/reshard.py``'s
``gather_rows_pallas``).

A run table is an int64 (n, 7) CPU tensor, one row per run: (source
number, byte offset in that source, byte offset in the output, bytes per
row, rows, source step, output step). Row j of a run copies its bytes from
source offset + j * source step to output offset + j * output step; a run
of one row is one contiguous copy. ``index_runs`` builds the table of
``out[i] = src[idx[i]]``, one run per stretch of consecutive indices;
``elastic/reshard.py`` builds one per new shard of a split leaf, one strided
run per plan segment over the leaf's outer slices, reading the origin shards
where they lie. ``copy_runs_into`` checks a table against its tensors on the
host and copies it: the kernel for card tensors, ``ref.copy_runs`` for CPU
ones.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0

INLINE_RUNS = 64  # kInlineRuns in csrc/reshard.cu: longer tables go through a device tensor
CHUNK = 1 << 16  # kChunk in csrc/reshard.cu: bytes of a run's rows one CTA copies
MAX_STRIDED_ROW = 1 << 35  # a run of several rows has rows under this many bytes
COLUMNS = ("source", "src_offset", "dst_offset", "bytes", "rows", "src_step", "dst_step")
UNITS = (16, 8, 4, 2, 1)  # copy widths in bytes, widest first


def unit_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest copy width that divides the row's byte length and every
    base address: the unit in which every row of a gather between these
    addresses moves with no head or tail bytes."""
    return next(u for u in UNITS if row_bytes % u == 0 and all(a % u == 0 for a in addresses))


def check_indices(idx: torch.Tensor, rows: int) -> None:
    """Raise unless every index lies in ``[0, rows)``. Reads ``idx`` on the
    host: free for a CPU index vector, one synchronisation for a card one.
    (``jnp.take`` in the reference clamps an out-of-range index and its
    Pallas kernel reads out of bounds; the port raises instead.)"""
    if idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= rows:
        raise IndexError(f"gather_rows: index range [{lo}, {hi}] outside the source's {rows} rows")


def index_runs(idx: torch.Tensor, row_bytes: int) -> torch.Tensor:
    """The run table of ``out[i] = src[idx[i]]`` for rows of ``row_bytes``
    bytes: one contiguous run per stretch of consecutive indices (duplicates
    and any order kept). ``idx`` may lie on the card: it is read on the
    host."""
    rows = idx.to(device="cpu", dtype=torch.int64).numpy()
    if rows.size == 0 or row_bytes == 0:
        return torch.zeros((0, len(COLUMNS)), dtype=torch.int64)
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1] + 1])
    table = np.zeros((starts.size, len(COLUMNS)), dtype=np.int64)
    table[:, 1] = rows[starts] * row_bytes
    table[:, 2] = starts * row_bytes
    table[:, 3] = np.diff(np.r_[starts, rows.size]) * row_bytes
    table[:, 4] = 1
    return torch.from_numpy(table)


def _misplaced(s_off, d_off, nbytes, rows, s_step, d_step, source_bytes, out_bytes):
    """Whether a run (numbers, or numpy columns of many) is empty, has too
    long a strided row, or reaches outside its source or the output."""
    return ((nbytes < 1) | (rows < 1) | (s_off < 0) | (d_off < 0) | (s_step < 0) | (d_step < 0)
            | ((rows > 1) & (nbytes >= MAX_STRIDED_ROW))
            | (s_off + (rows - 1) * s_step + nbytes > source_bytes) | (d_off + (rows - 1) * d_step + nbytes > out_bytes))


def check_runs(table: torch.Tensor, source_bytes: Sequence[int], out_bytes: int) -> None:
    """Raise unless ``table`` is an int64 (n, 7) CPU tensor whose every run
    has rows of at least one byte (under ``MAX_STRIDED_ROW`` when it has
    several) and lies inside its source and inside the output. Up to
    ``INLINE_RUNS`` runs in plain Python, which costs less than array
    operations at that size."""
    if (table.dtype != torch.int64 or table.ndim != 2 or table.shape[1] != len(COLUMNS)
            or table.device.type != "cpu"):
        raise ValueError(f"copy_runs: the table must be (n, {len(COLUMNS)}) int64 on the CPU, got "
                         f"{tuple(table.shape)} {table.dtype} on {table.device}")
    if table.shape[0] == 0:
        return
    if table.shape[0] <= INLINE_RUNS:
        runs = table.tolist()
        if any(not 0 <= r[0] < len(source_bytes) for r in runs):
            raise IndexError(f"copy_runs: a run names a source outside the {len(source_bytes)} given")
        bad = any(_misplaced(*r[1:], source_bytes[r[0]], out_bytes) for r in runs)
    else:
        src, *cols = table.numpy().T
        if src.min() < 0 or src.max() >= len(source_bytes):
            raise IndexError(f"copy_runs: a run names a source outside the {len(source_bytes)} given")
        bad = _misplaced(*cols, np.asarray(source_bytes, dtype=np.int64)[src], out_bytes).any()
    if bad:
        raise IndexError("copy_runs: a run is empty, has too long a strided row, or reaches outside its source "
                         "or the output")


def kernel_table(sources: Sequence[torch.Tensor], out: torch.Tensor, table: torch.Tensor
                 ) -> tuple[int, int, int, int, object]:
    """The table as the kernel takes it, for card tensors and at least one
    run: ``(host pointer, device pointer, runs, chunks, columns)``. The
    (7, n) int64 columns (source address, destination address, bytes per
    row, rows, source step, destination step, and the count of ``CHUNK``-byte
    chunks of this run and all before it; one CTA each) stay on the host
    for up to ``INLINE_RUNS`` runs, and are uploaded on ``out``'s current
    stream otherwise; keep the returned columns alive until the launch."""
    src, s_off, d_off, nbytes, rows, s_step, d_step = table.numpy().T
    bases = np.asarray([s.data_ptr() for s in sources], dtype=np.int64)
    chunk_end = np.cumsum(-(-(nbytes * rows) // CHUNK))
    columns = np.ascontiguousarray(np.stack([bases[src] + s_off, out.data_ptr() + d_off, nbytes, rows,
                                             s_step, d_step, chunk_end]))
    n, chunks = columns.shape[1], int(chunk_end[-1])
    if n <= INLINE_RUNS:
        return columns.ctypes.data, 0, n, chunks, columns
    on_card = torch.from_numpy(columns).pin_memory().to(out.device, non_blocking=True)
    return 0, on_card.data_ptr(), n, chunks, on_card


def copy_runs_into(sources: Sequence[torch.Tensor], out: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Copy every run of ``table`` from ``sources`` into ``out`` (contiguous
    tensors on one device, any dtypes; offsets in bytes) in one launch.
    CPU tensors take the plain version; a table with no runs launches
    nothing."""
    global launches
    if not out.is_contiguous() or not all(s.is_contiguous() for s in sources):
        raise ValueError("copy_runs: the sources and the output must be contiguous")
    for s in sources:
        if s.device != out.device:
            raise ValueError(f"copy_runs: a source on {s.device}, the output on {out.device}")
    check_runs(table, [s.numel() * s.element_size() for s in sources], out.numel() * out.element_size())
    if _build.device_kind(out) == "cpu":
        return ref.copy_runs(sources, out, table)
    if table.shape[0] == 0:
        return out
    *args, _keep = kernel_table(sources, out, table)
    with torch.cuda.device(out.device):
        _build.call("copy_runs", *args, _build.stream_of(out.device))
    launches += 1
    return out


def gather_rows_into(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` for a contiguous (rows, cols) ``src`` of any
    dtype, a (rows_out,) int32 ``idx`` and a contiguous (rows_out, cols)
    ``out`` of ``src``'s dtype on ``src``'s device, through the run table of
    ``idx``. ``idx`` may lie on the CPU for a card ``src``. CPU tensors take
    the plain version."""
    if src.ndim != 2 or out.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"gather_rows: expected src (rows, cols), idx (rows_out,), out (rows_out, cols); "
                         f"got {tuple(src.shape)}, {tuple(idx.shape)}, {tuple(out.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: idx must be int32, got {idx.dtype}")
    if out.shape != (idx.shape[0], src.shape[1]) or out.dtype != src.dtype:
        raise ValueError(f"gather_rows: out must be {(idx.shape[0], src.shape[1])} {src.dtype}, "
                         f"got {tuple(out.shape)} {out.dtype}")
    if out.device != src.device:
        raise ValueError(f"gather_rows: out on {out.device}, src on {src.device}")
    if idx.device != src.device and not (idx.device.type == "cpu" and src.device.type == "cuda"):
        raise ValueError(f"gather_rows: idx on {idx.device}, src on {src.device}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("gather_rows: src and out must be contiguous")
    idx = idx.cpu()
    check_indices(idx, src.shape[0])
    return copy_runs_into([src], out, index_runs(idx, src.shape[1] * src.element_size()))
