"""Row gather for the elastic reshard: ``out[i] = src[idx[i]]`` (CUDA kernel
``csrc/reshard.cu``, replacing ``repro/kernels/reshard.py``'s
``gather_rows_pallas``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0

UNITS = (16, 8, 4, 2, 1)  # copy widths in bytes, widest first


def unit_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest copy width that divides the row's byte length and every
    base address."""
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


def gather_rows_into(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` for a contiguous (rows, cols) ``src`` of any
    dtype, a (rows_out,) int32 ``idx`` and a contiguous (rows_out, cols)
    ``out`` of ``src``'s dtype on ``src``'s device. ``idx`` may lie on the
    CPU for a card ``src``: it is checked there and copied over. CPU tensors
    take the plain version."""
    global launches
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
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("gather_rows: src and out must be contiguous")
    check_indices(idx, src.shape[0])
    if _build.device_kind(src) == "cpu":
        if idx.device != src.device:
            raise ValueError(f"gather_rows: idx on {idx.device}, src on {src.device}")
        out.copy_(ref.gather_rows(src, idx))
        return out
    if out.numel() == 0:
        return out
    if idx.device != src.device:
        if idx.device.type != "cpu":
            raise ValueError(f"gather_rows: idx on {idx.device}, src on {src.device}")
        idx = idx.to(src.device)
    idx = idx.contiguous()
    row_bytes = src.shape[1] * src.element_size()
    unit = unit_bytes(row_bytes, src.data_ptr(), out.data_ptr())
    with torch.cuda.device(src.device):
        _build.call("gather_rows", src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), row_bytes, unit,
                    _build.stream_of(src.device))
    launches += 1
    return out
