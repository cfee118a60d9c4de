"""Fletcher dual checksum, batched over rows (CUDA kernel
``csrc/checksum.cu``, replacing ``repro/kernels/checksum.py``'s
``checksum_pallas``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0


def checksum_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, n) uint32 with unit column stride (any row stride) -> (rows, 2)
    uint32: per row ``s1 = Σ x_i``, ``s2 = Σ (i+1)·x_i`` mod 2^32. CPU
    tensors take the plain version."""
    global launches
    if x.dtype != torch.uint32 or x.ndim != 2:
        raise ValueError(f"checksum: expected (rows, n) uint32, got {tuple(x.shape)} {x.dtype}")
    rows, n = x.shape
    if n > 1 and x.stride(1) != 1:
        raise ValueError("checksum: rows must be contiguous")
    if _build.device_kind(x) == "cpu":
        return ref.checksum_rows(x)
    if not 1 <= rows <= 65535:
        raise ValueError(f"checksum: 1..65535 rows per launch, got {rows}")
    # zeroed through an int32 view: fill kernels for uint32 are not in every build
    out = torch.zeros((rows, 2), dtype=torch.int32, device=x.device).view(torch.uint32)
    with torch.cuda.device(x.device):
        _build.call("checksum", x.data_ptr(), rows, n, x.stride(0) if rows > 1 else n,
                    out.data_ptr(), _build.stream_of(x.device))
    launches += 1
    return out
