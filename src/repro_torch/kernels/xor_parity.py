"""XOR parity: one row = the XOR of k uint32 rows (CUDA kernel
``csrc/xor_parity.cu``, replacing ``repro/kernels/xor_parity.py``'s
``xor_reduce_pallas``)."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0


def xor_reduce_into(rows: Sequence[torch.Tensor], out: torch.Tensor) -> torch.Tensor:
    """``out = rows[0] ^ ... ^ rows[k-1]``; every row and ``out`` a
    contiguous (n,) uint32 view, anywhere in memory (no stacking copy on the
    card). CPU tensors take the plain version."""
    global launches
    n = out.numel()
    _build.check_rows([*rows, out], n, out.device, "xor_reduce", _build.MAX_K + 1)
    if _build.device_kind(out) == "cpu":
        out.copy_(ref.xor_reduce(torch.stack(list(rows))))
        return out
    if len(rows) > _build.MAX_K:
        raise ValueError(f"xor_reduce: at most {_build.MAX_K} rows per launch")
    with torch.cuda.device(out.device):
        _build.call("xor_parity", _build.ptr_array(rows), len(rows), out.data_ptr(), n,
                    _build.stream_of(out.device))
    launches += 1
    return out
