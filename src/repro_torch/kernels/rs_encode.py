"""Reed-Solomon GF(2^8) encode with a static generator (CUDA kernel
``csrc/rs_encode.cu``, replacing ``repro/kernels/rs_encode.py``'s
``rs_encode_pallas``)."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0


def rs_encode_into(
    rows: Sequence[torch.Tensor],
    coefs: Sequence[Sequence[int]],
    outs: Sequence[torch.Tensor],
) -> None:
    """``outs[j] = ⊕_i coefs[j][i] · rows[i]`` over GF(2^8), 4 packed bytes
    per uint32 word. ``coefs`` is the (m, k) generator as field elements
    0..255; every row and output a contiguous (n,) uint32 view. CPU tensors
    take the plain version."""
    global launches
    k, m = len(rows), len(outs)
    if len(coefs) != m or any(len(r) != k for r in coefs):
        raise ValueError(f"rs_encode: coefs must be ({m}, {k})")
    flat = [int(c) for r in coefs for c in r]
    if any(not 0 <= c <= 255 for c in flat):
        raise ValueError("rs_encode: coefficients are GF(2^8) elements 0..255")
    n = outs[0].numel()
    device = outs[0].device
    _build.check_rows(rows, n, device, "rs_encode", _build.MAX_K)
    _build.check_rows(outs, n, device, "rs_encode", _build.MAX_M)
    if _build.device_kind(outs[0]) == "cpu":
        res = ref.gf256_matmul(torch.stack(list(rows)), coefs)
        for j, o in enumerate(outs):
            o.copy_(res[j])
        return
    c = (ctypes.c_uint8 * len(flat))(*flat)
    with torch.cuda.device(device):
        _build.call("rs_encode", _build.ptr_array(rows), k, _build.ptr_array(outs), m, c, n,
                    _build.stream_of(device))
    launches += 1
