"""GF(2^8) erasure decode with a runtime coefficient matrix (CUDA kernel
``csrc/rs_decode.cu``, replacing ``repro/kernels/rs_decode.py``'s
``rs_decode_pallas``)."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0


def rs_decode_into(
    rows: Sequence[torch.Tensor],
    coefs: torch.Tensor,
    outs: Sequence[torch.Tensor],
) -> None:
    """``outs[j] = ⊕_i coefs[j, i] · rows[i]`` over GF(2^8) with ``coefs`` a
    runtime (m, k) uint32 tensor on the rows' device (the failure-dependent
    decode rows: one compiled kernel serves every failure pattern). Every row
    and output a contiguous (n,) uint32 view. CPU tensors take the plain
    version."""
    global launches
    k, m = len(rows), len(outs)
    if coefs.dtype != torch.uint32 or tuple(coefs.shape) != (m, k):
        raise ValueError(f"rs_decode: coefs must be ({m}, {k}) uint32, got {tuple(coefs.shape)} {coefs.dtype}")
    n = outs[0].numel()
    device = outs[0].device
    _build.check_rows(rows, n, device, "rs_decode", _build.MAX_K)
    _build.check_rows(outs, n, device, "rs_decode", _build.MAX_M)
    if coefs.device != device:
        raise ValueError(f"rs_decode: coefs on {coefs.device}, rows on {device}")
    if _build.device_kind(outs[0]) == "cpu":
        res = ref.gf256_matmul_dyn(torch.stack(list(rows)), coefs)
        for j, o in enumerate(outs):
            o.copy_(res[j])
        return
    coefs = coefs.contiguous()
    with torch.cuda.device(device):
        _build.call("rs_decode", _build.ptr_array(rows), k, _build.ptr_array(outs), m,
                    coefs.data_ptr(), n, _build.stream_of(device))
    launches += 1
