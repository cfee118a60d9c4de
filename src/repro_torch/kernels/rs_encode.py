"""Reed-Solomon GF(2^8) encode with a static generator (CUDA kernel
``csrc/rs_encode.cu``, replacing ``repro/kernels/rs_encode.py``'s
``rs_encode_pallas``)."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process (CPU calls do not count)
launches = 0


def expand_generator(coefs: tuple[tuple[int, ...], ...]) -> tuple[int, ...]:
    """The kernel's operands for an (m, k) generator of field elements:
    the per-term multipliers ``coefs[j][i] · α^s`` flattened (m, k, 8)
    row-major. Raises ``ValueError`` outside the kernel's 1..16 inputs and 1..8
    outputs, or for a coefficient outside 0..255."""
    m, k = len(coefs), len(coefs[0]) if coefs else 0
    if not (1 <= k <= _build.MAX_K and 1 <= m <= _build.MAX_M) or any(len(r) != k for r in coefs):
        raise ValueError(f"rs_encode: the generator must be (m, k) with 1 <= m <= {_build.MAX_M}, "
                         f"1 <= k <= {_build.MAX_K}; got {[len(r) for r in coefs]}")
    flat = [int(c) for r in coefs for c in r]
    if any(not 0 <= c <= 255 for c in flat):
        raise ValueError("rs_encode: coefficients are GF(2^8) elements 0..255")
    return tuple(ref.gf_mul_alpha_pow(c, s) for c in flat for s in range(8))


@functools.lru_cache(maxsize=64)
def _kernel_args(coefs: tuple[tuple[int, ...], ...]):
    """``expand_generator`` as the C entry point takes it, once per generator."""
    terms = expand_generator(coefs)
    return (ctypes.c_uint32 * len(terms))(*terms)


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
    key = tuple(tuple(int(c) for c in r) for r in coefs)
    if len(key) != m or any(len(r) != k for r in key):
        raise ValueError(f"rs_encode: coefs must be ({m}, {k})")
    n = outs[0].numel()
    device = outs[0].device
    _build.check_rows(rows, n, device, "rs_encode", _build.MAX_K)
    _build.check_rows(outs, n, device, "rs_encode", _build.MAX_M)
    terms = _kernel_args(key)
    if _build.device_kind(outs[0]) == "cpu":
        res = ref.gf256_matmul(torch.stack(list(rows)), key)
        for j, o in enumerate(outs):
            o.copy_(res[j])
        return
    with torch.cuda.device(device):
        _build.call("rs_encode", _build.ptr_array(rows), k, _build.ptr_array(outs), m, terms, n,
                    _build.stream_of(device))
    launches += 1
