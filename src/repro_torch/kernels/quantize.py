"""Blockwise int8 quantize and dequantize (CUDA kernels ``csrc/quantize.cu``,
replacing ``repro/kernels/quantize.py``'s ``quantize_pallas`` and
``dequantize_pallas``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

QBLOCK = 256          # quantization block (elements per scale)
ROWS_PER_TILE = 32    # the reference pads to whole (32, 256) tiles

#: launches of each CUDA kernel in this process (CPU calls do not count)
quantize_launches = 0
dequantize_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_1d(t: torch.Tensor, what: str, dtype: torch.dtype | None, n: int, device: torch.device) -> None:
    if t.ndim != 1 or t.numel() != n or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{what}: expected ({n},) {dtype}, got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if n > 1 and t.stride(0) != 1:
        raise ValueError(f"{what}: must be contiguous")


def quantize_into(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Quantize ``x`` ((n,) f32, bf16 or f16) as if zero-padded to
    ``q.numel()`` elements: ``q`` ((n_blocks·256,) int8) and ``scale``
    ((n_blocks,) f32) are written in place. CPU tensors take the plain
    version."""
    global quantize_launches
    n_blocks = scale.numel()
    if x.dtype not in _DTYPE_CODES or x.ndim != 1 or x.numel() > n_blocks * QBLOCK:
        raise ValueError(f"quantize: x must be (n <= {n_blocks * QBLOCK},) f32/bf16/f16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    _check_1d(x, "quantize x", None, x.numel(), x.device)
    _check_1d(q, "quantize q", torch.int8, n_blocks * QBLOCK, x.device)
    _check_1d(scale, "quantize scale", torch.float32, n_blocks, x.device)
    if n_blocks == 0:
        return
    if _build.device_kind(x) == "cpu":
        xp = x.new_zeros(n_blocks * QBLOCK)
        xp[: x.numel()] = x
        qr, sr = ref.quantize_blockwise(xp, QBLOCK)
        q.copy_(qr)
        scale.copy_(sr)
        return
    if q.data_ptr() % 4:
        raise ValueError("quantize: q must be 4-byte aligned")
    with torch.cuda.device(x.device):
        _build.call("quantize", x.data_ptr(), _DTYPE_CODES[x.dtype], x.numel(), n_blocks,
                    q.data_ptr(), scale.data_ptr(), _build.stream_of(x.device))
    quantize_launches += 1


def dequantize_into(q: torch.Tensor, scale: torch.Tensor, out: torch.Tensor) -> None:
    """``out = q · scale[block]`` for (n_blocks·256,) int8 codes, (n_blocks,)
    f32 scales and a (n_blocks·256,) f32 ``out``. CPU tensors take the plain
    version."""
    global dequantize_launches
    n_blocks = scale.numel()
    _check_1d(q, "dequantize q", torch.int8, n_blocks * QBLOCK, q.device)
    _check_1d(scale, "dequantize scale", torch.float32, n_blocks, q.device)
    _check_1d(out, "dequantize out", torch.float32, n_blocks * QBLOCK, q.device)
    if n_blocks == 0:
        return
    if _build.device_kind(q) == "cpu":
        out.copy_(ref.dequantize_blockwise(q, scale))
        return
    if out.data_ptr() % 16:
        raise ValueError("dequantize: out must be 16-byte aligned")
    with torch.cuda.device(q.device):
        _build.call("dequantize", q.data_ptr(), scale.data_ptr(), n_blocks, out.data_ptr(),
                    _build.stream_of(q.device))
    dequantize_launches += 1
