"""The port's blockwise int8 quantize/dequantize (the plain versions of the
B5a/B5b kernels, as the wrappers run them on the CPU) and its snapshot
compression against the JAX package's on the same numpy inputs:
``repro.kernels.ops`` with Pallas in interpret mode, as tests/test_kernels.py
runs it, and ``repro.optim.grad_compress``. Tolerance: exact (byte
equality) everywhere."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.serialization import pack_bytes as jpack_bytes
from repro.core.serialization import unpack_bytes as junpack_bytes
from repro.kernels import ops as jops
from repro.optim.grad_compress import compress_tree as jcompress_tree
from repro.optim.grad_compress import decompress_tree as jdecompress_tree
from repro_torch.core.serialization import pack_bytes, unpack_bytes
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qk
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.optim.grad_compress import compress_tree, decompress_tree


def _eq(port: torch.Tensor, ref) -> bool:
    a, b = state_to_numpy(port), np.asarray(ref)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _both(x: np.ndarray):
    return (ops.quantize_blockwise(state_from_numpy(x, device="cpu")),
            jops.quantize_blockwise(jnp.asarray(x)))


# the sizes and scales of tests/test_kernels.py's quantize cases: ragged
# lengths around a block (256) and the reference's 8192-element padding
@pytest.mark.parametrize("n", [1, 255, 256, 8191, 8192, 8193, 40000])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantize_matches_the_reference_with_its_padding(n, scale):
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(np.float32)
    (q, s), (jq, js) = _both(x)
    assert q.numel() == -(-n // 8192) * 8192  # padded like the reference
    assert _eq(q, jq) and _eq(s, js)
    assert _eq(ops.dequantize_blockwise(q, s), jops.dequantize_blockwise(jq, js))


@pytest.mark.parametrize("n", [300, 8192, 20001])
def test_quantize_bf16_input_matches_the_reference(n):
    x = np.random.default_rng(n).standard_normal(n).astype(ml_dtypes.bfloat16)
    (q, s), (jq, js) = _both(x)
    assert _eq(q, jq) and _eq(s, js)


def test_half_steps_round_to_even_and_zero_blocks_get_the_floor():
    """Block 0: max 127, so the scale is 1 and k + 0.5 sits exactly on a
    rounding boundary (half to even); block 1: all zeros (scale 1e-30)."""
    x = np.zeros(8192, np.float32)
    x[0] = 127.0
    x[1:255] = np.arange(254, dtype=np.float32) % 127 - 63 + 0.5
    (q, s), (jq, js) = _both(x)
    assert _eq(q, jq) and _eq(s, js)
    assert float(s[0]) == 1.0 and q[1:5].tolist() == [-62, -62, -60, -60]
    assert float(s[1]) == np.float32(1e-30) and not q[256:512].any()


def test_round_trip_is_within_half_a_step():
    x = np.random.default_rng(1).standard_normal(5000).astype(np.float32)
    q, s = ops.quantize_blockwise(torch.from_numpy(x))
    xd = ops.dequantize_blockwise(q, s)[:5000].numpy()
    step = np.repeat(s.numpy(), 256)[:5000]
    assert np.all(np.abs(xd - x) <= step / 2)


def _mixed_tree():
    rng = np.random.default_rng(4)
    return {
        "f32": rng.standard_normal((3, 100)).astype(np.float32),
        "bf16": rng.standard_normal((2, 500)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal(400).astype(np.float16),
        "f64": rng.standard_normal(300),
        "i32": rng.integers(-9, 9, 1000).astype(np.int32),
        "small": rng.standard_normal(10).astype(np.float32),  # < 256: passed through
        "step": np.asarray(3, np.int64),
    }


def _man(m) -> tuple:
    return (m.names, [tuple(s) for s in m.shapes], m.dtypes, m.offsets, m.total)


def test_compress_tree_packs_like_the_reference():
    """Packed bytes and manifest of the compressed tree, then the tree
    decompressed from those bytes, equal to the reference's. A float64 leaf
    is quantized and restored as float32, as the reference does under JAX's
    default 32-bit mode."""
    tree = _mixed_tree()
    flat, man = pack_bytes(compress_tree(state_from_numpy(tree, device="cpu")))
    jflat, jman = jpack_bytes(jcompress_tree(tree))
    assert _man(man) == _man(jman)
    assert flat.numpy().tobytes() == np.asarray(jflat).tobytes()
    back = decompress_tree(unpack_bytes(flat, man))
    jback = jdecompress_tree(junpack_bytes(jflat, jman))
    for k in tree:
        assert _eq(back[k], jback[k]), k
    assert back["f64"].dtype == torch.float32 and torch.equal(back["small"], torch.from_numpy(tree["small"]))


def test_wrappers_check_their_operands():
    x = torch.zeros(300)
    with pytest.raises(ValueError):
        qk.quantize_into(x, torch.empty(256, dtype=torch.int8), torch.empty(1))  # 300 > 256
    with pytest.raises(ValueError):
        qk.quantize_into(x.double(), torch.empty(512, dtype=torch.int8), torch.empty(2))
    with pytest.raises(ValueError):
        qk.dequantize_into(torch.empty(512, dtype=torch.int8), torch.empty(2), torch.empty(256))
    with pytest.raises(ValueError):
        ops.quantize_blockwise(torch.zeros(4, 4))
