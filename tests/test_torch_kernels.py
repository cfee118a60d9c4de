"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against ``repro.kernels.ops`` (Pallas in interpret mode, as
tests/test_kernels.py runs it) on the same numpy inputs. Exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.gf256 import cauchy_matrix
from repro.core.integrity import np_checksum
from repro.kernels import ops as jops
from repro_torch.core import gf256 as tgf256
from repro_torch.core.integrity import np_checksum as port_np_checksum
from repro_torch.kernels import ops
from repro_torch.kernels import rs_encode as rse
from repro_torch.launch.steps import state_from_numpy, state_to_numpy


def _words(rng, shape) -> np.ndarray:
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w.reshape(-1)[::5] = 0xFFFFFFFF  # all-ones words wrap every sum
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    return state_from_numpy(a, device="cpu")


def _eq(port: torch.Tensor, ref) -> bool:
    a, b = state_to_numpy(port), np.asarray(ref)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("k,n", [(2, 1), (3, 7), (5, 2049), (4, 16387)])
def test_xor_reduce_matches(k, n):
    w = _words(np.random.default_rng(n), (k, n))
    assert _eq(ops.xor_reduce(_t(w)), jops.xor_reduce(jnp.asarray(w)))


@pytest.mark.parametrize("m,k,n", [(1, 1, 3), (2, 3, 1001), (3, 5, 4099)])
def test_gf256_matmul_cauchy_matches(m, k, n):
    w = _words(np.random.default_rng(m * 100 + k), (k, n))
    coefs = tuple(tuple(int(c) for c in row) for row in cauchy_matrix(m, k))
    assert _eq(ops.gf256_matmul(_t(w), coefs), jops.gf256_matmul(jnp.asarray(w), coefs))


def test_gf256_every_coefficient_encode_and_decode():
    """All 256 field elements as coefficients, through the static-generator
    and the runtime-coefficient paths, against the runtime Pallas kernel."""
    rng = np.random.default_rng(5)
    w = _words(rng, (16, 513))
    coefs = np.arange(256, dtype=np.uint32).reshape(16, 16)
    # one output row per call: the reference compiles its runtime-coefficient
    # program once for this shape and serves all sixteen rows
    want = np.concatenate([
        np.asarray(jops.gf256_matmul_dyn(jnp.asarray(w), jnp.asarray(coefs[j : j + 1]))) for j in range(16)
    ])
    for half in range(2):  # the kernels take at most 8 output rows
        block = coefs[8 * half : 8 * half + 8]
        assert _eq(ops.gf256_matmul_dyn(_t(w), _t(block)), want[8 * half : 8 * half + 8])
        rows = tuple(tuple(int(c) for c in r) for r in block)
        assert _eq(ops.gf256_matmul(_t(w), rows), want[8 * half : 8 * half + 8])


def test_all_ones_generator_is_xor():
    w = _words(np.random.default_rng(9), (4, 300))
    ones = ((1, 1, 1, 1),)
    assert _eq(ops.gf256_matmul(_t(w), ones)[0], jops.xor_reduce(jnp.asarray(w)))
    assert _eq(ops.gf256_matmul(_t(w), ones)[0], ops.xor_reduce(_t(w)))


@pytest.mark.parametrize("m,k,n", [(2, 4, 777), (3, 6, 33)])
def test_gf256_matmul_dyn_matches(m, k, n):
    rng = np.random.default_rng(m + k)
    w = _words(rng, (k, n))
    coefs = rng.integers(0, 256, (m, k)).astype(np.uint32)
    assert _eq(ops.gf256_matmul_dyn(_t(w), _t(coefs)), jops.gf256_matmul_dyn(jnp.asarray(w), jnp.asarray(coefs)))


_SPECIAL = {
    "zero_column": [[0, 7, 142, 1], [0, 244, 1, 255]],
    "all_ones": [[1, 1, 1, 1]],
    "zeros_and_ones": [[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0]],
    "all_zeros": [[0, 0, 0, 0], [0, 0, 0, 0]],
    "cauchy": [[142, 244, 71, 167], [244, 142, 167, 71]],
}


def _jax_ref_words(w: np.ndarray, coefs) -> np.ndarray:
    """``repro.kernels.ref``'s table definition on the words' bytes."""
    from repro.kernels import ref as jref

    k, n = w.shape
    out = jref.gf256_matmul(jnp.asarray(w.view(np.uint8).reshape(k, 4 * n)), tuple(map(tuple, coefs)))
    return np.asarray(out).reshape(len(coefs), 4 * n).view(np.uint32)


@pytest.mark.parametrize("name", sorted(_SPECIAL))
def test_gf256_special_matrices_match(name):
    """A zero column, 0/1 matrices, all zeros and the
    rs generator through both plain versions, against the Pallas kernels in
    interpret mode and ``repro.kernels.ref``."""
    coefs = _SPECIAL[name]
    w = _words(np.random.default_rng(len(name)), (4, 1027))
    want = _jax_ref_words(w, coefs)
    assert _eq(ops.gf256_matmul(_t(w), coefs), want)
    assert _eq(ops.gf256_matmul_dyn(_t(w), _t(np.array(coefs, np.uint32))), want)
    assert _eq(ops.gf256_matmul(_t(w), coefs), jops.gf256_matmul(jnp.asarray(w), tuple(map(tuple, coefs))))
    assert _eq(ops.gf256_matmul_dyn(_t(w), _t(np.array(coefs, np.uint32))),
               jops.gf256_matmul_dyn(jnp.asarray(w), jnp.asarray(np.array(coefs, np.uint32))))


@pytest.mark.parametrize("name", sorted(_SPECIAL) + ["every_coefficient"])
def test_encode_generator_expansion(name):
    """B3's host-side operands: term (j, i, s) is coefs[j][i] · α^s (α^s =
    EXP[s] in the reference's tables)."""
    from repro.core.gf256 import EXP_TABLE, gf_mul

    if name == "every_coefficient":  # four (8, 8) generators holding 0..255
        blocks = np.arange(256).reshape(4, 8, 8).tolist()
    else:
        blocks = [_SPECIAL[name]]
    for block in blocks:
        terms = rse.expand_generator(tuple(map(tuple, block)))
        m, k = len(block), len(block[0])
        assert len(terms) == m * k * 8
        for j in range(m):
            for i in range(k):
                for s in range(8):
                    assert terms[(j * k + i) * 8 + s] == gf_mul(block[j][i], int(EXP_TABLE[s]))


@pytest.mark.parametrize("shape,bad", [((9, 4), None), ((2, 17), None), ((2, 4), 256), ((2, 4), -1)])
def test_encode_generator_expansion_rejects(shape, bad):
    coefs = np.ones(shape, np.int64)
    if bad is not None:
        coefs[1, 2] = bad
    with pytest.raises(ValueError):
        rse.expand_generator(tuple(map(tuple, coefs.tolist())))


@pytest.mark.parametrize("header", ["common.cuh", "gf256.cuh"])
def test_library_path_follows_every_header(tmp_path, monkeypatch, header):
    """A changed shared header gives the GF(2^8) libraries a new path, so a
    stale build never loads; an unrelated source leaves it as it was."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.lib_path(n) for n in ("rs_encode", "rs_decode")}
    other = csrc / "xor_parity.cu"
    other.write_bytes(other.read_bytes() + b"\n")
    assert {n: _build.lib_path(n) for n in before} == before
    (csrc / header).write_bytes((csrc / header).read_bytes() + b"\n// changed\n")
    after = {n: _build.lib_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)


def _leaves(rng):
    """f32, bf16 and int8 leaves, byte counts not multiples of 4 included."""
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 128, (7,)).astype(np.int8),
        "i8b": rng.integers(-128, 128, (2, 3)).astype(np.int8),
        "ones": np.full((9,), 0xFFFFFFFF, np.uint32),
    }


@pytest.mark.parametrize("name", ["f32", "bf16", "i8", "i8b", "ones"])
def test_checksum_and_as_u32_match(name):
    a = _leaves(np.random.default_rng(1))[name]
    assert _eq(ops.as_u32(_t(a)), jops.as_u32(jnp.asarray(a)))
    got = ops.checksum(_t(a))
    assert _eq(got, jops.checksum(jnp.asarray(a)))
    assert tuple(int(v) for v in state_to_numpy(got)) == np_checksum(a) == port_np_checksum(a)


@pytest.mark.parametrize("n", [1, 1023, 8193, 100_003])
def test_checksum_lengths_off_the_tile(n):
    w = _words(np.random.default_rng(n), (n,))
    assert _eq(ops.checksum(_t(w)), jops.checksum(jnp.asarray(w)))


def test_tree_checksum_matches():
    tree = _leaves(np.random.default_rng(2))
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    assert _eq(ops.tree_checksum(state_from_numpy(tree, device="cpu")), jops.tree_checksum(jtree))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int8])
def test_encode_decode_arrays_match(dtype):
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(n).astype(dtype) for n in (777, 775, 770)]
    coefs = tuple(tuple(int(c) for c in row) for row in cauchy_matrix(2, 3))
    port = [_t(a) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    assert _eq(ops.xor_encode_arrays(port), jops.xor_encode_arrays(jx))
    blobs = ops.rs_encode_arrays(port, coefs)
    assert _eq(blobs, jops.rs_encode_arrays(jx, coefs))
    dec = np.array([[1, 7], [0, 1], [3, 0]], np.uint32)
    want = jops.rs_decode_arrays(jx[:1] + [np.asarray(blobs[0].view(torch.int32)).view(np.uint32)], jnp.asarray(dec))
    got = ops.rs_decode_arrays(port[:1] + [blobs[0]], _t(dec))
    assert _eq(got, want)


def test_gf256_host_maths_match():
    from repro.core import gf256 as jgf

    assert np.array_equal(tgf256.EXP_TABLE, jgf.EXP_TABLE) and np.array_equal(tgf256.LOG32, jgf.LOG32)
    for m, k in [(1, 1), (2, 4), (3, 8)]:
        assert np.array_equal(tgf256.cauchy_matrix(m, k), jgf.cauchy_matrix(m, k))
    coef = jgf.cauchy_matrix(3, 6)
    for missing in ([0], [1, 4], [0, 2, 5]):
        present = [i for i in range(6) if i not in missing]
        rows = list(range(len(missing)))
        assert np.array_equal(
            tgf256.erasure_decode_matrix(6, coef, present, rows, missing),
            jgf.erasure_decode_matrix(6, coef, present, rows, missing),
        )
