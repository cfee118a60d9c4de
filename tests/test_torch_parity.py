"""The port's XOR-parity primitives against the JAX package's, byte for byte
(mirrors tests/test_parity.py): ``encode_parity`` over ragged and
misaligned buffers, ``reconstruct`` of any member, the stripe convention,
and the device-tier encodes (B2 ``device_encode_parity``, B3
``device_rs_encode``) on CPU tensors, where their wrappers run the plain
versions. Tolerance: exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import gf256 as jgf
from repro.core import parity as jpar
from repro_torch.core import gf256
from repro_torch.core import parity as tpar

CASES = [(g, n, seed) for seed, (g, n) in enumerate([(2, 1), (2, 4000), (3, 1001), (4, 7), (5, 2048), (6, 3333)])]


def _bufs(g: int, n: int, seed: int, ragged: bool = False) -> list[np.ndarray]:
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, size=max(1, n - (7 * i if ragged else 0)), dtype=np.uint8) for i in range(g)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


@pytest.mark.parametrize("g,n,seed", CASES)
@pytest.mark.parametrize("ragged", [False, True])
def test_parity_matches_and_reconstructs_any_member(g, n, seed, ragged):
    bufs = _bufs(g, n, seed, ragged)
    parity = tpar.encode_parity([_t(b) for b in bufs])
    assert parity.dtype == torch.uint8 and parity.numel() == tpar.parity_nbytes(bufs) == jpar.parity_nbytes(bufs)
    assert np.array_equal(parity.numpy(), jpar.encode_parity(bufs))
    for missing in range(g):
        survivors = [_t(b) for i, b in enumerate(bufs) if i != missing]
        rebuilt = tpar.reconstruct(survivors, parity)
        assert np.array_equal(rebuilt.numpy(), jpar.reconstruct([b for i, b in enumerate(bufs) if i != missing],
                                                               jpar.encode_parity(bufs)))
        assert np.array_equal(rebuilt[: bufs[missing].nbytes].numpy(), bufs[missing])


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_misaligned_slices_and_a_reused_accumulator(offset):
    """Slices that start off the word grid, into a leased accumulator that
    holds garbage (zeroed by the encode)."""
    base = np.random.default_rng(offset).integers(0, 256, size=5000, dtype=np.uint8)
    bufs = [base[offset + 10 * i : offset + 10 * i + 1203 + i] for i in range(3)]
    out = torch.full((tpar.parity_nbytes(bufs),), 0xAB, dtype=torch.uint8)
    got = tpar.encode_parity([_t(b) for b in bufs], out=out)
    assert got is out and np.array_equal(out.numpy(), jpar.encode_parity(bufs))


@pytest.mark.parametrize("g", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [1, 7, 1000, 1027])
def test_stripes_match_the_reference_and_roundtrip(g, n):
    parity = np.random.default_rng(g * n).integers(0, 256, size=n, dtype=np.uint8)
    assert tpar.stripe_bounds(n, g) == jpar.stripe_bounds(n, g)
    stripes = tpar.split_stripes(_t(parity), g)
    assert [s.numpy().tobytes() for s in stripes] == [s.tobytes() for s in jpar.split_stripes(parity, g)]
    assert np.array_equal(tpar.join_stripes(stripes).numpy(), parity)


def test_unequal_lengths_padded():
    bufs = [np.arange(10, dtype=np.uint8), np.arange(7, dtype=np.uint8)]
    parity = tpar.encode_parity([_t(b) for b in bufs])
    assert np.array_equal(tpar.reconstruct([_t(bufs[0])], parity)[:7].numpy(), bufs[1])


def test_device_encodes_match_the_host_on_cpu_tensors():
    """B2 and B3 through their wrappers (the plain versions on CPU tensors):
    the host parity and RS blobs over the same bytes."""
    r = np.random.default_rng(1)
    a = r.standard_normal(1000).astype(np.float32)
    b = r.standard_normal(999).astype(np.float32)
    host = jpar.encode_parity([a.view(np.uint8), b.view(np.uint8)])
    dev = tpar.device_encode_parity([_t(a), _t(b)])
    assert dev.dtype == torch.uint8 and np.array_equal(dev.numpy()[: host.nbytes], host[: dev.numel()])
    coef = gf256.cauchy_matrix(2, 2)
    blobs = gf256.device_rs_encode([_t(a), _t(b)], coef)
    want = jgf.rs_encode([a.view(np.uint8), b.view(np.uint8)], 2, coef)
    assert [x.numpy().tobytes() for x in blobs] == [w.tobytes() for w in want]
