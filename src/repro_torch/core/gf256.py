"""GF(2^8) host maths for the Reed-Solomon codec (polynomial 0x11D).

The subset of ``repro.core.gf256`` the device tier needs, copied: the
log/antilog tables, scalar ``gf_mul``/``gf_inv``, the Cauchy generator, the
Gaussian solve over small coefficient matrices, and the erasure decode
matrix that folds the solve into one generator row per lost shard. Only the
table path is carried over: every call here works on matrices of at most a
few hundred bytes, and the byte passes run on the device kernels.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, the standard RS(255) polynomial
_ORDER = 255

# Sentinel scheme: LOG32[0] = 512 and EXP_TABLE[510:] = 0, so any product with
# a zero operand indexes into the zero tail; nonzero log sums stay below 509.
_LOG_ZERO = 512


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2048, np.uint8)
    log = np.full(256, _LOG_ZERO, np.int32)
    x = 1
    for i in range(_ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[_ORDER : 2 * _ORDER] = exp[:_ORDER]  # wrap: α^(i+255) = α^i
    return exp, log


EXP_TABLE, LOG32 = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar product in GF(2^8)."""
    return int(EXP_TABLE[LOG32[a] + LOG32[b]])


def gf_inv(a: int) -> int:
    assert a != 0, "zero has no inverse in GF(2^8)"
    return int(EXP_TABLE[_ORDER - int(LOG32[a])])


def gf_mul_bytes(c: int, buf: np.ndarray) -> np.ndarray:
    """Vectorized c · buf over GF(2^8): two table gathers + an int add."""
    assert buf.dtype == np.uint8
    if c == 0:
        return np.zeros_like(buf)
    if c == 1:
        return buf.copy()
    return EXP_TABLE[LOG32[buf] + int(LOG32[c])]


def cauchy_matrix(m: int, k: int) -> np.ndarray:
    """(m, k) Cauchy generator: C[j][i] = (x_j ⊕ y_i)^-1, x_j = j, y_i = m+i.

    Every square submatrix of C, and of the systematic stack [I_k ; C], is
    invertible: the any-m-erasures guarantee.
    """
    assert m >= 1 and k >= 1 and m + k <= 256, (m, k)
    out = np.zeros((m, k), np.uint8)
    for j in range(m):
        for i in range(k):
            out[j, i] = gf_inv(j ^ (m + i))
    return out


def solve_gf(A: np.ndarray, rhs: list[np.ndarray]) -> list[np.ndarray]:
    """Solve A·x = rhs over GF(2^8) by Gaussian elimination (A is (e, e))."""
    e = A.shape[0]
    A = A.astype(np.uint8).copy()
    rhs = [r.copy() for r in rhs]
    for col in range(e):
        piv = next((r for r in range(col, e) if A[r, col]), -1)
        if piv < 0:
            raise ValueError(f"singular GF(2^8) system (pivot column {col})")
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
            rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = gf_inv(int(A[col, col]))
        if inv != 1:
            A[col] = gf_mul_bytes(inv, A[col])
            rhs[col] = gf_mul_bytes(inv, rhs[col])
        for r in range(e):
            c = int(A[r, col])
            if r == col or c == 0:
                continue
            A[r] ^= gf_mul_bytes(c, A[col])
            rhs[r] ^= gf_mul_bytes(c, rhs[col])
    return rhs


def gf_matrix_inverse(A: np.ndarray) -> np.ndarray:
    """Inverse of an invertible (e, e) GF(2^8) matrix."""
    e = A.shape[0]
    eye = np.eye(e, dtype=np.uint8)
    return np.stack(solve_gf(A, [eye[r] for r in range(e)]))


def erasure_decode_matrix(
    k: int,
    coef: np.ndarray,
    present_idx: list[int],
    blob_rows: list[int],
    missing: list[int],
) -> np.ndarray:
    """One GF(2^8) row per lost shard over ``[data_0..data_{k-1}, blob_0..]``.

    With W the inverse of ``coef[blob_rows][:, missing]``:
    D[t, k + j] = W[t, j] and D[t, s] = ⊕_j W[t, j]·coef[j, s] for present s.
    Columns of missing data shards and unused blobs stay zero.
    """
    e = len(missing)
    m = coef.shape[0]
    assert len(blob_rows) == e, (blob_rows, missing)
    D = np.zeros((e, k + m), np.uint8)
    if e == 0:
        return D
    A = coef[np.ix_(blob_rows, missing)].astype(np.uint8)
    W = gf_matrix_inverse(A)
    for t in range(e):
        for jj, j in enumerate(blob_rows):
            w = int(W[t, jj])
            D[t, k + j] = w
            for s in present_idx:
                D[t, s] ^= gf_mul(w, int(coef[j, s]))
    return D
