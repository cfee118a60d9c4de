"""GF(2^8) arithmetic and Reed-Solomon erasure coding, host tier (port of
``repro.core.gf256``, polynomial 0x11D).

The m×k generator is a Cauchy matrix (every square submatrix invertible:
any m losses per group decode). Field arithmetic runs through log/antilog
tables with the zero operand folded into a sentinel log.

The hot byte passes (``rs_encode``, ``rs_decode``, ``gf_addmul_fast`` and
the codec layer's chunked encode and decode) all dispatch through ONE
primitive, :func:`gf_matrix_addmul_into`, with three bit-identical backends:

  * ``table`` — per-coefficient 256-entry product-table gathers (numpy), the
    oracle;
  * ``swar``  — carry-free xtime chains over uint64 words (numpy), 8 field
    bytes per operation;
  * ``torch`` — the runtime-matrix product kernel B4 (``kernels/rs_decode``)
    on the device of the engine that calls it (:func:`compute_device`; the
    card unless the caller asked for the CPU, where the wrapper runs its
    plain version). Each call stages the sources' ``[lo, hi)`` bytes into
    per-thread device buffers, zero-padded to whole uint32 words, launches
    B4 once per slice of at most 16 sources and 8 outputs on the caller's
    current stream, copies the outputs back and waits for that stream.

A one-time probe (``_probe_backends``) times each backend on a k=4, m=2
product and the fastest wins, ``torch`` timed on the card when there is one
(a build or launch failure there propagates); ``REPRO_GF_BACKEND`` or
:func:`set_backend` overrides it. Buffers are 1-D uint8: numpy arrays or CPU
``torch.uint8`` tensors (the engine's arenas, pinned when it runs on the
card).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

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


def _as_np(x: Any) -> np.ndarray:
    """A 1-D uint8 buffer as numpy: CPU tensors by view."""
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _nbytes(x: Any) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else x.nbytes


def gf_addmul_into(acc: np.ndarray, c: int, buf: np.ndarray) -> None:
    """acc ^= c · buf, XORing over the common prefix only (ragged tails)."""
    n = min(acc.shape[0], buf.shape[0])
    if c == 0 or n == 0:
        return
    if c == 1:
        acc[:n] ^= buf[:n]
    else:
        acc[:n] ^= EXP_TABLE[LOG32[buf[:n]] + int(LOG32[c])]


_MUL_TABLES: dict[int, np.ndarray] = {}
_MUL_TABLES_LOCK = threading.Lock()


def mul_table(c: int) -> np.ndarray:
    """The 256-entry product table of a fixed coefficient: ``T[x] = c·x``,
    cached per coefficient (at most 256 entries, lock-guarded: worker
    threads populate it concurrently)."""
    c = int(c) & 0xFF
    t = _MUL_TABLES.get(c)  # racy read is safe: values are write-once
    if t is None:
        with _MUL_TABLES_LOCK:
            t = _MUL_TABLES.get(c)
            if t is None:
                t = gf_mul_bytes(c, np.arange(256, dtype=np.uint8))
                _MUL_TABLES[c] = t
    return t


def gf_addmul_table_into(acc: np.ndarray, table: np.ndarray, buf: np.ndarray) -> None:
    """acc ^= T[buf] over the common prefix (T from :func:`mul_table`)."""
    n = min(acc.shape[0], buf.shape[0])
    if n:
        np.bitwise_xor(acc[:n], table[buf[:n]], out=acc[:n])


#: below this byte count a backend round trip cannot beat the direct table
#: gather for a single addmul term
_ADDMUL_BACKEND_MIN = 1 << 15


def gf_addmul_fast(acc: np.ndarray, c: int, buf: np.ndarray) -> None:
    """acc ^= c · buf through the active GF backend: large buffers as a 1×1
    product, small ones (and the ``table`` backend) by the product table."""
    if c == 0:
        return
    n = min(acc.shape[0], buf.shape[0])
    if n == 0:
        return
    if c == 1:
        acc[:n] ^= buf[:n]
        return
    backend = _active_backend()
    if backend.name != "table" and n >= _ADDMUL_BACKEND_MIN:
        backend.matrix_into([acc], [buf], ((int(c),),), 0, n, accumulate=True)
        return
    gf_addmul_table_into(acc, mul_table(c), buf)


def gf_mul_fast(c: int, buf: np.ndarray) -> np.ndarray:
    """c · buf through the product table."""
    if c == 0:
        return np.zeros_like(buf)
    if c == 1:
        return buf.copy()
    return mul_table(c)[buf]


# ---------------------------------------------------------------------------
# Pluggable GF(2^8) backends — one matrix primitive, three implementations
# ---------------------------------------------------------------------------

#: SWAR constants: the xtime of 8 packed GF bytes in one uint64 (masking each
#: lane's top bit before the shift keeps carries inside the lane).
_SWAR_HIGH = np.uint64(0x8080808080808080)
_SWAR_POLY = np.uint64(0x1D)
_SWAR_ONE = np.uint64(1)
_SWAR_SEVEN = np.uint64(7)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class _Scratch(threading.local):
    """Per-thread numpy staging buffers (worker threads run concurrently;
    sharing scratch would race). Grow-only per key, rounded to a power of
    two."""

    def __init__(self) -> None:
        self.bufs: dict[str, np.ndarray] = {}

    def u8(self, key: str, nbytes: int) -> np.ndarray:
        buf = self.bufs.get(key)
        if buf is None or buf.nbytes < nbytes:
            buf = np.empty(_next_pow2(max(nbytes, 4096)), np.uint8)
            self.bufs[key] = buf
        return buf[:nbytes]


_SCRATCH = _Scratch()


def _mat_rows(mat) -> tuple[tuple[int, ...], ...]:
    """A coefficient matrix (ndarray or nested sequence) as a hashable
    tuple of tuples of ints."""
    return tuple(tuple(int(c) for c in row) for row in mat)


class _TableBackend:
    """The product-table oracle: per-(row, src) 256-entry gathers."""

    name = "table"

    def matrix_into(self, dsts, srcs, rows, lo, hi, accumulate=False):
        dsts, srcs = [_as_np(d) for d in dsts], [_as_np(s) for s in srcs]
        for t, dst in enumerate(dsts):
            end = min(hi, dst.nbytes)
            if lo >= end:
                continue
            acc = dst[lo:end]
            if not accumulate:
                acc[:] = 0
            row = rows[t]
            for i, src in enumerate(srcs):
                c = row[i]
                if c == 0 or lo >= src.nbytes:
                    continue
                seg = src[lo : min(end, src.nbytes)]
                w = seg.shape[0]
                if c == 1:
                    np.bitwise_xor(acc[:w], seg, out=acc[:w])
                else:
                    np.bitwise_xor(acc[:w], mul_table(c)[seg], out=acc[:w])


class _SwarBackend:
    """Wide-word SWAR over uint64 views, Horner bit-plane form: per output
    row, walk the coefficient bits high→low, xtime the accumulator once per
    step and XOR in every source whose coefficient has that bit. Ragged or
    misaligned segments are staged into zero-padded scratch (a GF no-op)."""

    name = "swar"

    @staticmethod
    def _xtime_inplace(x: np.ndarray, tmp: np.ndarray) -> None:
        np.bitwise_and(x, _SWAR_HIGH, out=tmp)
        np.bitwise_xor(x, tmp, out=x)
        np.left_shift(x, _SWAR_ONE, out=x)
        np.right_shift(tmp, _SWAR_SEVEN, out=tmp)
        np.multiply(tmp, _SWAR_POLY, out=tmp)
        np.bitwise_xor(x, tmp, out=x)

    def matrix_into(self, dsts, srcs, rows, lo, hi, accumulate=False):
        dsts, srcs = [_as_np(d) for d in dsts], [_as_np(s) for s in srcs]
        end = min(hi, max(d.nbytes for d in dsts))
        L = end - lo
        if L <= 0:
            return
        W = (L + 7) // 8
        words: list[np.ndarray | None] = []
        for i, src in enumerate(srcs):
            if lo >= src.nbytes:
                words.append(None)
                continue
            seg = src[lo : min(end, src.nbytes)]
            if seg.nbytes == 8 * W:
                words.append(seg.view(np.uint64))
            else:
                row8 = _SCRATCH.u8(f"swar_src{i}", 8 * W)
                row8[: seg.nbytes] = seg
                row8[seg.nbytes :] = 0
                words.append(row8.view(np.uint64))
        acc8 = _SCRATCH.u8("swar_acc", 8 * W)
        tmp8 = _SCRATCH.u8("swar_tmp", 8 * W)
        acc64, tmp64 = acc8.view(np.uint64), tmp8.view(np.uint64)
        for t, dst in enumerate(dsts):
            dend = min(end, dst.nbytes)
            if lo >= dend:
                continue
            row = rows[t]
            acc: np.ndarray | None = None
            for bit in range(7, -1, -1):
                if acc is not None:
                    self._xtime_inplace(acc, tmp64)
                for i, w in enumerate(words):
                    if w is None or not row[i] >> bit & 1:
                        continue
                    if acc is None:
                        np.copyto(acc64, w)
                        acc = acc64
                    else:
                        np.bitwise_xor(acc, w, out=acc)
            dL = dend - lo
            if acc is None:  # all-zero row
                if not accumulate:
                    dst[lo:dend] = 0
            elif accumulate:
                np.bitwise_xor(dst[lo:dend], acc8[:dL], out=dst[lo:dend])
            else:
                dst[lo:dend] = acc8[:dL]


_DEVICE = threading.local()


@contextlib.contextmanager
def compute_device(device):
    """Run the ``torch`` backend's calls made by this thread inside the
    block on ``device`` (the engine's: its drain and restore workers enter
    this around their codec calls). Outside any block it runs on the card,
    and raises where there is none."""
    prev = getattr(_DEVICE, "device", None)
    _DEVICE.device = torch.device(device)
    try:
        yield
    finally:
        _DEVICE.device = prev


def _compute_device() -> torch.device:
    dev = getattr(_DEVICE, "device", None)
    if dev is None:
        from repro_torch.sharding.mesh import resolve_device

        dev = resolve_device(None)
    return dev


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


class _TorchBackend:
    """The product on a device through B4 (``rs_decode_into``: a runtime
    (m, k) coefficient matrix, so one compiled kernel serves every generator
    and decode matrix). Per call, in pieces of at most ``_MAX_STAGE`` bytes:
    each contributing source's bytes are copied into a row of a per-thread
    device buffer (asynchronous from pinned arenas) and the row's tail
    zeroed to a whole word; one launch per slice of at most ``MAX_K``
    sources and ``MAX_M`` outputs (later source slices XOR into the first
    slice's result); the outputs copied back, and the caller's current
    stream waited on before returning, since a host buffer read before its
    copy lands holds the wrong bytes. On a CPU device the same wrapper runs
    its plain version."""

    name = "torch"
    _MAX_COEFS = 256
    #: bytes of each source row staged at once: a longer range runs in
    #: pieces, which bounds the per-thread device buffers (a sync restore
    #: decodes whole GB-sized shards in one call)
    _MAX_STAGE = 1 << 25

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._coefs: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._local = threading.local()

    def _coef_tensor(self, mat: tuple[tuple[int, ...], ...], device: torch.device) -> torch.Tensor:
        """The (m, k) uint32 matrix on ``device``, cached (LRU)."""
        key = (mat, str(device))
        with self._lock:
            t = self._coefs.get(key)
            if t is not None:
                self._coefs.move_to_end(key)
                return t
        t = torch.tensor(mat, dtype=torch.int32).to(device).view(torch.uint32)
        if device.type == "cuda":
            # another thread may read it on another stream: let the copy land
            torch.cuda.current_stream(device).synchronize()
        with self._lock:
            self._coefs[key] = t
            while len(self._coefs) > self._MAX_COEFS:
                self._coefs.popitem(last=False)
        return t

    def _buffers(self, device: torch.device, k: int, m: int, words: int):
        """This thread's (k, words) source rows and (2m, words) output rows
        (the second m: a later source slice's partial product) on
        ``device``, int32, grown to powers of two."""
        bufs = getattr(self._local, "bufs", None)
        if bufs is None:
            bufs = self._local.bufs = {}
        have = bufs.get(device)
        if have is None or have[0].shape[0] < k or have[1].shape[0] < 2 * m or have[0].shape[1] < words:
            kk = max(k, have[0].shape[0] if have else 0)
            mm = max(2 * m, have[1].shape[0] if have else 0)
            ww = max(_next_pow2(max(words, 1024)), have[0].shape[1] if have else 0)
            have = bufs[device] = (torch.empty((kk, ww), dtype=torch.int32, device=device),
                                   torch.empty((mm, ww), dtype=torch.int32, device=device))
        return have[0][:k, :words], have[1][: 2 * m, :words]

    def matrix_into(self, dsts, srcs, rows, lo, hi, accumulate=False):
        dsts, srcs = [_as_tensor(d) for d in dsts], [_as_tensor(s) for s in srcs]
        end = min(hi, max(d.numel() for d in dsts))
        device = _compute_device()
        for a in range(lo, end, self._MAX_STAGE):
            self._range_into(dsts, srcs, rows, a, min(a + self._MAX_STAGE, end), accumulate, device)

    def _range_into(self, dsts, srcs, rows, lo, end, accumulate, device):
        from repro_torch.kernels import _build
        from repro_torch.kernels import rs_decode as _rsd_k

        L = end - lo
        # 0·x and an empty segment add nothing: only contributing sources travel
        live = [i for i, s in enumerate(srcs) if lo < s.numel() and any(r[i] for r in rows)]
        targets = [t for t, d in enumerate(dsts) if lo < d.numel()]
        if not live:
            if not accumulate:
                for t in targets:
                    dsts[t][lo : min(end, dsts[t].numel())].zero_()
            return
        words = -(-L // 4)
        m = len(targets)
        src_w, out_w = self._buffers(device, len(live), min(m, _build.MAX_M), words)
        for row, i in enumerate(live):
            s, dst = srcs[i], src_w[row].view(torch.uint8)
            nb = min(end, s.numel()) - lo
            dst[:nb].copy_(s[lo : lo + nb], non_blocking=True)
            if nb < 4 * words:
                dst[nb:].zero_()
        for t0 in range(0, m, _build.MAX_M):
            tgt = targets[t0 : t0 + _build.MAX_M]
            mt = len(tgt)
            acc, part = out_w[:mt], out_w[mt : 2 * mt]
            for c0 in range(0, len(live), _build.MAX_K):
                cols = live[c0 : c0 + _build.MAX_K]
                coef = self._coef_tensor(tuple(tuple(rows[t][i] for i in cols) for t in tgt), device)
                ins = [src_w[row].view(torch.uint32) for row in range(c0, c0 + len(cols))]
                outs = acc if c0 == 0 else part
                _rsd_k.rs_decode_into(ins, coef, [r.view(torch.uint32) for r in outs.unbind(0)])
                if c0:
                    acc ^= part
            for j, t in enumerate(tgt):
                d, res = dsts[t], acc[j].view(torch.uint8)
                dL = min(end, d.numel()) - lo
                if accumulate:
                    d[lo : lo + dL] ^= res[:dL].cpu()
                else:
                    d[lo : lo + dL].copy_(res[:dL], non_blocking=True)
            if device.type == "cuda":
                # the copies out land before these rows are reused or read
                torch.cuda.current_stream(device).synchronize()


_TABLE_BACKEND = _TableBackend()
_BACKENDS: dict[str, object] = {"table": _TABLE_BACKEND, "swar": _SwarBackend(), "torch": _TorchBackend()}

#: probe/selection state, guarded by _BACKEND_LOCK; _PROBE_GBPS also seeds
#: the engine's restore and encode planners (core/checkpoint.py)
_BACKEND_LOCK = threading.Lock()
_SELECTED: list = [None]  # [name | None]; list cell so tests can reset
_FORCED: list = [None]
_PROBE_GBPS: dict[str, float] = {}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def get_backend(name: str):
    """A backend implementation by name."""
    return _BACKENDS[name]


def set_backend(name: str | None) -> None:
    """Force a backend; ``None`` returns to probe/env selection. Unknown
    names raise KeyError."""
    if name is not None and name not in _BACKENDS:
        raise KeyError(f"unknown GF backend {name!r}; have {available_backends()}")
    with _BACKEND_LOCK:
        _FORCED[0] = name


def _probe_backends() -> str:
    """Time a k=4, m=2 encode-shaped product over 256 KiB sources with each
    backend (best of 5 after a warm call) and return the fastest. ``torch``
    is timed on the card with pinned sources and outputs, and only where
    there is a card; a failure there propagates (a numpy backend that fails
    just loses the probe)."""
    r = np.random.default_rng(0)
    k, m, L = 4, 2, 1 << 18
    srcs = [r.integers(0, 256, size=L, dtype=np.uint8) for _ in range(k)]
    dsts = [np.empty(L, np.uint8) for _ in range(m)]
    rows = _mat_rows(cauchy_matrix(m, k))

    def best_of(backend, d, s) -> float:
        backend.matrix_into(d, s, rows, 0, L)  # warm (torch: build, first launch)
        dt = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            backend.matrix_into(d, s, rows, 0, L)
            dt = min(dt, time.perf_counter() - t0)
        return dt

    best_name, best_gbps = "table", 0.0
    for name, backend in _BACKENDS.items():
        if name == "torch":
            if not torch.cuda.is_available():
                continue
            from repro_torch.sharding.mesh import resolve_device

            pin = [torch.from_numpy(s).pin_memory() for s in srcs]
            outs = [torch.empty(L, dtype=torch.uint8).pin_memory() for _ in range(m)]
            with compute_device(resolve_device(None)):
                dt = best_of(backend, outs, pin)
        else:
            try:
                dt = best_of(backend, dsts, srcs)
            except Exception:  # a broken numpy backend loses the probe
                continue
        gbps = k * L / max(dt, 1e-9) / 1e9
        _PROBE_GBPS[name] = gbps
        if gbps > best_gbps:
            best_name, best_gbps = name, gbps
    return best_name


def active_backend_name() -> str:
    """The selection order: set_backend > REPRO_GF_BACKEND > probe winner."""
    forced = _FORCED[0]
    if forced is not None:
        return forced
    env = os.environ.get("REPRO_GF_BACKEND", "").strip().lower()
    if env and env in _BACKENDS:
        return env
    if _SELECTED[0] is None:
        with _BACKEND_LOCK:
            if _SELECTED[0] is None:
                _SELECTED[0] = _probe_backends()
    return _SELECTED[0]


def _active_backend():
    return _BACKENDS[active_backend_name()]


def probed_gbps(name: str | None = None, default: float = 1.0) -> float:
    """Measured GB/s of a backend's probe pass (the active backend when
    ``name`` is None): the planners' rate seed before any real encode or
    restore has been measured."""
    name = name or active_backend_name()
    if name not in _PROBE_GBPS:
        with _BACKEND_LOCK:
            if _SELECTED[0] is None:
                _SELECTED[0] = _probe_backends()
    return _PROBE_GBPS.get(name, default)


def gf_matrix_addmul_into(
    dsts: list,
    srcs: list,
    mat,
    lo: int = 0,
    hi: int | None = None,
    accumulate: bool = False,
    backend: str | None = None,
) -> None:
    """The backend primitive: ``dsts[t][lo:hi] (^)= ⊕_i mat[t,i]·srcs[i]``.

    All buffers are 1-D uint8 (numpy or CPU tensors). A source shorter than
    ``hi`` contributes only its prefix (implicit zero padding, a GF no-op).
    ``accumulate=False`` overwrites the destination range, ``True``
    XOR-accumulates into it. ``backend`` pins an implementation; ``None``
    dispatches to the probed/forced selection."""
    if not dsts or hi is not None and hi <= lo:
        return
    if hi is None:
        hi = max(_nbytes(d) for d in dsts)
    impl = _BACKENDS[backend] if backend is not None else _active_backend()
    impl.matrix_into(dsts, srcs, _mat_rows(mat), lo, hi, accumulate)


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


# ---------------------------------------------------------------------------
# Reed-Solomon encode / decode over byte buffers
# ---------------------------------------------------------------------------

def padded_len(bufs: list) -> int:
    """Blob length ``rs_encode`` produces: the 4-aligned max buffer size."""
    n = max(_nbytes(b) for b in bufs)
    return n + (-n) % 4


def rs_encode(
    bufs: list[torch.Tensor],
    m: int,
    coef: np.ndarray | None = None,
    out: list[torch.Tensor] | None = None,
) -> list[torch.Tensor]:
    """k data buffers (ragged lengths ok) -> m parity blobs of the padded
    size, ``blob_j = ⊕_i C[j][i] · data_i`` over each buffer's prefix, as
    ONE :func:`gf_matrix_addmul_into` call through the active backend.
    ``out`` supplies m reusable uint8 accumulators of the padded length."""
    k = len(bufs)
    C = cauchy_matrix(m, k) if coef is None else coef[:, :k]
    n = padded_len(bufs)
    blobs = []
    for j in range(m):
        if out is None:
            acc = torch.empty(n, dtype=torch.uint8)
        else:
            acc = out[j]
            assert acc.dtype == torch.uint8 and acc.numel() == n, (acc.numel(), n)
        blobs.append(acc)
    gf_matrix_addmul_into(blobs, [b.reshape(-1) for b in bufs], C, 0, n)
    return blobs


def rs_decode(
    present: dict[int, torch.Tensor],
    blobs: dict[int, torch.Tensor],
    missing: list[int],
    k: int,
    coef: np.ndarray | None = None,
    m: int | None = None,
) -> dict[int, torch.Tensor]:
    """Rebuild ``missing`` data shards (group-local indices) from survivors
    and any ``len(missing)`` intact parity blobs, through the erasure
    decode matrix: one backend product over [survivors ‖ blobs]. Needs the
    encode-time ``coef`` (or ``m`` to rebuild it). Returns padded buffers;
    raises ValueError if fewer than ``len(missing)`` blobs survive."""
    e = len(missing)
    if e == 0:
        return {}
    if len(blobs) < e:
        raise ValueError(f"need {e} parity blobs to rebuild {e} shards, only {len(blobs)} survive")
    if coef is None:
        assert m is not None, "rs_decode needs the encode-time coef matrix or m"
        coef = cauchy_matrix(m, k)
    rows = sorted(blobs)[:e]
    present_idx = sorted(present)
    D = erasure_decode_matrix(k, coef, present_idx, rows, missing)
    srcs = [present[i].reshape(-1) for i in present_idx] + [blobs[j].reshape(-1) for j in rows]
    mat = [[int(D[t, s]) for s in present_idx] + [int(D[t, k + j]) for j in rows] for t in range(e)]
    n = max(_nbytes(blobs[j]) for j in rows)
    outs = [torch.empty(n, dtype=torch.uint8) for _ in missing]
    gf_matrix_addmul_into(outs, srcs, mat, 0, n)
    return {i: buf for i, buf in zip(missing, outs)}


def device_rs_encode(arrays: list[torch.Tensor], coef: np.ndarray) -> list[torch.Tensor]:
    """Device-tier RS encode of tensors on the card by the GF(2^8) encode
    kernel B3 (``ops.rs_encode_arrays``): one uint8 blob per generator row,
    of the 4-aligned max length, on the arrays' device."""
    from repro_torch.kernels import ops

    out = ops.rs_encode_arrays(list(arrays), _mat_rows(coef))
    return [row.view(torch.uint8) for row in out.view(torch.int32).unbind(0)]
