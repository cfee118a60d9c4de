"""The handshake checksum (Algorithm 2) on the host.

``np_checksum``, ``np_tree_checksum`` and ``IntegrityError`` are copied from
``repro.core.integrity`` unchanged. ``np_checksum`` does in numpy what the
CUDA checksum kernel (``kernels/checksum.py``) does on the card, so a device
checksum can be checked against the staged host bytes.
"""

from __future__ import annotations

import numpy as np

#: grow-only cache of the weighted-sum coefficients 1..n (uint32). Replaced
#: atomically under the GIL with a strictly larger array, so a concurrent
#: reader that validated its length against the old array can safely slice
#: either one — the restore VERIFY stage calls np_checksum from pool threads.
_WEIGHTS = np.arange(1, (1 << 16) + 1, dtype=np.uint32)


def np_checksum(buf: np.ndarray) -> tuple[int, int]:
    """Fletcher-style dual checksum over a byte buffer (matches kernels.ref).

    s2 = Σ u_i·i is an integer dot product against cached weights rather
    than a fresh ``arange`` + product temporary per call: the weighted sum
    wraps mod 2^64 inside the dot and is masked to the low 32 bits, which
    agrees exactly with uint32 wraparound — bit-identical to the naive form
    at ~4x the throughput, and allocation-free on the restore-chunk VERIFY
    hot path."""
    global _WEIGHTS
    raw = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    pad = (-raw.nbytes) % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    u = raw.view(np.uint32)
    n = u.shape[0]
    w = _WEIGHTS
    if n > w.shape[0]:
        w = _WEIGHTS = np.arange(
            1, (1 << (n - 1).bit_length()) + 1, dtype=np.uint32
        )
    with np.errstate(over="ignore"):
        s1 = int(np.sum(u, dtype=np.uint32))
        s2 = int(np.dot(u, w[:n])) & 0xFFFFFFFF
    return s1, s2


def np_tree_checksum(leaves: list[np.ndarray]) -> tuple[int, int]:
    """The order-sensitive mix ``acc = acc·1000003 + c_i·(i+1)`` mod 2^32 of
    each leaf's ``np_checksum`` (``kernels.ops.tree_checksum`` on the host)."""
    acc1, acc2 = 0, 0
    for i, leaf in enumerate(leaves):
        c1, c2 = np_checksum(leaf)
        acc1 = (acc1 * 1000003 + c1 * (i + 1)) & 0xFFFFFFFF
        acc2 = (acc2 * 1000003 + c2 * (i + 1)) & 0xFFFFFFFF
    return acc1, acc2


class IntegrityError(RuntimeError):
    """A snapshot failed checksum validation during the handshake."""
