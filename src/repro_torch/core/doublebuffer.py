"""The paper's double-buffer snapshot model (§5.2.1 "Resilient Checkpointing",
Algorithm 2).

Invariant: ``read_only`` always holds the last checkpoint that passed the
handshake. New snapshots land in ``writable``; only after a successful global
handshake are the buffers swapped — a pure pointer swap with no copying and no
communication, so a fault can never leave the system without a valid
checkpoint.
"""

from __future__ import annotations

from typing import Any


class DoubleBuffer:
    __slots__ = ("name", "_writable", "_read_only", "generation")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._writable: Any = None
        self._read_only: Any = None
        self.generation = 0  # number of successful swaps

    @property
    def valid(self) -> bool:
        return self._read_only is not None

    @property
    def read_only(self) -> Any:
        return self._read_only

    @property
    def writable(self) -> Any:
        return self._writable

    def write(self, payload: Any) -> None:
        """Write a new snapshot into the writable buffer. The read-only buffer
        is untouched (it must stay restorable throughout)."""
        self._writable = payload

    def swap(self) -> None:
        """Pointer swap: writable becomes the new valid checkpoint; the former
        read-only buffer becomes writable scratch for the next snapshot."""
        if self._writable is None:
            raise RuntimeError(f"DoubleBuffer {self.name}: nothing written to swap")
        self._writable, self._read_only = self._read_only, self._writable
        self.generation += 1

    def discard_writable(self) -> None:
        self._writable = None
