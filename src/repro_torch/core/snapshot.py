"""Snapshot registry — the paper's extensible entity model (§5.2.1).

Every restorable entity registers three callbacks: *create snapshot*,
*restore snapshot* and *swap buffers*. "In this way, each entity is
responsible for the snapshot creation of its own data" — the checkpointing
mechanism never interprets entity payloads (they are black boxes), which is
exactly what makes the scheme architecture-agnostic across the ten assigned
model families.

The swap callback is owned by the registry here: entities return snapshot
payloads and the registry keeps them in per-entity ``DoubleBuffer``s, so the
swap is a pure pointer swap (Algorithm 2's "no communication is necessary
here") unless an entity opts into managing its own buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.core.doublebuffer import DoubleBuffer


@runtime_checkable
class Snapshottable(Protocol):
    def snapshot(self) -> Any: ...

    def restore(self, snap: Any) -> None: ...


@dataclass
class _Entry:
    create: Callable[[], Any]
    restore: Callable[[Any], None]
    buffer: DoubleBuffer


class SnapshotRegistry:
    """Ordered collection of snapshot entities (order = serialization order)."""

    def __init__(self) -> None:
        self._entries: dict[str, _Entry] = {}

    # -- registration -------------------------------------------------------
    def register(self, name: str, entity: Snapshottable) -> None:
        self.register_fns(name, entity.snapshot, entity.restore)

    def register_fns(
        self,
        name: str,
        create: Callable[[], Any],
        restore: Callable[[Any], None],
    ) -> None:
        if name in self._entries:
            raise KeyError(f"entity {name!r} already registered")
        self._entries[name] = _Entry(create, restore, DoubleBuffer(name))

    def unregister(self, name: str) -> None:
        self._entries.pop(name)

    def names(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    # -- raw payload access (used by the distributed engine, which owns the
    #    per-rank double buffers itself) -------------------------------------
    def create_payloads(self) -> dict[str, Any]:
        return {name: e.create() for name, e in self._entries.items()}

    def restore_payloads(self, payloads: dict[str, Any]) -> None:
        for name, e in self._entries.items():
            if name not in payloads:
                raise RuntimeError(f"missing payload for entity {name!r}")
            e.restore(payloads[name])

    # -- Algorithm 2 steps ---------------------------------------------------
    def create_all(self) -> dict[str, Any]:
        """Invoke every entity's create callback into its *writable* buffer."""
        out = {}
        for name, e in self._entries.items():
            payload = e.create()
            e.buffer.write(payload)
            out[name] = payload
        return out

    def swap_all(self) -> None:
        """Pointer-swap every double buffer (communication-free; cannot be
        interrupted by a fault — Algorithm 2)."""
        for e in self._entries.values():
            e.buffer.swap()

    def discard_writable(self) -> None:
        """Drop in-flight writable payloads (fault during checkpointing)."""
        for e in self._entries.values():
            e.buffer.discard_writable()

    def restore_all(self) -> None:
        """Restore every entity from its read-only (last valid) buffer."""
        for name, e in self._entries.items():
            if not e.buffer.valid:
                raise RuntimeError(f"no valid checkpoint for entity {name!r}")
            e.restore(e.buffer.read_only)

    # -- introspection -------------------------------------------------------
    @property
    def has_valid_checkpoint(self) -> bool:
        ents = list(self._entries.values())
        return bool(ents) and all(e.buffer.valid for e in ents)

    def read_only_payloads(self) -> dict[str, Any]:
        return {n: e.buffer.read_only for n, e in self._entries.items()}

    def buffers(self) -> dict[str, DoubleBuffer]:
        return {n: e.buffer for n, e in self._entries.items()}
