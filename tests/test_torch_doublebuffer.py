"""Algorithm 2's double-buffer invariants on the port
(``repro_torch.core.doublebuffer``, ``repro_torch.core.snapshot``), case for
case with ``tests/test_doublebuffer.py``: each scenario runs on both
packages and asserts what the reference asserts; the observable states
(payloads, generations, the exception raised) are equal (exact)."""

from __future__ import annotations

import pytest

from repro.core import doublebuffer as jdb
from repro.core import snapshot as jsnap
from repro_torch.core import doublebuffer as tdb
from repro_torch.core import snapshot as tsnap

PACKAGES = {"port": (tdb.DoubleBuffer, tsnap.SnapshotRegistry), "reference": (jdb.DoubleBuffer, jsnap.SnapshotRegistry)}


def _both(drive):
    """``drive(DoubleBuffer, SnapshotRegistry)`` on both packages: equal results."""
    out = {name: drive(*classes) for name, classes in PACKAGES.items()}
    assert out["port"] == out["reference"]
    return out["port"]


def _raises(fn) -> str | None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return type(e).__name__
    return None


def test_swap_requires_write():
    def drive(DoubleBuffer, _):
        b = DoubleBuffer("t")
        with pytest.raises(RuntimeError):
            b.swap()
        return _raises(b.swap), b.generation

    assert _both(drive)[0] == "RuntimeError"


def test_read_only_untouched_until_swap():
    def drive(DoubleBuffer, _):
        b = DoubleBuffer("t")
        b.write({"step": 1})
        b.swap()
        seen = [b.read_only]
        b.write({"step": 2})
        # a fault here discards the in-flight write; the valid checkpoint survives
        assert b.read_only == {"step": 1}
        seen.append(b.read_only)
        b.discard_writable()
        assert b.read_only == {"step": 1}
        assert b.writable is None
        return seen, b.read_only, b.writable, b.generation

    _both(drive)


def test_swap_is_pointer_swap():
    def drive(DoubleBuffer, _):
        b = DoubleBuffer("t")
        payload1, payload2 = {"x": 1}, {"x": 2}
        b.write(payload1)
        b.swap()
        b.write(payload2)
        b.swap()
        assert b.read_only is payload2          # no copy
        assert b.writable is payload1           # old buffer recycled
        assert b.generation == 2
        return b.read_only, b.writable, b.generation

    _both(drive)


class _Entity:
    def __init__(self):
        self.value = 0

    def snapshot(self):
        return self.value

    def restore(self, snap):
        self.value = snap


def test_registry_algorithm2_cycle():
    def drive(_, SnapshotRegistry):
        reg = SnapshotRegistry()
        e = _Entity()
        reg.register("e", e)
        e.value = 10
        reg.create_all()
        reg.swap_all()
        e.value = 99
        reg.restore_all()
        assert e.value == 10
        seen = [e.value]
        # fault during the second checkpoint: writable discarded, restore gives gen-1
        e.value = 20
        reg.create_all()
        reg.discard_writable()      # handshake failed
        e.value = 77
        reg.restore_all()
        assert e.value == 10
        return seen + [e.value]

    assert _both(drive) == [10, 10]


def test_registry_duplicate_name():
    def drive(_, SnapshotRegistry):
        reg = SnapshotRegistry()
        reg.register("e", _Entity())
        with pytest.raises(KeyError):
            reg.register("e", _Entity())
        return _raises(lambda: reg.register("e", _Entity()))

    assert _both(drive) == "KeyError"


def test_registry_no_checkpoint_raises():
    def drive(_, SnapshotRegistry):
        reg = SnapshotRegistry()
        reg.register("e", _Entity())
        with pytest.raises(RuntimeError):
            reg.restore_all()
        return _raises(reg.restore_all)

    assert _both(drive) == "RuntimeError"
