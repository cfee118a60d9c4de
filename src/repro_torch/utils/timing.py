"""Timers that participate in checkpointing.

The paper explicitly lists timers among the entities that must be snapshot-able
("Others are for instance timers that need to be reset to the timestamp of the
last valid checkpoint", §5.2.1). ``Timer`` therefore implements the
``Snapshottable`` protocol (duck-typed here to avoid an import cycle with
``core.snapshot``): ``snapshot() / restore(snap) / swap()``.

Carried over from ``repro.utils.timing``. A snapshot is a dict of tensors
(the port's engine packs tensors only): ``{"0": total, "1": count}`` as f64
and int64 scalars, the leaf names and dtypes the reference's ``(total,
count)`` tuple packs to, so the engines' manifests compare equal.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass
class Timer:
    """Accumulating wall-clock timer with double-buffered snapshots."""

    name: str
    total: float = 0.0
    count: int = 0
    last: float = 0.0                  # transient (not part of the snapshot)
    _start: float | None = None
    # Optional mirror into a metrics histogram (TimerRegistry.attach_metrics):
    # called (name, seconds) at every stop. Transient, like ``last``.
    _observer: object = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        assert self._start is not None, f"Timer {self.name} not started"
        dt = time.perf_counter() - self._start
        self.total += dt
        self.count += 1
        self.last = dt
        self._start = None
        if self._observer is not None:
            self._observer(self.name, dt)
        return dt

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        if self._start is not None:
            self.stop()

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    # --- Snapshottable protocol -------------------------------------------
    def snapshot(self) -> dict[str, torch.Tensor]:
        return {"0": torch.tensor(self.total, dtype=torch.float64),
                "1": torch.tensor(self.count, dtype=torch.int64)}

    def restore(self, snap) -> None:
        self.total, self.count = float(snap["0"]), int(snap["1"])
        self._start = None


class TimerRegistry:
    """Named timer collection; the whole registry registers as one snapshot entity."""

    def __init__(self) -> None:
        self._timers: dict[str, Timer] = {}
        self._observer = None

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name, _observer=self._observer)
        return self._timers[name]

    def attach_metrics(self, registry) -> None:
        """Mirror every timer stop into ``timer_seconds{name=...}`` of a
        :class:`repro_torch.obs.metrics.MetricsRegistry` — the trainer's step/checkpoint
        timers become Prometheus histograms with zero call-site changes."""
        hist = registry.histogram(
            "timer_seconds", "TimerRegistry stops, by timer name.",
            labelnames=("name",),
        )

        def observe(name: str, dt: float) -> None:
            hist.observe(dt, name=name)

        self._observer = observe
        for t in self._timers.values():
            t._observer = observe

    def snapshot(self):
        return {k: t.snapshot() for k, t in self._timers.items()}

    def restore(self, snap) -> None:
        for k, s in snap.items():
            self(k).restore(s)

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": t.total, "count": t.count, "mean_s": t.mean}
            for k, t in sorted(self._timers.items())
        }
