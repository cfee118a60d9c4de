"""Typed metrics registry — counters, gauges, histograms with label sets
(DESIGN.md §13); a copy of ``repro.obs.metrics``, which imports no JAX.

Stdlib-only, thread-safe, engine-local: every ``CheckpointEngine`` owns one
``MetricsRegistry`` and its legacy ``CheckpointStats`` object is a *view*
over it (the flat ``last_*`` fields read/write registry cells, so the two
can never disagree). Servers expose the registry over HTTP as Prometheus
text exposition (``render_prometheus``) or a JSON snapshot (``snapshot``).

Naming conventions (metric name prefixes): ``ckpt_*`` create path,
``restore_*`` recovery path, ``tier_*`` storage ladder, ``journal_*`` event
log. Counters end in ``_total``; durations are ``_seconds``; sizes are
``_bytes``; rates use ``_bytes_per_second`` histograms.

Hot-path discipline: resolve a labeled child once (``metric.labels(...)``)
and call ``inc``/``set``/``observe`` on the child — the per-call cost is one
lock + one float update, no dict building.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable

_INF = float("inf")

#: Default histogram buckets: wide exponential ladder covering microseconds
#: to minutes (seconds metrics) and KB/s to TB/s (rate metrics).
DEFAULT_BUCKETS = tuple(
    b for e in range(-6, 13) for b in (10.0 ** e, 2.5 * 10.0 ** e, 5.0 * 10.0 ** e)
) + (_INF,)


def _labelkey(labelnames: tuple[str, ...], labels: dict[str, Any]) -> tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise KeyError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


class _Child:
    """One (metric, labelset) cell — the handle hot paths hold on to."""

    __slots__ = ("metric", "key")

    def __init__(self, metric: "Metric", key: tuple[str, ...]) -> None:
        self.metric = metric
        self.key = key

    def inc(self, amount: float = 1.0) -> None:
        self.metric._inc(self.key, amount)

    def set(self, value: float) -> None:
        self.metric._set(self.key, value)

    def observe(self, value: float) -> None:
        self.metric._observe(self.key, value)

    def value(self) -> float:
        return self.metric._value(self.key)


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    # -- public API ---------------------------------------------------------
    def labels(self, **labels: Any) -> _Child:
        return _Child(self, _labelkey(self.labelnames, labels))

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._inc(_labelkey(self.labelnames, labels), amount)

    def set(self, value: float, **labels: Any) -> None:
        self._set(_labelkey(self.labelnames, labels), value)

    def value(self, **labels: Any) -> float:
        return self._value(_labelkey(self.labelnames, labels))

    # -- cells --------------------------------------------------------------
    def _inc(self, key: tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def _set(self, key: tuple[str, ...], value: float) -> None:
        with self._lock:
            self._values[key] = float(value)

    def _observe(self, key: tuple[str, ...], value: float) -> None:
        raise TypeError(f"{self.kind} metric {self.name!r} has no observe()")

    def _value(self, key: tuple[str, ...]) -> float:
        with self._lock:
            return self._values.get(key, 0.0)

    # -- export -------------------------------------------------------------
    def _samples(self) -> list[tuple[str, tuple[str, ...], float]]:
        """(suffix, labelvalues, value) rows for exposition."""
        with self._lock:
            return [("", k, v) for k, v in sorted(self._values.items())]

    def snapshot(self) -> Any:
        with self._lock:
            if not self.labelnames:
                return self._values.get((), 0.0)
            return {",".join(k): v for k, v in sorted(self._values.items())}


class Counter(Metric):
    kind = "counter"


class Gauge(Metric):
    kind = "gauge"


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] | None = None,
    ) -> None:
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(set(buckets or DEFAULT_BUCKETS)))
        if not bs or bs[-1] != _INF:
            bs = bs + (_INF,)
        self.buckets = bs
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._ns: dict[tuple[str, ...], int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        self._observe(_labelkey(self.labelnames, labels), value)

    def _observe(self, key: tuple[str, ...], value: float) -> None:
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
                self._sums[key] = 0.0
                self._ns[key] = 0
            # linear scan is fine: bucket count is small and fixed
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            self._sums[key] = self._sums[key] + value
            self._ns[key] += 1

    def _value(self, key: tuple[str, ...]) -> float:
        with self._lock:
            return self._sums.get(key, 0.0)

    def stats(self, **labels: Any) -> dict[str, float]:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            n = self._ns.get(key, 0)
            s = self._sums.get(key, 0.0)
            return {"count": n, "sum": s, "mean": s / n if n else 0.0}

    def _samples(self) -> list[tuple[str, tuple[str, ...], float]]:
        rows: list[tuple[str, tuple[str, ...], float]] = []
        with self._lock:
            for key in sorted(self._counts):
                acc = 0
                for b, c in zip(self.buckets, self._counts[key]):
                    acc += c
                    le = "+Inf" if b == _INF else repr(b)
                    rows.append(("_bucket", key + (le,), float(acc)))
                rows.append(("_sum", key, self._sums[key]))
                rows.append(("_count", key, float(self._ns[key])))
        return rows

    def snapshot(self) -> Any:
        with self._lock:
            out = {}
            for key in sorted(self._counts):
                out[",".join(key) if key else "_"] = {
                    "count": self._ns[key],
                    "sum": self._sums[key],
                }
            return out


class MetricsRegistry:
    """Get-or-create registry of typed metrics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, labelnames: Iterable[str], **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise TypeError(
                    f"metric {name!r} re-registered as {cls.__name__} "
                    f"with labels {tuple(labelnames)} (have {type(m).__name__} "
                    f"{m.labelnames})"
                )
            return m

    def counter(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Iterable[str] = (),
        buckets: Iterable[float] | None = None,
    ) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- exposition ---------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus/OpenMetrics text exposition format 0.0.4."""
        lines: list[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for suffix, labelvalues, value in m._samples():
                names = m.labelnames + (("le",) if suffix == "_bucket" else ())
                if names and labelvalues:
                    pairs = ",".join(
                        f'{n}="{_escape(v)}"' for n, v in zip(names, labelvalues)
                    )
                    lines.append(f"{m.name}{suffix}{{{pairs}}} {_fmt(value)}")
                else:
                    lines.append(f"{m.name}{suffix} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict[str, Any]:
        """JSON-able {name: value | {labelset: value} | histogram summary}."""
        return {m.name: m.snapshot() for m in self.metrics()}


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))
