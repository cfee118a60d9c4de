"""Observability: the span tracer, the metrics registry and the event
journal (copied from ``repro.obs``)."""
