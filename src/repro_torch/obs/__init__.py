"""Observability: the span tracer (copied from ``repro.obs``)."""
