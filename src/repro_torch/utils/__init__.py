"""Logging helpers (copied from ``repro.utils``)."""
