"""Deterministic synthetic data (``synthetic``)."""
