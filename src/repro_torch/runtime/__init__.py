"""Distributed runtime: train state as checkpoint entities (``state``)."""
