"""Distributed runtime: train state as checkpoint entities (``state``), the
virtual cluster (``cluster``) and fault injection (``failures``)."""
