"""Optimizer substrate: snapshot compression (``grad_compress``)."""
