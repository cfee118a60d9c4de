"""Checkpoint core: integrity, distribution, GF(2^8) maths, device tier."""
