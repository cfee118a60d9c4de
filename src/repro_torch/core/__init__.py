"""Checkpoint core: the host-tier engine (serialization, host stores,
codecs, Algorithm 2 create and Algorithm 4 restore), integrity,
distribution, GF(2^8) maths and the device tier."""
