"""Bit-slice primitives and the BGPP query precompute (PyTorch)."""
