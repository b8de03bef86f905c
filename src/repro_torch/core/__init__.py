"""Numpy-only core modules the port keeps its own copy of."""
