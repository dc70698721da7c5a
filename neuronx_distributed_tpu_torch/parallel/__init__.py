"""Parallel layers, losses and gradient clipping at tp=1 (the port has no
mesh yet)."""
