"""Parallel layers at tp=1 (the port has no mesh yet)."""
