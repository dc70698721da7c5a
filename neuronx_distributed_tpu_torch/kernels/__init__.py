"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; ``launches`` on the wrapper counts kernel
launches."""
