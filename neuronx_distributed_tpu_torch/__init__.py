"""PyTorch + CUDA port of ``neuronx_distributed_tpu``.

The JAX package beside this one is the reference; this package follows its
layout module for module (``models/llama.py`` here is the counterpart of
``neuronx_distributed_tpu/models/llama.py``, and so on) and imports nothing
of it, nor JAX.

Entry points (model construction, ``generate``, ``ServingEngine``) run on
CUDA unless the caller passes ``device="cpu"``; without a GPU and without
that request they raise instead of drifting to the CPU. The attention
kernels are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use; on CPU tensors their wrappers run the plain PyTorch
versions that sit beside them.
"""

__version__ = "0.1.0"
