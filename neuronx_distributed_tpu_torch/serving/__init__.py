"""Continuous-batching serving (counterpart of
``neuronx_distributed_tpu/serving``: its FIFO core over row or paged
caches, and the prefix cache)."""

from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache, PrefixEntry

__all__ = ["PrefixCache", "PrefixEntry"]
