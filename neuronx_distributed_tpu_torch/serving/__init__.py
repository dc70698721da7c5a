"""Continuous-batching serving (counterpart of
``neuronx_distributed_tpu/serving``: the engine over row or paged caches,
the prefix cache, the host page tier (``tiering.py``), the fault
contract, the scheduling policies (``sched/``) and the seeded traffic
replay (``traffic.py``))."""

from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache, PrefixEntry

__all__ = ["PrefixCache", "PrefixEntry"]
