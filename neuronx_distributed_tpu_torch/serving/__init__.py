"""Continuous-batching serving (counterpart of
``neuronx_distributed_tpu/serving``: the engine over row or paged caches,
the prefix cache, the host page tier (``tiering.py``), the fault
contract, the scheduling policies (``sched/``), the seeded traffic
replay (``traffic.py``), and the fabric: the transport (``transport.py``),
the replica router (``router.py``) and disaggregated prefill
(``disagg.py``))."""

from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache, PrefixEntry
from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer, PrefillWorker
from neuronx_distributed_tpu_torch.serving.faults import InjectedHandoffError
from neuronx_distributed_tpu_torch.serving.paging import ExportedContext, StagedContext
from neuronx_distributed_tpu_torch.serving.router import RID_STRIDE, ReplicaRouter, WatchdogConfig
from neuronx_distributed_tpu_torch.serving.transport import (
    ChaosTransport,
    Envelope,
    InProcessTransport,
    PartitionedError,
    TransportError,
    TransportTimeout,
)

__all__ = [
    "ChaosTransport",
    "DisaggregatedServer",
    "Envelope",
    "ExportedContext",
    "InProcessTransport",
    "InjectedHandoffError",
    "PartitionedError",
    "PrefillWorker",
    "PrefixCache",
    "PrefixEntry",
    "RID_STRIDE",
    "ReplicaRouter",
    "StagedContext",
    "TransportError",
    "TransportTimeout",
    "WatchdogConfig",
]
