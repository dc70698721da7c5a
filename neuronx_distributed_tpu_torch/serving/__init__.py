"""Continuous-batching serving (counterpart of
``neuronx_distributed_tpu/serving``, its row-layout FIFO core)."""
