"""Serving observability (counterpart of
``neuronx_distributed_tpu/observability``: the speculative acceptance
recorder; the metrics registry waits for a later slice)."""
