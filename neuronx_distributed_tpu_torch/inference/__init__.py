"""KV-cache generation (counterpart of ``neuronx_distributed_tpu/inference``)."""
