"""KV-cache generation (counterpart of ``neuronx_distributed_tpu/inference``),
with the program manifests and warm spawn of ``aot.py``."""
