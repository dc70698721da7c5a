"""Weight-only int8/fp8 serving quantization (counterpart of
``neuronx_distributed_tpu/quantization/``: the serving subset)."""
