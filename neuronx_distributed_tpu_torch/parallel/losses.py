"""Cross entropy over the vocabulary (counterpart of
``neuronx_distributed_tpu/parallel/losses.py``, tp=1).

``parallel_cross_entropy`` (``losses.py:21``): fp32 upcast, the max
subtracted under ``stop_gradient`` (here ``detach``), and the label logit by
a plain gather — the tp=1 branch of ``_select_label_logit`` (``:57-60``);
the vocabulary is not sharded. Label smoothing has no caller in the port
yet and is not carried.
"""

from __future__ import annotations

import torch


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy. ``logits``: (..., V); ``labels``: (...)
    int. Returns (...) fp32 losses, unreduced."""
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return lse - label_logit
