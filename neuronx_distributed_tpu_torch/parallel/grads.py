"""Global gradient norm and clipping (counterpart of
``neuronx_distributed_tpu/parallel/grads.py``, one device).

``global_grad_norm``/``clip_grad_norm`` (``grads.py:23,34``): the L2 norm
over every leaf in f32, and a scale ``min(1, max_norm / (norm + eps))``
with ``eps = 1e-6``; the pre-clip norm is returned. JAX returns new
gradients; the port scales the gradient tensors in place.
"""

from __future__ import annotations

from typing import Sequence

import torch


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient, computed in f32 (a 0-d tensor on the
    gradients' device)."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads]
    return torch.sqrt(torch.stack(sq).sum())


def clip_grad_norm(grads: Sequence[torch.Tensor], max_norm: float,
                   eps: float = 1e-6) -> torch.Tensor:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns the pre-clip norm. No host read: the scale stays
    a device tensor."""
    norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / (norm + eps), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
