"""Token shuffling (counterpart of
``neuronx_distributed_tpu/modules/moe/token_shuffling.py``). JAX draws the
permutation from a ``jax.random`` key, which torch cannot reproduce; here it
comes from an explicit ``torch.Generator`` on the tokens' device (ROADMAP
§3)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def shuffle_tokens(x: torch.Tensor, generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random permutation of dim 0: ``(shuffled, perm)``; keep ``perm``
    for :func:`unshuffle_tokens`."""
    perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    return x[perm], perm


def unshuffle_tokens(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`shuffle_tokens` (JAX ``unshuffle_tokens``,
    ``token_shuffling.py:26``)."""
    return x[torch.argsort(perm)]
