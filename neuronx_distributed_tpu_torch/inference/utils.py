"""Small helpers shared by the generation loops."""

from __future__ import annotations


def unwrap_logits(out):
    """Model outputs → logits: MoE families return ``(logits, aux_losses)``,
    dense families bare logits."""
    return out[0] if isinstance(out, tuple) else out
