"""Medusa tree buffers, candidates and greedy acceptance (counterpart of
``neuronx_distributed_tpu/utils/medusa.py``).

A Medusa tree is defined by ``choices``: each entry is a path of per-head
top-k picks, e.g. ``(0,)`` = head-1's best, ``(0, 1)`` = head-2's 2nd-best
following head-1's best. :func:`generate_medusa_buffers` is the JAX
module's numpy code, copied (the port imports nothing of the JAX package),
so both build identical arrays:

* ``attn_mask`` — tree attention: each node attends its ancestors + root;
* ``tree_indices`` — gather map from the flattened [base, head1 top-k,
  head2 top-k, ...] candidate pool into tree nodes;
* ``position_ids`` — node depth (RoPE offsets relative to the current pos);
* ``retrieve_indices`` — per-leaf root→leaf node chains for reading
  candidate continuations back out.

:func:`generate_candidates` and :func:`evaluate_posterior_greedy` are the
JAX functions in torch ops; they read nothing on the host, so a captured
Medusa round runs them. They take the buffers as numpy arrays or as tensors
already on the logits' device (:func:`medusa_buffers_on`): a round captured
in a CUDA graph must not upload them.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def generate_medusa_buffers(
    choices: Sequence[Tuple[int, ...]], top_k: int = 10
) -> Dict[str, np.ndarray]:
    """Build static tree buffers from the choice paths (JAX
    ``generate_medusa_buffers``, ``utils/medusa.py:27``)."""
    paths = sorted(set(tuple(c) for c in choices), key=lambda p: (len(p), p))
    if not paths:
        raise ValueError("medusa choices must be non-empty")
    max_depth = max(len(p) for p in paths)
    if any(pick >= top_k for p in paths for pick in p):
        raise ValueError(f"choice index exceeds top_k={top_k}")
    n = len(paths) + 1  # + root
    node_of: Dict[Tuple[int, ...], int] = {(): 0}
    for i, p in enumerate(paths):
        if p[:-1] not in node_of:
            raise ValueError(f"choice {p} missing its parent prefix {p[:-1]}")
        node_of[p] = i + 1

    attn_mask = np.zeros((n, n), dtype=bool)
    position_ids = np.zeros((n,), dtype=np.int32)
    tree_indices = np.zeros((n,), dtype=np.int32)
    attn_mask[:, 0] = True  # everyone sees the root
    for p, i in node_of.items():
        attn_mask[i, i] = True
        position_ids[i] = len(p)
        if p:
            # flattened pool: [base] + top_k picks per head, depth-major
            tree_indices[i] = 1 + (len(p) - 1) * top_k + p[-1]
            for d in range(1, len(p)):
                attn_mask[i, node_of[p[:d]]] = True

    leaves = [p for p in paths if not any(q[: len(p)] == p and q != p for q in paths)]
    retrieve = np.full((len(leaves), max_depth + 1), -1, dtype=np.int32)
    for li, leaf in enumerate(sorted(leaves)):
        chain = [node_of[leaf[:d]] for d in range(len(leaf) + 1)]
        retrieve[li, : len(chain)] = chain
    return {
        "attn_mask": attn_mask,
        "tree_indices": tree_indices,
        "position_ids": position_ids,
        "retrieve_indices": retrieve,
        "top_k": top_k,
    }


def medusa_buffers_on(buffers: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The buffers as tensors on ``device`` (int64 indices, bool mask);
    ``top_k`` stays an int."""
    out = {"top_k": int(buffers["top_k"])}
    for name in ("tree_indices", "position_ids", "retrieve_indices"):
        out[name] = torch.as_tensor(np.asarray(buffers[name], np.int64), device=device)
    out["attn_mask"] = torch.as_tensor(np.asarray(buffers["attn_mask"], bool), device=device)
    return out


def generate_candidates(
    base_token: torch.Tensor,
    medusa_logits: torch.Tensor,
    buffers: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten [base, per-head top-k] and gather tree + per-leaf candidate
    sequences (JAX ``generate_candidates``, ``utils/medusa.py:72``).

    ``base_token`` (B,) int; ``medusa_logits`` (B, heads, V). Returns
    ``tree_tokens (B, n_nodes)`` and ``candidates (B, leaves, depth+1)``
    (−1-padded positions carry the base token), int64."""
    dev = medusa_logits.device
    _, topk_ids = torch.topk(medusa_logits, buffers["top_k"], dim=-1)  # (B, heads, k)
    b = base_token.shape[0]
    pool = torch.cat([base_token.to(torch.int64)[:, None], topk_ids.reshape(b, -1)], dim=1)
    tree_tokens = pool[:, torch.as_tensor(buffers["tree_indices"], device=dev).long()]
    retrieve = torch.as_tensor(buffers["retrieve_indices"], device=dev).long()  # (L, D+1)
    cands = tree_tokens[:, torch.clamp(retrieve, min=0)]
    cands = torch.where((retrieve >= 0)[None], cands, tree_tokens[:, :1, None])
    return tree_tokens, cands


def evaluate_posterior_greedy(
    verify_logits: torch.Tensor,
    candidates: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance (JAX ``evaluate_posterior_greedy``,
    ``utils/medusa.py:96``): ``verify_logits (B, leaves, depth+1, V)`` —
    target logits at each node of each candidate chain; ``candidates (B,
    leaves, depth+1)``. Returns ``(best_leaf (B,), accept_len (B,))``,
    int64: the leaf with the longest accepted prefix (candidate[d+1] ==
    argmax(logits[d])) and that prefix's length. ``torch.argmax`` takes the
    first maximum, as ``jnp.argmax`` does."""
    preds = torch.argmax(verify_logits, dim=-1)  # (B, L, D+1)
    matches = candidates[..., 1:] == preds[..., :-1]  # (B, L, D)
    lens = torch.cumprod(matches.to(torch.int64), dim=-1).sum(-1)  # (B, L)
    best = torch.argmax(lens, dim=-1)
    return best, lens.gather(1, best[:, None])[:, 0]
