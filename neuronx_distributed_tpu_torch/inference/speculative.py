"""Draft-model speculative decoding, solo (counterpart of
``neuronx_distributed_tpu/inference/speculative.py``).

Each round the draft proposes ``gamma`` tokens through its own KV cache; the
target scores the whole window in ONE decode forward (an ``s = gamma`` step
of the cache, K4 with group x gamma rows per kv-head) and accepts the
longest prefix matching its own choices, emitting one corrected token beyond
it. The caches roll back by resetting their write cursors: K/V past the
cursor are masked by position, so nothing is recomputed.

Batching: rows accept prefixes of different lengths, but the caches keep ONE
shared cursor, so every round advances all rows by the BATCH-MIN accepted
length + 1. Rows that accepted more re-draft those tokens next round: wasted
draft work, never a wrong token. Greedy speculative decoding emits exactly
the target's greedy stream whatever the acceptance schedule; the sampled rule
(:func:`~neuronx_distributed_tpu_torch.utils.sampling.speculative_accept`)
keeps every emitted token distributed as the target's.

The round runs eagerly; one host read a round (the accepted lengths) drives
the schedule, as the JAX loop's one readback does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.generate import serving_clones
from neuronx_distributed_tpu_torch.inference.utils import unwrap_logits
from neuronx_distributed_tpu_torch.observability.spec_stats import SpecStats
from neuronx_distributed_tpu_torch.utils.sampling import (
    DRAW_DRAFT,
    greedy,
    sample,
    sample_categorical,
    speculative_accept,
)


def validate_spec_room(models, prompt_len: int, max_new_tokens: int, gamma: int) -> None:
    """The cache-room guard: the last round may score a ``gamma``-token
    window starting ``max_new_tokens - 1`` past the prompt, and a write past
    ``max_seq_len`` would land outside the cache."""
    for m in models:
        max_len = m.config.max_seq_len
        if prompt_len + max_new_tokens + gamma - 1 > max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) + gamma-1 "
                f"({gamma - 1}) exceeds the model's max_seq_len ({max_len})"
            )


@torch.no_grad()
def speculative_generate(target, draft, prompt_ids, max_new_tokens: int, gamma: int = 4,
                         temperature: float = 0.0, seed: Optional[int] = None,
                         stats: Optional[SpecStats] = None,
                         registry=None) -> Tuple[torch.Tensor, float]:
    """Speculative decoding of ``prompt_ids`` (B, S), any batch size, on the
    target's device. ``temperature=0`` is greedy; ``temperature>0`` runs
    the exact speculative-sampling rule per row and needs ``seed`` (as the
    JAX function needs a key): row ``b`` draws the counter-based streams of
    seed ``seed + b``. Returns ``(tokens (B, max_new_tokens) int64,
    mean_accepted)``, the mean over rounds and rows of each row's accepted
    length.

    ``stats`` (a :class:`SpecStats`) records every row's acceptance in
    every round, the recorder and snapshot keys the serving engine reports
    through; its wasted count includes the batch-min schedule's re-drafted
    tail. ``registry`` (a ``MetricsRegistry``; JAX ``registry=``,
    ``speculative.py:67``) records into a :class:`SpecStats` over that
    registry: the serving engine's metric names (``spec_accept_len``, the
    drafted, accepted and wasted counters). ``stats`` and ``registry`` are
    one or the other."""
    if registry is not None:
        if stats is not None:
            raise ValueError("pass stats= or registry=, not both")
        stats = SpecStats(registry)
    b, s = prompt_ids.shape
    if temperature > 0.0 and seed is None:
        raise ValueError("sampled speculative decoding needs a seed")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    validate_spec_room((target, draft), s, max_new_tokens, gamma)
    device = target.device
    ids = torch.as_tensor(np.asarray(prompt_ids) if not torch.is_tensor(prompt_ids)
                          else prompt_ids).to(device=device, dtype=torch.int64)
    t_prefill, t_decode = serving_clones(target)
    d_prefill, d_decode = serving_clones(draft)
    sampled = temperature > 0.0
    seeds = (seed or 0) + torch.arange(b, dtype=torch.int64, device=device)
    t_cache, d_cache = target.new_cache(b), draft.new_cache(b)

    logits = unwrap_logits(t_prefill(ids, cache=t_cache, last_only=True))[:, -1]
    d_prefill(ids, cache=d_cache, last_only=True)
    first = sample(logits, seeds, 0, temperature=temperature)
    tokens, count, base, last = [first[:, None]], 1, s, first
    idx = torch.arange(gamma, device=device)
    rounds, accepted_rows = 0, 0.0
    while count < max_new_tokens:
        # the draft proposes gamma tokens per row from its own cache; the
        # cursor rewind is JAX's _set_cache_index (device cursor and mirror)
        d_cache.index = base
        drafts, d_logits, tok = [], [], last
        for i in range(gamma):
            lg = unwrap_logits(d_decode(tok[:, None], cache=d_cache, last_only=True))[:, -1]
            d_cache.advance_mirror(1)
            tok = (sample_categorical(lg / temperature, seeds, count + i, DRAW_DRAFT)
                   if sampled else greedy(lg))
            drafts.append(tok)
            d_logits.append(lg)
        drafted = torch.stack(drafts, 1)  # (B, gamma)

        # the target scores [last, d_0..d_{gamma-2}] in one s = gamma window;
        # window row j predicts the token after position base + j
        t_cache.index = base
        window = torch.cat([last[:, None], drafted[:, :-1]], dim=1)
        t_logits = unwrap_logits(t_decode(window, cache=t_cache))  # (B, gamma, V)
        t_cache.advance_mirror(gamma)
        if sampled:
            n_acc, corrected = speculative_accept(
                t_logits, torch.stack(d_logits, 1), drafted, temperature, seeds,
                torch.full((b,), count, dtype=torch.int64, device=device))
        else:
            target_pred = greedy(t_logits)  # (B, gamma)
            n_acc = (drafted == target_pred).to(torch.int64).cumprod(dim=1).sum(dim=1)
            corrected = target_pred.gather(1, torch.clamp(n_acc, max=gamma - 1)[:, None])[:, 0]

        # per-row emissions: the accepted drafts, then the correction at the
        # first rejection (or the last draft on full acceptance)
        fix_pos = torch.clamp(n_acc, max=gamma - 1)[:, None]
        fix_val = torch.where(n_acc < gamma, corrected, drafted[:, gamma - 1])[:, None]
        out = torch.where(idx[None] < n_acc[:, None], drafted, 0)
        out = torch.where(idx[None] == fix_pos, fix_val, out)
        n_acc_h = n_acc.cpu().numpy()  # the round's one host read
        # one shared cursor: every row advances by the batch-min accepted
        # prefix (+1 for its correction); see the module docstring
        emit = min(int(n_acc_h.min()) + 1, gamma)
        if stats is not None:
            for n_row in n_acc_h.tolist():
                stats.record_round(n_row, gamma, consumed=min(n_row, emit))
        tokens.append(out[:, :emit])
        last = out[:, emit - 1]
        count += emit
        base += emit
        rounds += 1
        accepted_rows += float(n_acc_h.mean())
    return torch.cat(tokens, dim=1)[:, :max_new_tokens], accepted_rows / max(rounds, 1)
