"""Medusa tree decoding (counterpart of
``neuronx_distributed_tpu/inference/medusa.py``).

Each round (greedy, on fixed buffers, :func:`medusa_round`):

1. a W-token decode step (W = depth + 1, K4 on the row cache) writes K/V
   for the tokens emitted last round; the LM head and the Medusa heads run
   on the hidden state of its last VALID slot alone (a device gather);
2. candidates: base argmax + per-head top-k picks gathered into the static
   tree (``utils/medusa.py``);
3. ONE tree-verify decode forward: the tree tokens enter the cache with
   per-node depth positions and the tree attention mask (prefix + ancestors
   only), through the masked torch-op attention JAX keeps as an einsum; it
   runs the backbone and the LM head, no Medusa head;
4. greedy posterior acceptance picks the deepest matching chain.

The JAX round is one jitted program; here it is one
:class:`~neuronx_distributed_tpu_torch.inference.graphs.DecodeProgram`, a
CUDA graph captured at the first round and replayed for every later one (on
the CPU it runs eagerly). The round's variable inputs live on the device:
the cursor (the round's first column, which the host sets before each
replay through ``KVCache.index``, JAX's ``_set_cache_index``) and the count
``n_in`` of valid tokens in the window, which the host writes after the
round's one read. The window itself is last round's chain, masked past
``n_in`` on the device.

Cache contract. The port writes in place where JAX discards the verify's
cache: after a round, K/V at columns ``[cur, cur + n_nodes)`` (``cur`` =
the round's first column + ``n_in``) hold tree nodes and are marked valid,
past the cursor, which the round leaves at ``cur``. No query reads them
before they are rewritten: the next round's step writes W columns from
``cur`` and reads at most up to its own last position (K4 masks by
position), RoPE counts only the valid columns below the cursor, and the
next verify rewrites its ``n_nodes`` columns before attending them, while
its mask admits nothing else at or past its cursor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
from neuronx_distributed_tpu_torch.utils.medusa import (
    evaluate_posterior_greedy,
    generate_candidates,
    generate_medusa_buffers,
    medusa_buffers_on,
)

DEFAULT_CHOICES: Sequence[Tuple[int, ...]] = (
    (0,), (1,), (2,),
    (0, 0), (0, 1), (1, 0),
    (0, 0, 0),
)


@dataclasses.dataclass
class MedusaStats:
    """What one :func:`medusa_generate` call did: its round's program, each
    round's accepted length per row and tokens emitted per row, and the
    host clock after each round's read (``time.perf_counter``; the read
    waits for the round, so consecutive entries time a round)."""

    program: Optional[DecodeProgram] = None
    accept_lens: List[List[int]] = dataclasses.field(default_factory=list)
    emitted: List[int] = dataclasses.field(default_factory=list)
    round_end_s: List[float] = dataclasses.field(default_factory=list)


def tree_attention_mask(cur: torch.Tensor, node_mask: torch.Tensor,
                        cols: torch.Tensor) -> torch.Tensor:
    """The tree verify's (n_nodes, L) mask over cache columns ``cols`` (L,),
    built on the device from the cursor ``cur`` (JAX ``inference/medusa.py:
    115-126``): every column below ``cur`` (the prefix), and column ``cur +
    j`` for node ``j``'s ancestors and itself (``node_mask`` (n, n))."""
    n = node_mask.shape[0]
    prefix = cols[None] < cur
    in_tree = (cols[None] >= cur) & (cols[None] < cur + n)
    return prefix | (in_tree & node_mask[:, torch.clamp(cols - cur, 0, n - 1)])


def medusa_round(model, cache, buffers: dict, n_in: torch.Tensor, chain: torch.Tensor,
                 accept: torch.Tensor):
    """One Medusa round on fixed buffers (JAX ``_round``,
    ``inference/medusa.py:94``). Returns a callable of no arguments.

    ``model`` is a ``MedusaForCausalLM``, ``cache`` its row cache with the
    cursor at the round's first column, ``buffers`` the tree buffers on the
    device (:func:`~neuronx_distributed_tpu_torch.utils.medusa.
    medusa_buffers_on`), ``n_in`` a 0-d int64 device tensor (the valid
    tokens of the window, 1..W), ``chain`` (B, W) int64 last round's chain
    (the window, masked past ``n_in``), overwritten with this round's, and
    ``accept`` (B,) int64 each row's accepted length. Every result lands in
    place and nothing reads the device, so the round can be captured once
    and replayed. The cursor ends at the first column + ``n_in``."""
    w = chain.shape[1]
    idx = torch.arange(w, device=chain.device)
    cols = torch.arange(cache.max_seq_len, device=chain.device)
    clamped = torch.clamp(buffers["retrieve_indices"], min=0)

    @torch.no_grad()
    def run() -> None:
        start = cache.cursor.clone()
        # 1. the W-token step at the cursor (K4); the heads at slot n_in - 1
        x = model.model(torch.where(idx[None] < n_in, chain, 0), "decode", cache)
        cur = start + n_in
        cache.cursor.copy_(cur)
        h = x.index_select(1, (n_in - 1).reshape(1))  # (B, 1, hidden)
        base = torch.argmax(model.lm_head(h)[:, 0], dim=-1)
        # 2. candidates + tree tokens (per row)
        tree_tokens, cands = generate_candidates(base, model.medusa_logits(h)[:, 0], buffers)
        # 3. the tree verify at positions cur + depth, prefix + ancestors only;
        #    the backbone and the LM head, no Medusa head
        mask = tree_attention_mask(cur, buffers["attn_mask"], cols)
        xv = model.model(tree_tokens, "decode", cache, positions=cur + buffers["position_ids"],
                         attn_mask=mask)
        cache.cursor.copy_(cur)
        # 4. logits per candidate-chain node (B, leaves, depth+1, V), greedy
        #    acceptance; chain[:, 0] is the base argmax
        best, acc = evaluate_posterior_greedy(model.lm_head(xv)[:, clamped], cands)
        chain.copy_(cands.gather(1, best[:, None, None].expand(-1, 1, w))[:, 0])
        accept.copy_(acc)

    return run


def medusa_program(model, cache, buffers: dict, n_in: torch.Tensor, chain: torch.Tensor,
                   accept: torch.Tensor) -> DecodeProgram:
    """:func:`medusa_round` as a :class:`DecodeProgram`. Its warm-up runs
    the round once and restores the cursor, ``chain`` and ``accept``: a
    round writes K/V and validity only at or past the cursor, and every
    round rewrites those columns before any query reads them (the module
    docstring), so nothing else it touched can be seen."""
    run = medusa_round(model, cache, buffers, n_in, chain, accept)

    def warmup() -> None:
        saved = [t.clone() for t in (cache.cursor, chain, accept)]
        run()
        for t, s in zip((cache.cursor, chain, accept), saved):
            t.copy_(s)

    return DecodeProgram(run, warmup, chain.device)


@torch.no_grad()
def medusa_generate(model, prompt_ids, max_new_tokens: int,
                    choices: Sequence[Tuple[int, ...]] = DEFAULT_CHOICES, top_k: int = 10,
                    stats: Optional[MedusaStats] = None) -> Tuple[torch.Tensor, float]:
    """Greedy Medusa generation with a ``MedusaForCausalLM`` for
    ``prompt_ids`` (B, S), any batch, on the model's device. Rows accept
    chains of different lengths but share one cursor, so every round
    advances all rows by the BATCH-MIN accepted length + 1; greedy Medusa
    emits exactly the base model's greedy sequence per row whatever the
    schedule. Returns ``(tokens (B, max_new_tokens) int64,
    mean_accepted)``, the mean over rounds AND rows of each row's own
    accepted chain length (JAX's number). One host read a round; ``stats``
    (a :class:`MedusaStats`) records the rounds."""
    buffers = generate_medusa_buffers(choices, top_k=top_k)
    n_nodes = buffers["attn_mask"].shape[0]
    depth = buffers["retrieve_indices"].shape[1] - 1
    if depth > model.num_medusa_heads:
        raise ValueError(f"a tree of depth {depth} needs {depth} Medusa heads, the model has "
                         f"{model.num_medusa_heads}")
    b, s = prompt_ids.shape
    max_len = model.config.max_seq_len
    if s + max_new_tokens + depth + n_nodes > max_len:
        raise ValueError(
            f"prompt + max_new_tokens + tree ({n_nodes} nodes, depth {depth}) "
            f"exceeds max_seq_len ({max_len})"
        )
    device = model.device
    ids = torch.as_tensor(np.asarray(prompt_ids) if not torch.is_tensor(prompt_ids)
                          else prompt_ids).to(device=device, dtype=torch.int64)
    cache = model.new_cache(b)
    x = model.model(ids, "prefill", cache)
    w = depth + 1  # max tokens emitted (and re-fed) per round
    chain = torch.zeros((b, w), dtype=torch.int64, device=device)
    chain[:, 0] = torch.argmax(model.lm_head(x[:, -1]), dim=-1)
    n_in = torch.ones((), dtype=torch.int64, device=device)
    accept = torch.zeros((b,), dtype=torch.int64, device=device)
    program = medusa_program(model, cache, medusa_buffers_on(buffers, device), n_in, chain,
                             accept)
    if stats is not None:
        stats.program = program
    tokens = [chain[:, :1].to("cpu", copy=True)]  # chain is rewritten in place
    count, base_pos, n = 1, s, 1
    rounds, accepted_rows = 0, 0.0
    while count < max_new_tokens:
        n_in.fill_(n)
        cache.index = base_pos
        program()
        out = torch.cat([chain, accept[:, None]], dim=1).cpu()  # the round's one host read
        acc = out[:, w]
        emit = int(acc.min()) + 1  # one shared cursor: the batch-min advance
        tokens.append(out[:, :emit])
        count += emit
        base_pos += n
        n = emit
        rounds += 1
        accepted_rows += float(acc.double().mean())
        if stats is not None:
            stats.accept_lens.append(acc.tolist())
            stats.emitted.append(emit)
            stats.round_end_s.append(time.perf_counter())
    return torch.cat(tokens, dim=1)[:, :max_new_tokens].to(device), accepted_rows / max(rounds, 1)
