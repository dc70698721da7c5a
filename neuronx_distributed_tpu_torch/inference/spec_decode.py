"""The serving engine's speculative round on fixed buffers (counterpart of
``neuronx_distributed_tpu/inference/spec_decode.py``, the body ``live`` of
its fused chunk, ``:122-238``).

One ROUND over every slot: the draft proposes ``gamma`` greedy tokens
through its own cache (``gamma`` decode steps of ``s = 1``), the target
scores ``[tok, d_0..d_{gamma-2}]`` in ONE ``s = gamma`` decode forward (K4 or
K5 with group x gamma rows per kv-head), and each slot accepts its own
longest matching prefix plus the target's correction: ``1..gamma`` tokens a
slot a round. :func:`speculative_chunk` runs ``decode_chunk_size`` rounds
between two host reads through the
:class:`~neuronx_distributed_tpu_torch.inference.generate.ChunkedDecode`
that runs plain steps, and the round is ONE captured device program on the
card (``inference/graphs.py``).

Per-slot variable advance on a shared write cursor: both caches write every
round's ``gamma`` columns at their cursors, valid for live rows; after
acceptance :func:`~neuronx_distributed_tpu_torch.modules.attention.
invalidate_cache_window` clears each row's rejected suffix in both, leaving
invalid gap columns that attention masks and RoPE positions skip (both run
off validity counts). A slot's logical length grows by its accepted length
while every slot shares one program; a round costs ``gamma`` columns.

Acceptance is the solo greedy rule, so a greedy slot emits the target's own
greedy stream whatever the draft. A SAMPLED slot accepts nothing and emits
exactly one token a round, drawn from the window's position-0 logits at its
token index ``ntok``: the plain step's draw, so its stream equals the
spec-off engine's.
"""

from __future__ import annotations

import torch

from neuronx_distributed_tpu_torch.inference.generate import ChunkedDecode
from neuronx_distributed_tpu_torch.inference.utils import unwrap_logits
from neuronx_distributed_tpu_torch.modules.attention import invalidate_cache_window
from neuronx_distributed_tpu_torch.utils.sampling import greedy, sample_per_row


def speculative_round(target_decode, draft_decode, cache, draft_cache, state, gamma: int,
                      toks: torch.Tensor, counts: torch.Tensor, accepts: torch.Tensor,
                      step: torch.Tensor):
    """One speculative round of every slot on fixed buffers: the
    counterpart of the JAX chunk's ``live`` (``spec_decode.py:122-238``).
    Returns a callable of no arguments.

    The inputs and outputs are tensors that live as long as the engine: the
    slot ``state`` leaves of :func:`~neuronx_distributed_tpu_torch.inference.
    generate.decode_step`, both caches and their device cursors, the device
    round index ``step`` (1,) int64, and the ``toks`` (rounds, B, gamma),
    ``counts`` and ``accepts`` (rounds, B) blocks: row ``step`` of ``toks``
    takes the round's tokens (slot ``b`` emitted the first ``counts[step,
    b]``) and of ``accepts`` the accepted draft lengths (0 for rows that
    were not live). Every result lands in place and nothing reads the
    device, so the round can be captured once and replayed; nothing in it
    writes a weight, so draft and target may share tensors.

    Emission per slot: the candidates up to the correction, cut after the
    first EOS and clamped by the remaining budget; a finished slot freezes
    (``tok``, ``ntok``, ``remaining``, ``active``). Once every slot has
    frozen the round is a masked no-op apart from the cursors, which move
    ``gamma`` columns (the chunk's caller rewinds them)."""
    tok, ntok, remaining, active, eos, temp = (state[n] for n in (
        "tok", "ntok", "remaining", "active", "eos", "temp"))
    idx = torch.arange(gamma, device=tok.device)

    @torch.no_grad()
    def run() -> None:
        live = active.clone()
        c0, d0 = cache.cursor.clone(), draft_cache.cursor.clone()
        # the draft proposes gamma greedy tokens through its own cache; a
        # frozen row's writes are invalid (the plain step's write mask)
        drafts, dt = [], tok
        for _ in range(gamma):
            logits = unwrap_logits(draft_decode(dt[:, None], cache=draft_cache,
                                                padding_mask=live[:, None], last_only=True))
            dt = greedy(logits[:, -1])
            drafts.append(dt)
        draft = torch.stack(drafts, dim=1)  # (B, gamma)

        # the target scores [tok, d_0..d_{gamma-2}] in ONE s = gamma forward;
        # window row j predicts the token after its input, so matching it
        # against d_j is the greedy acceptance rule
        window = torch.cat([tok[:, None], draft[:, :-1]], dim=1)
        t_logits = unwrap_logits(target_decode(
            window, cache=cache, padding_mask=live[:, None].expand(-1, gamma)))
        target_pred = greedy(t_logits)  # (B, gamma)
        matches = (draft == target_pred) & (temp == 0.0)[:, None]
        n_acc = matches.to(torch.int64).cumprod(dim=1).sum(dim=1)

        # position 0's token at the slot's token index: for a sampled slot the
        # plain step's draw, for a greedy one the argmax (= the correction at
        # zero acceptance)
        tok0 = sample_per_row(t_logits[:, 0], state["seed"], ntok, temp, state["topk"],
                              state["topp"])
        fix_pos = torch.clamp(n_acc, max=gamma - 1)
        fix_val = torch.where(n_acc < gamma, target_pred.gather(1, fix_pos[:, None])[:, 0],
                              draft[:, gamma - 1])
        out = torch.where(idx[None] < n_acc[:, None], draft, 0)
        out = torch.where(idx[None] == fix_pos[:, None], fix_val[:, None], out)
        out[:, 0] = torch.where(n_acc == 0, tok0, out[:, 0])

        # per-row emission: candidates up to the correction, cut after the
        # first EOS, clamped by the remaining budget
        cand_len = torch.clamp(n_acc + 1, max=gamma)
        is_eos = (eos[:, None] >= 0) & (out == eos[:, None]) & (idx[None] < cand_len[:, None])
        has_eos = is_eos.any(dim=1)
        first_eos = torch.logical_not(is_eos).to(torch.int64).cumprod(dim=1).sum(dim=1)
        eos_cut = torch.where(has_eos, first_eos + 1, cand_len)
        emit = torch.minimum(torch.minimum(cand_len, eos_cut), torch.clamp(remaining, min=0))
        emit = torch.where(live, emit, 0)
        remaining.sub_(emit)
        finished = live & ((has_eos & (eos_cut <= emit)) | (remaining <= 0))
        last = out.gather(1, torch.clamp(emit - 1, 0, gamma - 1)[:, None])[:, 0]
        tok.copy_(torch.where(emit > 0, last, tok))
        ntok.add_(emit)
        active.logical_and_(torch.logical_not(finished))

        # keep each live row's fed tokens that survive into its stream, in
        # BOTH caches (they fed the identical window); the rest become gaps
        keep = torch.where(live, cand_len, 0)
        invalidate_cache_window(cache, c0, keep)
        invalidate_cache_window(draft_cache, d0, keep)
        toks.index_copy_(0, step, out[None])
        counts.index_copy_(0, step, emit[None])
        accepts.index_copy_(0, step, torch.where(live, n_acc, 0)[None])
        step.add_(1)

    return run


def speculative_chunk(target_decode, draft_decode, rounds: int, gamma: int, max_seq_len: int,
                      cache, draft_cache, state) -> ChunkedDecode:
    """The speculative engine's decode chunk (counterpart of the JAX
    ``speculative_decode_chunk``): up to ``rounds`` :func:`speculative_round`
    iterations between two host reads, on a (rounds, B, gamma) token block
    and (rounds, B) emitted-count and accepted-length blocks, ``gamma``
    columns of both caches a round. The chunk takes ``min(room_target,
    room_draft) // gamma`` rounds, clipped to ``rounds``; its caller
    rewinds both cursors to ``start + used * gamma`` (JAX ``:244``)."""
    b, dev = state["tok"].shape[0], state["tok"].device
    toks = torch.zeros((rounds, b, gamma), dtype=torch.int64, device=dev)
    counts = torch.zeros((rounds, b), dtype=torch.int64, device=dev)
    accepts = torch.zeros((rounds, b), dtype=torch.int64, device=dev)

    def body(step):
        return speculative_round(target_decode, draft_decode, cache, draft_cache, state, gamma,
                                 toks, counts, accepts, step)

    return ChunkedDecode(body, (toks, counts, accepts), max_seq_len, (cache, draft_cache),
                         state, cols=gamma)
