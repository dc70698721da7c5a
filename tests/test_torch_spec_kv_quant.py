"""``quantize.kv`` beside a draft (CPU, fp32, tiny_llama): the speculative
engine over an int8 target pool and a float draft pool, as the JAX engine
serves it (``serving/engine.py:514-527``: the draft stays float).

The JAX engine's int8-pool stream test (``tests/serving/
test_quantized_engine.py test_kv_quant_stream_within_budget``) is red in the
reference, so it is no oracle here; its criterion is greedy agreement of at
least 0.9 with the float engine, on its model (tiny_llama from
PRNGKey(1)), prompt and 24 new tokens. The port's int8-pool engine with a
draft is held to it against the port's int8-pool engine without a draft,
with two drafts: the JAX suites' independent 2-layer draft (PRNGKey(7):
rejections, so gap columns) and the target's own weights (long accepted
windows). Against the float model the criterion is taken per step: each
emitted token against the float model's greedy token on the same prefix
(teacher-forced), since a free-running int8-pool stream that leaves the
float one at a near tie differs from it in every later position (on JAX's
prompt the port's int8-pool engines, with a draft and without, part from
the float engine's stream at token 21 of 24: 0.83 positionally, one
miss teacher-forced). Every write of the target's
pool is a verify window (s = gamma) through the fused route
(``qpaged_write_attend_fwd``), and each equals ``window_requantize_plain``
(held to JAX's ``scatter_cache_window`` in ``test_torch_kv_quant.py``) on
the pool as it was, over the window the host works out from the cursor and
the table. A page's scale keeps a rejected row's magnitude until the row is
written over, as in JAX."""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq
from neuronx_distributed_tpu_torch.modules import attention as tattn
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair

torch.set_num_threads(1)

PAGE, GAMMA = 16, 4
QKV = QuantConfig(weights="int8", kv="int8")


@pytest.fixture(scope="module")
def setup():
    """The JAX budget test's model (PRNGKey(1)) and the JAX suites' 2-layer
    draft (PRNGKey(7))."""
    return build_pair(seed=1)[2], build_pair(seed=7, num_layers=2)[2]


def _run(engine, prompts, gcfg):
    reqs = [engine.submit(p, gcfg, seed=100 + i) for i, p in enumerate(prompts)]
    engine.run()
    for r in reqs:
        assert r.state is RequestState.DONE and len(r.tokens) == gcfg.max_new_tokens
    return [list(r.tokens) for r in reqs]


def _agreement(a, b) -> float:
    pairs = [(x, y) for s, t in zip(a, b) for x, y in zip(s, t)]
    return sum(x == y for x, y in pairs) / len(pairs)


def _teacher_forced_agreement(model, prompts, streams) -> float:
    """The share of emitted tokens that equal the float model's greedy
    token on the same prefix (one no-cache forward of prompt + stream)."""
    hits = n = 0
    with torch.no_grad():
        for p, toks in zip(prompts, streams):
            ids = torch.from_numpy(np.concatenate([p, toks[:-1]]).astype(np.int64))[None]
            pred = model(ids)[0, len(p) - 1:].argmax(-1)
            hits += int((pred == torch.tensor(toks)).sum())
            n += len(toks)
    return hits / n


def _checked_window_writes(monkeypatch, writes):
    """Wrap the fused route: after each call, the pools must equal
    ``window_requantize_plain`` on the pools before it, over the window
    worked out on the host (``w0``'s page onwards, one page at s = 1,
    ``(s - 1) // page_size + 2`` else, the null page past the table)."""
    fused = tattn.qpaged_write_attend_fwd

    def checked(q, k, v, k_pool, v_pool, k_scale, v_scale, bt, q_pos, kv_valid, w0, ps):
        want = [t.clone() for t in (k_pool, v_pool, k_scale, v_scale)]
        out = fused(q, k, v, k_pool, v_pool, k_scale, v_scale, bt, q_pos, kv_valid, w0, ps)
        s, c0, table = k.shape[1], int(w0), bt.numpy()
        first, n_win = c0 // ps, 1 if s == 1 else (s - 1) // ps + 2
        pages = [[int(row[lp]) if lp < table.shape[1] else 0 for lp in range(first, first + n_win)]
                 for row in table]
        tkq.window_requantize_plain(*want, torch.tensor(pages), torch.tensor([c0 - first * ps]),
                                    k, v)
        for name, got, w in zip(("k", "v", "k_scale", "v_scale"),
                                (k_pool, v_pool, k_scale, v_scale), want):
            assert torch.equal(got, w), name
        writes.append(s)
        return out

    monkeypatch.setattr(tattn, "qpaged_write_attend_fwd", checked)


def _one_capture(monkeypatch):
    """The card's capture count stood in: a decode program captures at its
    first call (the CPU runs the step eagerly and captures nothing)."""
    def call(self):
        self.captures = max(self.captures, 1)
        self.step()

    monkeypatch.setattr(DecodeProgram, "__call__", call)


@pytest.mark.parametrize("draft", ["independent", "target"])
def test_int8_pool_beside_a_float_draft(setup, monkeypatch, draft):
    """Greedy streams of the int8-pool engine with a draft (int8 weights,
    gamma 4) agree with the int8-pool spec-off engine's on at least 0.9 of
    their tokens (JAX's criterion), and with the float model's greedy token
    on the same prefix on at least 0.9 of them; the draft's
    pool is float, the target's int8; every target write is a verify window
    equal to ``window_requantize_plain``; one decode program, no fallback;
    both pools ``check()`` clean."""
    target, independent = setup
    d = independent if draft == "independent" else target
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(3, 10, dtype=np.int32)]
    gcfg = GenerationConfig(max_new_tokens=24, temperature=0.0)
    off = _run(ServingEngine(target, num_slots=2, decode_chunk_size=4, quantize=QKV,
                             kv_page_size=PAGE), prompts, gcfg)
    writes = []
    _checked_window_writes(monkeypatch, writes)
    _one_capture(monkeypatch)
    engine = ServingEngine(target, num_slots=2, decode_chunk_size=4, quantize=QKV,
                           kv_page_size=PAGE, draft_model=d, draft_params=d.state_dict(),
                           gamma=GAMMA)
    assert engine.cache.cache.quantized and engine.cache.cache.k.dtype == torch.int8
    assert not engine.draft_cache.cache.quantized
    assert engine.draft_cache.cache.k.dtype == torch.float32
    on = _run(engine, prompts, gcfg)
    snap = engine.metrics.snapshot()
    assert writes and set(writes) == {GAMMA}
    assert len(writes) == snap["executed_steps"] * target.config.num_layers
    assert snap["spec_rounds"] > 0 and snap["spec_fallbacks"] == 0
    assert engine.decode_compilations == 1 and engine._plain_chunk is None
    assert _agreement(off, on) >= 0.9, (off, on)
    assert _teacher_forced_agreement(target, prompts, on) >= 0.9, on
    if draft == "target":
        assert snap["spec_accept_rate"] > 0.5  # long accepted windows
    engine.cache.check()
    engine.draft_cache.check()


@pytest.mark.parametrize("draft", [None, "independent"])
def test_capture_warmup_leaves_the_int8_pool_as_it_was(setup, monkeypatch, draft):
    """The masked no-op iteration the card runs before capture, here run
    before every chunk: its write re-quantizes the window's pages, valid
    rows included, and the warm-up puts them back, so every page's codes
    and scales are as they were, and the streams equal a run without
    warm-ups (plain step and speculative round; the draft's float pool
    takes the warm-up's rows only in invalid columns at its cursor, which
    the round rewrites)."""
    target, independent = setup
    kw = {} if draft is None else dict(draft_model=independent,
                                       draft_params=independent.state_dict(), gamma=GAMMA)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=n) for n in (5, 17, 30)]
    gcfg = GenerationConfig(max_new_tokens=20, temperature=0.0)

    def engine():
        return ServingEngine(target, num_slots=3, decode_chunk_size=4, quantize=QKV,
                             kv_page_size=PAGE, **kw)

    ref = _run(engine(), prompts, gcfg)
    real = DecodeProgram.__call__
    kept = []  # whether each warm-up left the int8 pool's bits as they were

    def warm_then_step(self):
        pool = e.cache.cache
        leaves = (pool.k, pool.v, pool.k_scale, pool.v_scale)
        before = [t.clone() for t in leaves]
        self._warmup()
        kept.append(all(torch.equal(t, x) for t, x in zip(leaves, before)))
        real(self)

    monkeypatch.setattr(DecodeProgram, "__call__", warm_then_step)
    e = engine()
    assert _run(e, prompts, gcfg) == ref
    assert kept and all(kept)
