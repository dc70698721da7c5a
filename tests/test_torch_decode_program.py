"""The serving decode step as one device program (CPU, fp32, tiny_llama).

On the card the engine captures its decode step once in a CUDA graph and
replays it; a replay re-runs the recorded kernels on the recorded buffers
and runs no Python. These tests hold, on the CPU (where the same step runs
eagerly), what that needs:

(a) the cache's device write cursor equals its host mirror after every
    engine step, row and paged, across admission, eager preemption, cancel
    and drain;
(b) from the first chunk on, no tensor the decode step reads or writes is
    ever rebound: the slot state, the cache K/V and validity, the block
    table, the cursor, the step index and the token blocks keep their
    ``data_ptr`` across preemption and slot reuse;
(c) the decode chunk runs under a guard that makes every host read of a
    tensor (``item``, ``bool``, ``int``, ``float``, ``index``, ``tolist``,
    ``cpu``, ``numpy``) raise — the CPU's stand-in for "capture-safe";
(d) greedy streams equal the JAX engine's and solo ``generate`` at chunk
    sizes 1, 3 and 8 on a 48-column cache where chunks are cut by the
    cache end, row and paged;
and the capture's warm-up (one masked no-op step) leaves no trace.

Tolerances as ``tests/test_torch_serving.py``: streams equal exactly."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import ChunkedDecode, GenerationConfig
from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair
from test_torch_serving import _run_staggered, _solo

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PS = 8  # page size of the paged engines
LAYOUTS = {"row": {}, "paged": dict(kv_page_size=PS)}
SHORT = 48  # max_seq_len of the cache-end case


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=21)


@pytest.fixture(scope="module")
def short_pair():
    return build_pair(seed=21, max_seq_len=SHORT)


def _churn(engine, tmodel, check):
    """Eager traffic that hits the cursor wall (preempt and resume), a
    cancel of a running request, a drain and a second wave; ``check(engine)``
    runs after every engine step. Returns the requests that finished."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (30, 10, 40, 6, 12)]
    gcfgs = [GenerationConfig(max_new_tokens=m, temperature=0.0) for m in (90, 10, 30)]
    gcfgs += [GenerationConfig(max_new_tokens=12, temperature=0.8, top_k=20),
              GenerationConfig(max_new_tokens=7, temperature=0.0)]
    reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts[:3], gcfgs))]
    victim = engine.submit(prompts[3], gcfgs[3], seed=3)
    cancelled = False
    while engine.has_work:
        engine.step()
        check(engine)
        if not cancelled and victim.state is RequestState.DECODE:
            assert engine.cancel(victim.rid)
            cancelled = True
    assert cancelled and victim.state is RequestState.CANCELLED
    assert engine.metrics.preemptions > 0
    late = engine.submit(prompts[4], gcfgs[4], seed=4)  # after the drain: cursor rewinds
    while engine.has_work:
        engine.step()
        check(engine)
    for i, r in enumerate(reqs + [late]):
        j = i if i < 3 else 4
        assert r.state is RequestState.DONE
        assert r.tokens == _solo(tmodel, prompts[j], gcfgs[j], j), j
    return reqs + [late]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_device_cursor_equals_host_mirror_after_every_step(pair, layout):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=8, admission="eager",
                           **LAYOUTS[layout])
    seen = []

    def check(e):
        cache = e.cache.cache
        assert int(cache.cursor) == cache.index == e.cache.cursor
        seen.append(cache.index)

    _churn(engine, tmodel, check)
    assert max(seen) > 64  # the long prompt's jump
    assert any(b < a for a, b in zip(seen, seen[1:]))  # rewinds
    if layout == "paged":
        engine.cache.check()


def _step_buffers(engine):
    """data_ptr of every tensor the decode step reads or writes."""
    cache, chunk = engine.cache.cache, engine._decode_chunk
    ptrs = {f"state.{n}": t.data_ptr() for n, t in engine._state.items()}
    ptrs.update(k=cache.k.data_ptr(), v=cache.v.data_ptr(), valid=cache.valid.data_ptr(),
                cursor=cache.cursor.data_ptr(), step=chunk.step.data_ptr(),
                toks=chunk.toks.data_ptr(), emits=chunk.emits.data_ptr())
    if hasattr(cache, "block_table"):
        ptrs["block_table"] = cache.block_table.data_ptr()
    return ptrs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_step_buffers_never_rebound(pair, layout):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=8, admission="eager",
                           **LAYOUTS[layout])
    first = {}

    def check(e):
        ptrs = _step_buffers(e)
        if not first:
            first.update(ptrs)
        assert ptrs == first

    reqs = _churn(engine, tmodel, check)
    assert first and all(r.slot is None for r in reqs)
    assert engine.metrics.prefills > len(reqs)  # preempted requests came back, slots reused
    assert engine.decode_compilations == 0  # the CPU captures nothing


_HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Make every host read of a tensor raise."""
    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"Tensor.{name} inside the decode step reads the device")
        return raiser

    saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}
    for name in _HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_guard_refuses_host_reads():
    t = torch.ones(2)
    with no_host_reads():
        for read in (lambda: t[0].item(), lambda: bool(t[0]), lambda: int(t[0]),
                     lambda: t.tolist(), lambda: t.cpu(), lambda: t.numpy(),
                     lambda: [0, 1, 2][t[0].long()]):
            with pytest.raises(AssertionError, match="reads the device"):
                read()
    assert t.sum().item() == 2.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_chunk_reads_nothing_from_the_device(pair, layout, monkeypatch):
    _, _, tmodel = pair
    real = ChunkedDecode.__call__
    chunks = []

    def guarded(self):
        with no_host_reads():
            out = real(self)
        chunks.append(out[2])
        return out

    monkeypatch.setattr(ChunkedDecode, "__call__", guarded)
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=8, admission="eager",
                           **LAYOUTS[layout])
    _churn(engine, tmodel, lambda e: None)
    assert chunks and sum(chunks) == engine.metrics.executed_steps


def _short_workload():
    """A 10-token prompt that runs the 48-column cache to column 46 (its
    chunks start off the 8-column grid, so the cache end cuts the last
    chunk) and short requests that join at the cursor, one sampled to
    exercise the filters."""
    rng = np.random.default_rng(29)
    lens, news = [10, 5, 3, 7, 4], [38, 6, 9, 5, 8]
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in lens]
    gcfgs = [GenerationConfig(max_new_tokens=m, temperature=0.0) for m in news]
    return prompts, gcfgs


@pytest.fixture(scope="module")
def jax_short_streams(short_pair):
    jmodel, params, _ = short_pair
    prompts, gcfgs = _short_workload()
    jcfgs = [JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=0.0)
             for g in gcfgs]
    out = {}
    for layout, kw in LAYOUTS.items():
        engine = JServingEngine(jmodel, params, num_slots=3, decode_chunk_size=3,
                                prefix_cache=None, **kw)
        reqs = _run_staggered(engine, prompts, jcfgs,
                              lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(i)))
        out[layout] = [list(r.tokens) for r in reqs]
    return out


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_streams_at_the_cache_end_match_jax_engine_and_solo_generate(
        short_pair, jax_short_streams, layout, chunk, monkeypatch):
    _, _, tmodel = short_pair
    prompts, gcfgs = _short_workload()
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=chunk, **LAYOUTS[layout])
    executed = []
    real = ChunkedDecode.__call__

    def counting(self):
        out = real(self)
        executed.append((self.cache.index, out[2]))
        return out

    monkeypatch.setattr(ChunkedDecode, "__call__", counting)
    reqs = _run_staggered(engine, prompts, gcfgs, lambda e, p, g, i: e.submit(p, g, seed=i))
    for i, req in enumerate(reqs):
        assert req.state is RequestState.DONE
        assert req.tokens == _solo(tmodel, prompts[i], gcfgs[i], i), i
        assert req.tokens == jax_short_streams[layout][i], i
    assert engine.metrics.cursor_high_water >= SHORT - 1
    if chunk > 1:  # a chunk ran to the last column with fewer steps than its size
        assert any(end == SHORT and n < chunk for end, n in executed), executed
    if layout == "paged":
        engine.cache.check()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_capture_warmup_leaves_no_trace(pair, layout, monkeypatch):
    """The masked no-op step the card runs before capture, here run before
    EVERY step: the slot state and cursor are left as they were, and the
    streams are unchanged."""
    _, _, tmodel = pair
    real = DecodeProgram.__call__
    runs = []

    def warm_then_step(self):
        chunk = engine._decode_chunk
        cache, state = chunk.cache, chunk.state
        before = ({n: t.clone() for n, t in state.items()}, cache.index, int(cache.cursor),
                  cache.valid.clone(), int(chunk.step), chunk.emits.clone())
        self._warmup()
        assert all(torch.equal(t, before[0][n]) for n, t in state.items())
        assert (cache.index, int(cache.cursor), int(chunk.step)) == (before[1], before[2], before[4])
        assert torch.equal(cache.valid, before[3]) and torch.equal(chunk.emits, before[5])
        runs.append(1)
        real(self)

    monkeypatch.setattr(DecodeProgram, "__call__", warm_then_step)
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=8, admission="eager",
                           **LAYOUTS[layout])
    _churn(engine, tmodel, lambda e: None)
    assert len(runs) == engine.metrics.executed_steps


def test_prewarm_and_compilations_on_the_cpu(pair):
    """``prewarm`` captures nothing on the CPU and a busy engine refuses
    it; the metrics record no capture and no replay."""
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4)
    assert engine.prewarm() == 0.0 and engine.decode_compilations == 0
    r = engine.submit(np.arange(1, 7), GenerationConfig(max_new_tokens=6, temperature=0.0))
    engine.step()
    with pytest.raises(ValueError, match="idle"):
        engine.prewarm()
    engine.run()
    assert r.tokens == _solo(tmodel, np.arange(1, 7).astype(np.int32), r.config, r.seed)
    snap = engine.metrics.snapshot()
    assert snap["decode_captures"] == 0 and snap["graph_replays"] == 0
    assert snap["capture_s"] == 0.0
