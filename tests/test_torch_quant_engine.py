"""Quantized serving in the port (CPU, tiny_llama, fp32):
``ServingEngine(quantize=QuantConfig(weights=, kv=))``.

Inside the port, the int8-weight engines' greedy streams equal solo
``generate`` on the quantized model bit for bit, at every chunk size, row
and paged. Against the float model the contract is the JAX package's
budget (``tests/serving/test_quantized_engine.py
test_logit_divergence_budget``): teacher-forced next-token logits within
max KL 5e-3 and top-1 agreement 0.98. The int8 pool's writes equal JAX's
window re-quantization (``paged_window_vals``, ``quantize_page_block``,
``paged_scatter_vals``) bit for bit, and a prefix hit on it never writes a
shared page."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference.generate import ChunkedDecode, GenerationConfig, generate
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaForCausalLM,
    init_params,
    quantize_model,
    tiny_llama,
)
from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.paging import PagedCacheManager
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_decode_program import no_host_reads

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

jfd = importlib.import_module("neuronx_distributed_tpu.kernels.flash_decode")

MAX_KL_BUDGET = 5e-3       # JAX tests/serving/test_quantized_engine.py
TOP1_AGREEMENT_FLOOR = 0.98
PAGE = 16


@pytest.fixture(scope="module")
def model():
    return init_params(LlamaForCausalLM(tiny_llama(), device="cpu"), seed=1)


def _prompts(rng, lengths):
    return [rng.integers(1, 256, size=n) for n in lengths]


def _serve(model, prompts, gcfg, **kw):
    engine = ServingEngine(model, num_slots=2, **kw)
    reqs = [engine.submit(p, gcfg, seed=i) for i, p in enumerate(prompts)]
    engine.run()
    for r in reqs:
        assert r.state is RequestState.DONE and len(r.tokens) == gcfg.max_new_tokens
    return engine, [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("chunk", [1, 5])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("weights", ["int8", "fp8"])
def test_quantized_weight_engines_equal_solo_generate(model, weights, paged, chunk):
    """Greedy streams of the int8/fp8-weight row and paged engines equal
    solo ``generate`` on the same quantized model, bit for bit."""
    rng = np.random.default_rng(2)
    prompts = _prompts(rng, (7, 30, 12))
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.0)
    qm = quantize_model(model, QuantConfig(weights=weights).weight_qconfig())
    solo = [generate(qm, p[None], gcfg)[0].tolist() for p in prompts]
    kw = dict(kv_page_size=PAGE) if paged else {}
    engine, toks = _serve(model, prompts, gcfg, decode_chunk_size=chunk,
                          quantize=QuantConfig(weights=weights), **kw)
    assert toks == solo
    assert engine.model.config.quantization == QuantConfig(weights=weights).weight_qconfig()
    assert model.config.quantization is None  # the caller's model stays float


def test_quantized_eager_admission_and_preemption(model):
    """JAX ``test_quantized_eager_admission_and_preemption``: eager
    admission over a small int8 pool preempts and resumes; every request
    finishes and the pool's accounting is clean."""
    prompts = [np.arange(1 + i, 12 + i) for i in range(4)]
    gcfg = GenerationConfig(max_new_tokens=20, temperature=0.0)
    engine = ServingEngine(model, num_slots=4, decode_chunk_size=4, admission="eager",
                           quantize=QuantConfig(weights="int8", kv="int8"), kv_page_size=PAGE,
                           kv_num_pages=3 * (128 // PAGE) + 1)
    reqs = [engine.submit(p, gcfg, seed=i) for i, p in enumerate(prompts)]
    engine.run()
    for r in reqs:
        assert r.state is RequestState.DONE and len(r.tokens) == 20
    engine.cache.check()


def test_quantized_bytes_shrink(model):
    """JAX ``test_quantized_params_bytes_shrink``: the int8 model's weights
    are under half the float model's, and an int8 page (codes and scales)
    at least 1.8x smaller than the float page, so a fixed budget holds at
    least 1.8x the pages."""
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    prompts = [np.arange(1, 9)]
    fp, _ = _serve(model, prompts, gcfg, kv_page_size=PAGE)
    q, _ = _serve(model, prompts, gcfg, kv_page_size=PAGE,
                  quantize=QuantConfig(weights="int8", kv="int8"))

    def nbytes(m):
        return sum(t.numel() * t.element_size() for t in m.state_dict().values())

    assert nbytes(q.model) < 0.5 * nbytes(fp.model)
    assert q.cache.cache.k.dtype == torch.int8 and q.cache.cache.k_scale is not None
    fp_page, q_page = fp.cache.page_nbytes, q.cache.page_nbytes
    assert fp_page / q_page >= 1.8, (fp_page, q_page)
    budget = 10 * fp_page
    assert budget // q_page >= 1.8 * (budget // fp_page)
    assert q.cache.nbytes == q_page * q.cache.alloc.num_pages + q.cache.cache.block_table.numel() * 4


def test_validation_errors(model):
    """JAX ``test_validation_errors``, and the draft restriction."""
    import types

    dummy = types.SimpleNamespace(config=types.SimpleNamespace(max_seq_len=128, vocab_size=8),
                                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="'quantization' field"):
        ServingEngine(dummy, num_slots=1, quantize=QuantConfig(weights="int8"))
    with pytest.raises(ValueError, match="kv_page_size"):
        ServingEngine(model, num_slots=2, quantize=QuantConfig(weights="int8", kv="int8"))
    qm = quantize_model(model, QuantConfig().weight_qconfig())
    with pytest.raises(ValueError, match="already carries"):
        ServingEngine(qm, num_slots=2, quantize=QuantConfig(weights="int8"))
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(model, num_slots=2, draft_model=model, quantize=QuantConfig(weights="int8"))
    # a model that already carries the config serves without quantize=
    engine, toks = _serve(qm, [np.arange(1, 6)], GenerationConfig(3, temperature=0.0))
    assert engine.model is qm and len(toks[0]) == 3


def _teacher_forced_logits(m, prompt, cont, cache):
    """Next-token logits (1 + len(cont), V) of ``prompt`` then ``cont``,
    fed one token a step through ``cache``."""
    out = [m(torch.from_numpy(prompt[None]).long(), mode="prefill", cache=cache)[0, -1]]
    for tok in cont:
        out.append(m(torch.tensor([[int(tok)]]), mode="decode", cache=cache)[0, -1])
    return torch.stack(out)


def _kl_top1(ref, got):
    lp = torch.log_softmax(ref.double(), -1)
    kl = (lp.exp() * (lp - torch.log_softmax(got.double(), -1))).sum(-1)
    return float(kl.max()), float((ref.argmax(-1) == got.argmax(-1)).double().mean())


@pytest.fixture(scope="module")
def jax_bench_model():
    """The JAX budget test's model (``tests/serving/test_quantized_engine.py``
    ``setup``: tiny_llama, params from PRNGKey(1)) carried across."""
    import jax
    from flax import linen as nn

    from neuronx_distributed_tpu.models import llama as jllama
    from neuronx_distributed_tpu_torch.models.convert import flax_to_torch

    jm = jllama.LlamaForCausalLM(jllama.tiny_llama(), attention_impl="xla")
    ids = jax.random.randint(jax.random.PRNGKey(0), (1, 8), 1, 256)
    params = nn.unbox(jm.init(jax.random.PRNGKey(1), ids))
    tm = LlamaForCausalLM(tiny_llama(), device="cpu")
    tm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params), tm.config))
    return tm


@pytest.mark.parametrize("kv", [None, "int8"])
def test_teacher_forced_stream_within_the_budget(jax_bench_model, kv):
    """JAX ``test_logit_divergence_budget`` on its model, prompt and 16
    steps, and the same with an int8 page pool under the int8 weights: the
    float greedy continuation teacher-forced through the float model (row
    cache) and the quantized one; max KL < 5e-3 and top-1 agreement >=
    0.98 (max KL 1.4e-4 with int8 weights, 2.2e-4 with the int8 pool too)."""
    model = jax_bench_model
    prompt = np.arange(1, 9)
    steps = 16
    ref_stream = generate(model, prompt[None], GenerationConfig(steps, temperature=0.0))[0].numpy()
    ref = _teacher_forced_logits(model, prompt, ref_stream[:-1], model.new_cache(1))
    qm = quantize_model(model, QuantConfig().weight_qconfig())
    if kv is None:
        cache = qm.new_cache(1)
    else:
        cache = qm.new_paged_cache(1, num_pages=128 // PAGE + 1, page_size=PAGE, kv_quant=kv)
        cache.upload_table(np.arange(1, 128 // PAGE + 1, dtype=np.int32)[None])
    got = _teacher_forced_logits(qm, prompt, ref_stream[:-1], cache)
    kl, top1 = _kl_top1(ref, got)
    assert kl < MAX_KL_BUDGET, f"max KL {kl} over budget"
    assert top1 >= TOP1_AGREEMENT_FLOOR, f"top-1 agreement {top1}"
    assert kl > 0  # the quantized path is not the float one


@pytest.mark.parametrize("s,col", [(1, 37), (1, 48), (5, 29), (20, 5), (9, 21), (5, 59)])
def test_int8_pool_write_equals_jax_window_requantize(s, col):
    """A write of s columns at ``col`` into an int8 pool equals JAX's rule
    for a chunk's write window, bit for bit: the dequantized logical view
    (``paged_gather_leaf_dequant``) takes the new rows, the window's pages
    (``paged_window_vals``, the port's window: one page for one column, else
    (s - 1) // page_size + 2) are quantized (``quantize_page_block``) and
    scattered (``paged_scatter_vals``). Every other page keeps its bits. A
    window past the table's end (``(5, 59)``) writes its last page into the
    null page 0, which JAX's window (clamped to the table) does not reach:
    there the pools are compared on every page but 0."""
    rng = np.random.default_rng(s + col)
    b, hkv, d, ps, n_log, n_pages = 2, 2, 8, 8, 8, 20
    cache = PagedKVCache.allocate(1, b, n_log * ps, hkv, d, torch.float32, "cpu", n_pages, ps,
                                  kv_quant="int8")
    for pool, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        q, sc = tfd.quantize_page_block(torch.from_numpy(
            rng.normal(size=(1, n_pages, ps, hkv, d)).astype(np.float32)))
        pool.copy_(q)
        scale.copy_(sc)
    table = rng.permutation(np.arange(1, n_pages))[:b * n_log].reshape(b, n_log).astype(np.int32)
    cache.upload_table(table)
    view = cache.view(slice(None), col)
    view._address(view._cols[:s])
    x = {n: rng.normal(size=(b, s, hkv, d)).astype(np.float32) for n in ("k", "v")}
    before = {n: getattr(cache, n).clone() for n in ("k", "v", "k_scale", "v_scale")}
    view.decode_write(0, torch.from_numpy(x["k"]), torch.from_numpy(x["v"]))
    n_win = 1 if s == 1 else (s - 1) // ps + 2
    page0 = col // ps
    touched = set(table[:, page0:page0 + n_win].reshape(-1).tolist())
    keep = slice(1, None) if page0 + n_win > n_log else slice(None)
    for name in ("k", "v"):
        pq, psc = getattr(cache, name)[0], getattr(cache, name + "_scale")[0]
        logical = jfd.paged_gather_leaf_dequant(jnp.asarray(before[name][0].numpy()),
                                                jnp.asarray(before[name + "_scale"][0].numpy()),
                                                jnp.asarray(table), ps)
        logical = logical.at[:, col:col + s].set(jnp.asarray(x[name]))
        vals, idx = jfd.paged_window_vals(logical, jnp.asarray(table), jnp.asarray(page0), n_win,
                                          ps, 0)
        wq, ws = jfd.quantize_page_block(vals)
        np.testing.assert_array_equal(
            pq[keep].numpy(), np.asarray(jfd.paged_scatter_vals(
                jnp.asarray(before[name][0].numpy()), wq, idx))[keep])
        np.testing.assert_array_equal(
            psc[keep].numpy(), np.asarray(jfd.paged_scatter_vals(
                jnp.asarray(before[name + "_scale"][0].numpy()), ws, idx))[keep])
        untouched = [p for p in range(n_pages) if p not in touched]
        assert torch.equal(pq[untouched], before[name][0][untouched])


def test_recycled_page_quantizes_only_its_own_rows(model):
    """A page handed out again is zeroed first (codes and scales), so after
    a prefill its scale and codes are those of ``quantize_page_block`` on
    the prompt's K/V with the page's unwritten rows zero: an earlier
    request's rows never enter it."""
    qm = quantize_model(model, QuantConfig().weight_qconfig())
    mgr = PagedCacheManager.for_model(qm, 2, PAGE, num_pages=5, kv_quant="int8")
    c = mgr.cache
    for t in (c.k, c.v):
        t.random_(-127, 128, generator=torch.Generator().manual_seed(0))
    for t in (c.k_scale, c.v_scale):
        t.fill_(3.0)  # what an earlier request left
    p = 20
    ids = torch.from_numpy(np.random.default_rng(5).integers(1, 256, size=(1, p))).long()
    row = mgr.admit(0, p, cursor=p, p=p)
    qm(ids, mode="prefill", cache=row)
    pages = mgr.slot_pages(0)
    assert len(pages) == 2
    ref = qm.new_cache(1)
    qm(ids, mode="prefill", cache=ref)
    for name in ("k", "v"):
        rows = torch.zeros(qm.config.num_layers, 2 * PAGE, *getattr(ref, name).shape[3:])
        rows[:, :p] = getattr(ref, name)[:, 0, :p]
        want_q, want_s = tfd.quantize_page_block(rows.view(qm.config.num_layers, 2, PAGE,
                                                           *rows.shape[2:]))
        assert torch.equal(getattr(c, name)[:, pages], want_q)
        assert torch.equal(getattr(c, name + "_scale")[:, pages], want_s)
    mgr.check()


def test_int8_pool_decode_chunk_reads_nothing_from_the_device(model, monkeypatch):
    """The int8 pool's decode step (the page re-quantize included) runs
    with every host read of a tensor made to raise: it addresses pages from
    the device cursor and the uploaded table alone, as a captured step
    must."""
    real = ChunkedDecode.__call__
    chunks = []

    def guarded(self):
        with no_host_reads():
            out = real(self)
        chunks.append(out)
        return out

    monkeypatch.setattr(ChunkedDecode, "__call__", guarded)
    engine, toks = _serve(model, _prompts(np.random.default_rng(3), (9, 21)),
                          GenerationConfig(12, temperature=0.0), decode_chunk_size=4,
                          kv_page_size=PAGE, quantize=QuantConfig(weights="int8", kv="int8"))
    assert chunks and sum(chunks) == engine.metrics.executed_steps


def test_quantized_prefix_sharing_is_zero_copy(model, monkeypatch):
    """JAX ``test_quantized_paged_prefix_sharing_zero_copy`` on an int8
    pool: hits map the stored pages (copy_bytes 0, pages shared), the
    shared pages' codes and scales keep their bits through every hit's
    suffix prefill and decode, ``check()`` is clean, and a hit's first-token
    logits are within the budget of a full prefill of the same context."""
    shared = np.arange(1, 1 + 2 * PAGE)
    prompts = [np.concatenate([shared, [40 + i] * (1 + 3 * i)]) for i in range(3)]
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    kw = dict(kv_page_size=PAGE, quantize=QuantConfig(weights="int8", kv="int8"),
              decode_chunk_size=4)
    firsts = {}
    for prefix in ("auto", None):
        engine = ServingEngine(model, num_slots=2, prefix_cache=prefix, **kw)
        bind = engine._bind_slot
        logits = firsts.setdefault(prefix, [])
        monkeypatch.setattr(engine, "_bind_slot",
                            lambda req, slot, lg, now: (logits.append(lg.clone()),
                                                        bind(req, slot, lg, now)))
        reqs = [engine.submit(prompts[0], gcfg, seed=0)]
        engine.run()
        if prefix == "auto":
            (entry,) = engine.prefix.entries
            ids = list(entry.page_ids)
            c = engine.cache.cache
            pinned = [t[:, ids].clone() for t in (c.k, c.v, c.k_scale, c.v_scale)]
        reqs += [engine.submit(p, gcfg, seed=i) for i, p in enumerate(prompts[1:], 1)]
        engine.run()
        assert all(r.state is RequestState.DONE and len(r.tokens) == 6 for r in reqs)
        engine.cache.check()
    assert engine.metrics.snapshot()["prefix_hits"] == 0  # the prefix-off engine
    assert len(firsts["auto"]) == len(firsts[None]) == 3
    for i in (1, 2):
        kl, top1 = _kl_top1(firsts[None][i][None], firsts["auto"][i][None])
        assert kl < MAX_KL_BUDGET and top1 == 1.0, (i, kl)
    assert all(torch.equal(a, b) for a, b in zip(
        pinned, [t[:, ids] for t in (c.k, c.v, c.k_scale, c.v_scale)]))


def test_quantized_prefix_hits_share_pages(model):
    """The prefix-on engine's counters for the traffic above: two hits on
    two shared pages each, zero KV bytes copied."""
    shared = np.arange(1, 1 + 2 * PAGE)
    prompts = [np.concatenate([shared, [40 + i] * (1 + 3 * i)]) for i in range(3)]
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, kv_page_size=PAGE,
                           quantize=QuantConfig(weights="int8", kv="int8"))
    reqs = [engine.submit(prompts[0], GenerationConfig(6, temperature=0.0))]
    engine.run()
    reqs += [engine.submit(p, GenerationConfig(6, temperature=0.0)) for p in prompts[1:]]
    engine.run()
    snap = engine.metrics.snapshot()
    assert (snap["prefix_hits"], snap["prefix_misses"]) == (2, 1)
    assert snap["prefix_pages_shared"] >= 4 and engine.cache.alloc.copy_bytes == 0
    assert all(len(r.tokens) == 6 for r in reqs)
    engine.cache.check()
