"""The port's solo speculative decoding and its building blocks against the
JAX package (CPU, fp32, tiny_llama).

Target and draft carry the JAX fixture's weights (``flax_to_torch``): a
tiny_llama target and a 2-layer draft from another seed. Greedy
``speculative_generate`` must give the JAX function's tokens and the port's
plain ``generate`` tokens exactly, at B = 1 and B = 2; its acceptance
statistics must equal JAX's ``SpecStats`` key for key. The early-exit draft
pair must equal JAX's leaf for leaf, and ``invalidate_cache_window`` JAX's
validity bit for bit, on a row cache, a paged cache and a slot view of it.
The sampled rule is checked by its anchor: a perfect draft accepts every
token (p_t = p_d up to fp32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.speculative import (
    speculative_generate as jspeculative_generate,
)
from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.models.llama import early_exit_draft_params as jearly_exit
from neuronx_distributed_tpu.modules.attention import invalidate_cache_window as jinvalidate
from neuronx_distributed_tpu.observability import MetricsRegistry
from neuronx_distributed_tpu.observability import SpecStats as JSpecStats
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.inference.speculative import speculative_generate
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.modules.attention import (
    KVCache,
    PagedKVCache,
    invalidate_cache_window,
)
from neuronx_distributed_tpu_torch.observability.spec_stats import SpecStats
from test_torch_llama import _np_tree, build_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEW = 10


@pytest.fixture(scope="module")
def setup():
    """The JAX fixture (``tests/inference/test_speculative.py``): target
    tiny_llama from key 1, 2-layer draft from key 7, both here too."""
    jt, tp, tt = build_pair(seed=1)
    jd, dp, td = build_pair(seed=7, num_layers=2)
    return jt, tp, tt, jd, dp, td


def _ids(b, seed=9):
    return np.random.default_rng(seed).integers(1, 256, size=(b, 8)).astype(np.int32)


@pytest.mark.parametrize("b", [1, 2])
def test_greedy_equals_jax_and_plain_generate(setup, b):
    jt, tp, tt, jd, dp, td = setup
    ids = _ids(b)
    want, jacc = jspeculative_generate(jt, tp, jd, dp, jnp.asarray(ids), max_new_tokens=NEW,
                                       gamma=3)
    got, acc = speculative_generate(tt, td, ids, NEW, gamma=3)
    assert got.shape == (b, NEW) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = generate(tt, ids, GenerationConfig(NEW, temperature=0.0))
    assert torch.equal(got, ref)
    assert acc == pytest.approx(float(jacc), abs=1e-12) and 0.0 <= acc <= 3.0


def test_perfect_draft_accepts_everything(setup):
    _, _, tt, _, _, _ = setup
    ids = _ids(2, seed=3)
    got, acc = speculative_generate(tt, tt, ids, NEW, gamma=4)
    assert acc == 4.0
    assert torch.equal(got, generate(tt, ids, GenerationConfig(NEW, temperature=0.0)))


def test_max_seq_len_guard(setup):
    _, _, tt, _, _, td = setup
    ids = _ids(1)
    too_many = tt.config.max_seq_len - ids.shape[1] + 1
    with pytest.raises(ValueError, match="max_seq_len"):
        speculative_generate(tt, td, ids, too_many, gamma=3)
    with pytest.raises(ValueError, match="max_seq_len"):  # the gamma - 1 headroom alone
        speculative_generate(tt, td, ids, tt.config.max_seq_len - ids.shape[1], gamma=3)
    speculative_generate(tt, td, ids, tt.config.max_seq_len - ids.shape[1] - 2, gamma=3)


@pytest.mark.parametrize("b", [1, 4])
def test_sampled_perfect_draft_accepts_all(setup, b):
    """temperature > 0 with draft == target: min(1, p_t / p_d) = 1 up to
    fp32 rounding of the s = gamma window against the s = 1 steps, so
    every round accepts all gamma drafts; the same seed gives the same
    tokens, another seed others."""
    _, _, tt, _, _, _ = setup
    ids = _ids(b, seed=11)
    toks, acc = speculative_generate(tt, tt, ids, NEW, gamma=3, temperature=0.8, seed=7)
    assert toks.shape == (b, NEW) and 0 <= int(toks.min()) and int(toks.max()) < 256
    assert acc == 3.0
    again, _ = speculative_generate(tt, tt, ids, NEW, gamma=3, temperature=0.8, seed=7)
    other, _ = speculative_generate(tt, tt, ids, NEW, gamma=3, temperature=0.8, seed=8)
    assert torch.equal(toks, again) and not torch.equal(toks, other)


def test_sampled_weak_draft_and_the_seed(setup):
    _, _, tt, _, _, td = setup
    ids = _ids(1)
    toks, acc = speculative_generate(tt, td, ids, NEW, gamma=3, temperature=1.0, seed=3)
    assert toks.shape == (1, NEW) and 0.0 <= acc <= 3.0
    with pytest.raises(ValueError, match="seed"):
        speculative_generate(tt, td, ids, 4, temperature=0.5)


@pytest.mark.parametrize("draft", ["weak", "perfect", "early_exit"])
def test_spec_stats_snapshot_equals_jax(setup, draft):
    """The same greedy run (B = 3, batch-min schedule) through the JAX
    recorder (``registry=``) and the port's (``stats=``): every snapshot key
    equal, the accept-length percentiles included. Drafts: the 2-layer one
    of another seed, the target itself, and the target's first layer
    (early exit, eps 0.5: partial acceptance)."""
    jt, tp, tt, jd, dp, td = setup
    perfect = draft == "perfect"
    if perfect:
        jd, dp, td = jt, tp, tt
    elif draft == "early_exit":
        tp, dp = jearly_exit(tp, 4, 1, 0.5)
        jd = jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=1), attention_impl="xla")
        tt, td = tllama.early_exit_draft(tt, 1, 0.5)
    ids = _ids(3, seed=4)
    reg = MetricsRegistry()
    jspeculative_generate(jt, tp, jd, dp, jnp.asarray(ids), max_new_tokens=NEW, gamma=3,
                          registry=reg)
    stats = SpecStats()
    speculative_generate(tt, td, ids, NEW, gamma=3, stats=stats)
    want, got = JSpecStats(reg).snapshot(), stats.snapshot()
    assert got == want
    assert got["spec_rounds"] > 0 and got["spec_draft_tokens"] == 3 * got["spec_rounds"]
    assert (got["spec_accept_rate"] == 1.0) == perfect
    assert (0.0 < got["spec_accept_rate"] < 1.0) == (draft == "early_exit")


def test_registry_equals_jax_registry(setup):
    """``speculative_generate(registry=)`` (JAX ``speculative.py:67``): the
    same greedy run through both functions, each into its own registry;
    the registries' Prometheus text is equal byte for byte, and
    ``stats=`` with ``registry=`` is refused."""
    from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry as TRegistry

    jt, tp, tt, jd, dp, td = setup
    ids = _ids(3, seed=4)
    jreg, treg = MetricsRegistry(), TRegistry()
    jspeculative_generate(jt, tp, jd, dp, jnp.asarray(ids), max_new_tokens=NEW, gamma=3,
                          registry=jreg)
    speculative_generate(tt, td, ids, NEW, gamma=3, registry=treg)
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert "spec_rounds" in treg.prometheus_text()
    with pytest.raises(ValueError, match="not both"):
        speculative_generate(tt, td, ids, 4, stats=SpecStats(), registry=TRegistry())


def test_spec_stats_percentiles_follow_the_registry_histogram():
    reg = MetricsRegistry()
    want, got = JSpecStats(reg), SpecStats()
    for a in [0, 0, 1, 4, 4, 2, 3, 4, 0, 1, 4, 4]:
        want.record_round(a, 4, consumed=min(a, 2))
        got.record_round(a, 4, consumed=min(a, 2))
    assert got.snapshot() == want.snapshot()
    assert SpecStats().snapshot() == JSpecStats(MetricsRegistry()).snapshot()


@pytest.mark.parametrize("eps", [0.0, 0.3])
def test_early_exit_draft_params_match_jax_leaf_for_leaf(setup, eps):
    jt, tp, tt, _, _, _ = setup
    cfg = tt.config
    jtarget, jdraft = jearly_exit(tp, cfg.num_layers, 1, eps)
    want_t = flax_to_torch(_np_tree(jtarget), cfg)
    want_d = flax_to_torch(_np_tree(jdraft), tllama.tiny_llama(num_layers=1))
    sd = flax_to_torch(_np_tree(tp), cfg)
    before = {k: v.clone() for k, v in sd.items()}
    got_t, got_d = tllama.early_exit_draft_params(sd, cfg.num_layers, 1, eps)
    assert got_t.keys() == want_t.keys() and got_d.keys() == want_d.keys()
    for got, want in ((got_t, want_t), (got_d, want_d)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(sd[k], before[k]) for k in sd)  # scaled into new tensors
    assert all(got_d[k] is sd[k] for k in got_d)
    with pytest.raises(ValueError, match="draft_layers"):
        tllama.early_exit_draft_params(sd, cfg.num_layers, cfg.num_layers, eps)


def test_early_exit_draft_models_share_the_targets_tensors(setup):
    """The model form: the draft's tensors ARE the target's (no copy), the
    source model keeps its bits, and at eps = 0 target and draft are the
    same function."""
    _, _, tt, _, _, _ = setup
    before = {k: v.clone() for k, v in tt.state_dict().items()}
    target, draft = tllama.early_exit_draft(tt, 1, 0.0)
    src = dict(tt.named_parameters())
    for name, p in draft.named_parameters():
        assert p is src[name], name
    scaled = {n for n, p in target.named_parameters() if p is not src[n]}
    assert scaled == {f"model.layers.{i}.{w}.weight" for i in range(1, 4)
                      for w in ("attn.o_proj", "mlp.down_proj")}
    assert target.model.freqs is tt.model.freqs and draft.device == tt.device
    assert all(torch.equal(v, before[k]) for k, v in tt.state_dict().items())
    ids = torch.from_numpy(_ids(2)).long()
    assert torch.equal(target(ids), draft(ids))
    assert not torch.equal(tt(ids), draft(ids))


def _validity(seed, b=3, L=32):
    return torch.from_numpy(np.random.default_rng(seed).random((b, L)) < 0.7)


@pytest.mark.parametrize("start", [0, 9, 30])
def test_invalidate_cache_window_matches_jax_row_cache(start):
    valid = _validity(start)
    keep = torch.tensor([0, 2, 4])
    want = np.asarray(jinvalidate({"kv_valid": jnp.asarray(valid.numpy())}, jnp.int32(start),
                                  jnp.asarray(keep.numpy(), jnp.int32))["kv_valid"])
    k = torch.randn(2, 3, 32, 1, 4)
    cache = KVCache(k.clone(), k.clone(), valid.clone())
    cache.index = start
    invalidate_cache_window(cache, cache.cursor, keep)  # the device cursor as the start
    np.testing.assert_array_equal(cache.valid.numpy(), want)
    assert torch.equal(cache.k, k) and torch.equal(cache.v, k)  # K/V untouched
    again = KVCache(k, k, torch.from_numpy(want.copy()))
    invalidate_cache_window(again, start, keep)  # only ever narrows: idempotent
    np.testing.assert_array_equal(again.valid.numpy(), want)


@pytest.mark.parametrize("start", [4, 20])
def test_invalidate_cache_window_matches_jax_paged_cache_and_view(start):
    """A paged cache's logical validity (``valid`` = ``row_valid``), and a
    slot VIEW whose column 0 is logical column 8: its ``valid`` and
    ``row_valid`` are different tensors, the clear must land in the whole
    row K5 reads, at the view's columns shifted by 8, in that row alone."""
    valid = _validity(start + 1)
    keep = torch.tensor([1, 0, 3])
    want = np.asarray(jinvalidate({"kv_valid": jnp.asarray(valid.numpy())}, jnp.int32(start),
                                  jnp.asarray(keep.numpy(), jnp.int32))["kv_valid"])
    pool = torch.randn(2, 13, 8, 1, 4)
    table = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    cache = PagedKVCache(pool.clone(), pool.clone(), valid.clone(), table, 8)
    invalidate_cache_window(cache, torch.tensor(start), keep)
    np.testing.assert_array_equal(cache.row_valid.numpy(), want)
    assert torch.equal(cache.k, pool)

    cache = PagedKVCache(pool.clone(), pool.clone(), valid.clone(), table, 8)
    view = cache.view(slice(1, 2), 8)
    assert view.valid is not view.row_valid and view.valid.shape[1] == 24
    invalidate_cache_window(view, torch.tensor(start - 8), keep[1:2])
    expect = valid.clone()
    expect[1] = torch.from_numpy(
        np.array(jinvalidate({"kv_valid": jnp.asarray(valid.numpy()[1:2])}, jnp.int32(start),
                               jnp.asarray(keep.numpy()[1:2], jnp.int32))["kv_valid"])[0])
    assert torch.equal(cache.row_valid, expect)
    assert torch.equal(view.valid, expect[1:2, 8:])
