"""The port's Medusa tree decoding against the JAX package (CPU, fp32,
tiny_llama with 3 heads, as ``tests/inference/test_medusa.py``).

Both models carry the same weights (``medusa_flax_to_torch``). Held to JAX:
the tree buffers (identical arrays, the same errors), candidates and greedy
posteriors (identical integers), the train-mode logits and Medusa logits,
one tree-verify decode forward after a rolled-back window step, the masked
tree attention, ``medusa_generate``'s tokens and ``mean_accepted`` at B = 1
and B = 3 with random heads and with heads trained on the base's own
greedy text (which accept long chains, so the multi-token advance and the
tree columns left past the cursor are exercised), the head loss and its
gradients, and six head-only AdamW steps against ``optax.adam``. Held to
the port: ``medusa_generate`` = greedy ``generate`` over many rounds, the
round through ``DecodeProgram`` = the round called directly, a warm-up
before every round leaves no trace, the round reads nothing on the host,
and the verify runs no Medusa head.

Tolerances: fp32 logits 2e-4 absolute (``test_torch_llama.py``: XLA and
PyTorch sum in different orders over 4 layers); tree attention 1e-5
(one layer, one softmax); the head loss 1e-5 relative and its gradients
1e-5 absolute (gradient entries up to ~0.05); the AdamW curve 1e-4
relative (six steps of lr 1e-2 on heads whose fp32 gradients differ in
the last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.inference.medusa import medusa_generate as jmedusa_generate
from neuronx_distributed_tpu.inference.speculative import _set_cache_index
from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.models.medusa import MedusaForCausalLM as JMedusa
from neuronx_distributed_tpu.models.medusa import medusa_head_loss as jmedusa_head_loss
from neuronx_distributed_tpu.modules.attention import decode_attention as jdecode_attention
from neuronx_distributed_tpu.utils import medusa as jmu
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
from neuronx_distributed_tpu_torch.inference.medusa import (
    DEFAULT_CHOICES,
    MedusaStats,
    medusa_generate,
    medusa_program,
    medusa_round,
    tree_attention_mask,
)
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import medusa_flax_to_torch
from neuronx_distributed_tpu_torch.models.medusa import (
    MedusaForCausalLM,
    init_medusa_heads,
    medusa_head_loss,
)
from neuronx_distributed_tpu_torch.modules.attention import decode_attention
from neuronx_distributed_tpu_torch.trainer.trainer import AdamW
from neuronx_distributed_tpu_torch.utils import medusa as tmu
from test_torch_decode_program import no_host_reads
from test_torch_llama import _np_tree

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS, S, NEW = 3, 8, 10
ATOL = 2e-4
OTHER_TREES = (
    ((0,), (0, 0), (0, 0, 0), (0, 0, 0, 0), (1,), (0, 1), (1, 0), (0, 1, 0)),
    ((2,), (0,), (1,), (3,), (0,)),  # a duplicate path, one level
)


def _build(scan_layers=False, seed=1):
    jcfg = jllama.tiny_llama(scan_layers=scan_layers)
    jmodel = JMedusa(jcfg, num_medusa_heads=HEADS, attention_impl="xla")
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, S), jnp.int32)))
    tcfg = tllama.tiny_llama()
    tmodel = MedusaForCausalLM(tcfg, HEADS, device="cpu")
    tmodel.load_state_dict(medusa_flax_to_torch(_np_tree(params), tcfg, HEADS))
    return jmodel, {"params": params["params"]}, tmodel


def _base_of(tmodel):
    """A LlamaForCausalLM holding ``tmodel``'s backbone and LM head."""
    base = tllama.LlamaForCausalLM(tmodel.config, device="cpu")
    base.load_state_dict({k: v for k, v in tmodel.state_dict().items()
                          if not k.startswith("medusa")})
    return base


def _ids(b, seed=0):
    return np.random.default_rng(seed).integers(1, 256, size=(b, S)).astype(np.int32)


def _train_heads(tmodel, ids, steps, lr=1e-2, new=60):
    """Heads trained over ``tmodel``'s base on the base's own greedy
    continuation of ``ids`` (self-distillation), by the port's AdamW at
    weight decay 0; returns the trained model."""
    base = _base_of(tmodel)
    seq = torch.cat([torch.from_numpy(ids).long(),
                     generate(base, ids, GenerationConfig(new, temperature=0.0))], dim=1)
    trained = MedusaForCausalLM(tmodel.config, HEADS, trainable=True, base=base)
    trained.load_state_dict(tmodel.state_dict(), strict=False)
    heads = trained.head_parameters()
    opt = AdamW(lr, weight_decay=0.0)
    state = opt.init(heads)
    for _ in range(steps):
        loss = medusa_head_loss(trained, seq, torch.roll(seq, -1, dims=1))
        opt.update(heads, torch.autograd.grad(loss, heads), state)
    return trained


def _heads_to_flax(params, tmodel):
    """``params`` with the Medusa heads replaced by ``tmodel``'s."""
    tree = dict(params["params"])
    sd = tmodel.state_dict()
    for i in range(HEADS):
        tree[f"medusa_{i}"] = {"proj": {
            "kernel": jnp.asarray(sd[f"medusa_{i}.proj.weight"].detach().numpy().T),
            "bias": jnp.asarray(sd[f"medusa_{i}.proj.bias"].detach().numpy())}}
        tree[f"medusa_head_{i}"] = {
            "kernel": jnp.asarray(sd[f"medusa_head_{i}.weight"].detach().numpy().T)}
    return {"params": tree}


@pytest.fixture(scope="module")
def setup():
    jmodel, params, tmodel = _build()
    trained = _train_heads(tmodel, _ids(1), steps=12)
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, base=_base_of(tmodel),
                trained=trained, tparams=_heads_to_flax(params, trained))


# --- utils/medusa.py -------------------------------------------------------------

@pytest.mark.parametrize("tree", [DEFAULT_CHOICES, *OTHER_TREES])
@pytest.mark.parametrize("top_k", [4, 10])
def test_buffers_are_identical_arrays(tree, top_k):
    want = jmu.generate_medusa_buffers(tree, top_k=top_k)
    got = tmu.generate_medusa_buffers(tree, top_k=top_k)
    assert got.keys() == want.keys() and got["top_k"] == want["top_k"]
    for name in ("attn_mask", "tree_indices", "position_ids", "retrieve_indices"):
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("tree,top_k", [((), 10), (((0,), (4,)), 4), (((0, 1),), 10)])
def test_buffer_errors_equal_jax(tree, top_k):
    with pytest.raises(ValueError) as want:
        jmu.generate_medusa_buffers(tree, top_k=top_k)
    with pytest.raises(ValueError) as got:
        tmu.generate_medusa_buffers(tree, top_k=top_k)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tree", [DEFAULT_CHOICES, *OTHER_TREES])
def test_candidates_and_posterior_equal_jax(tree):
    rng = np.random.default_rng(4)
    b, v = 3, 50
    buffers = jmu.generate_medusa_buffers(tree, top_k=4)
    heads = int(buffers["position_ids"].max())
    med = rng.standard_normal((b, heads, v)).astype(np.float32)
    base = rng.integers(0, v, size=b).astype(np.int32)
    jtree, jcands = jmu.generate_candidates(jnp.asarray(base), jnp.asarray(med), buffers)
    ttree, tcands = tmu.generate_candidates(torch.from_numpy(base), torch.from_numpy(med),
                                            tmu.generate_medusa_buffers(tree, top_k=4))
    np.testing.assert_array_equal(ttree.numpy(), np.asarray(jtree))
    np.testing.assert_array_equal(tcands.numpy(), np.asarray(jcands))
    # posterior: candidates that follow the logits' argmax with a few breaks
    leaves, dp1 = jcands.shape[1], jcands.shape[2]
    logits = rng.standard_normal((b, leaves, dp1, v)).astype(np.float32)
    cands = np.asarray(jcands).copy()
    cands[..., 1:] = np.where(rng.random(cands[..., 1:].shape) < 0.7,
                              logits.argmax(-1)[..., :-1], cands[..., 1:])
    jbest, jacc = jmu.evaluate_posterior_greedy(jnp.asarray(logits), jnp.asarray(cands))
    tbest, tacc = tmu.evaluate_posterior_greedy(torch.from_numpy(logits), torch.from_numpy(cands))
    np.testing.assert_array_equal(tbest.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert tacc.max() > 0


def test_buffers_on_device_give_the_same_candidates():
    rng = np.random.default_rng(5)
    buffers = tmu.generate_medusa_buffers(DEFAULT_CHOICES)
    med = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    base = torch.tensor([3, 7])
    a = tmu.generate_candidates(base, med, buffers)
    b = tmu.generate_candidates(base, med, tmu.medusa_buffers_on(buffers, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --- models/medusa.py, convert.py ---------------------------------------------------

@pytest.mark.parametrize("scan_layers", [False, True])
def test_train_mode_logits_and_heads_equal_jax(scan_layers):
    jmodel, params, tmodel = _build(scan_layers=scan_layers, seed=3)
    ids = np.random.default_rng(2).integers(1, 256, size=(2, 12)).astype(np.int32)
    jlogits, jmed = jmodel.apply(params, jnp.asarray(ids))
    logits, med = tmodel(torch.from_numpy(ids).long())
    assert med.shape == (2, 12, HEADS, 256)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(med.detach().numpy(), np.asarray(jmed), atol=ATOL, rtol=0)


def test_medusa_over_a_base_shares_its_tensors(setup):
    base = setup["base"]
    m = MedusaForCausalLM(base.config, 4, base=base, trainable=True)
    assert m.model is base.model and m.lm_head is base.lm_head
    assert m.model.layers[0].mlp.up_proj.weight.data_ptr() == \
        base.model.layers[0].mlp.up_proj.weight.data_ptr()
    heads = m.head_parameters()
    assert len(heads) == 4 * 3 and all(p.requires_grad and p.dtype == torch.float32
                                       for p in heads)
    assert not any(p.requires_grad for p in base.parameters())
    before = {k: v.clone() for k, v in base.state_dict().items()}
    init_medusa_heads(m, seed=5)
    assert all(torch.equal(v, base.state_dict()[k]) for k, v in before.items())
    with pytest.raises(ValueError, match="config"):
        MedusaForCausalLM(tllama.tiny_llama(num_layers=2), 4, base=base)


# --- the tree-verify forward and its attention ----------------------------------------

def test_tree_decode_attention_equals_jax():
    rng = np.random.default_rng(6)
    b, s, h, hkv, d, L = 2, 5, 8, 2, 16, 40
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, L, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, L, hkv, d)).astype(np.float32)
    mask = rng.random((s, L)) < 0.4
    mask[3] = False  # a row with nothing to attend gives 0
    valid = rng.random((b, L)) < 0.8
    pos = np.arange(20, 20 + s, dtype=np.int32)
    want = jdecode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                             mask=jnp.asarray(mask), kv_valid=jnp.asarray(valid))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos), kv_valid=torch.from_numpy(valid),
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[:, 3].any()


def _tree_attention_f64(q, k, v, mask, valid):
    """The masked attention in float64 on the same values, and P|V (the
    softmax-weighted size of what each row averages)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bshgd,blhd->bhgsl", qg, k.double()) / d ** 0.5
    ok = (mask[None] & valid[:, None])[:, None, None]
    p = torch.softmax(scores.masked_fill(~ok, -1e300), dim=-1) * ok.any(-1, keepdim=True)
    out = torch.einsum("bhgsl,blhd->bshgd", p, v.double()).reshape(b, s, h, d)
    pv = torch.einsum("bhgsl,blhd->bshgd", p, v.double().abs()).reshape(b, s, h, d)
    return out, pv


@pytest.mark.parametrize("b", [1, 3])
def test_tree_decode_attention_on_a_bf16_cache(b):
    """The card's operand path on the CPU: bf16 q and cache, scores as f32
    sums and P as bf16 hi + lo in P·V, held to float64 on the same values.
    Limit, elementwise: 2^-7 |ref| (the bf16 output's rounding, with room)
    + 2^-12 P|V| (P's hi + lo split and f32 sums) + 1e-5."""
    gen = torch.Generator().manual_seed(b)
    s, h, hkv, d, L = 8, 16, 4, 32, 300
    q, k, v = (torch.randn(*shape, generator=gen).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, L, hkv, d), (b, L, hkv, d)))
    mask = torch.rand(s, L, generator=gen) < 0.7
    valid = torch.rand(b, L, generator=gen) < 0.9
    got = decode_attention(q, k, v, torch.arange(s), kv_valid=valid, mask=mask)
    want, pv = _tree_attention_f64(q, k, v, mask, valid)
    assert got.dtype == torch.bfloat16
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -12 * pv + 1e-5
    assert float(((got.double() - want).abs() / limit).max()) <= 1.0


def _jax_tree_mask(cur, node_mask, L):
    """The JAX round's mask formula (``inference/medusa.py:118-126``)."""
    n = node_mask.shape[0]
    k_pos = jnp.arange(L)
    prefix_ok = k_pos[None, :] < cur
    in_tree = (k_pos[None, :] >= cur) & (k_pos[None, :] < cur + n)
    tree_cols = jnp.clip(k_pos[None, :] - cur, 0, n - 1)
    node_ok = jnp.take_along_axis(jnp.asarray(node_mask), tree_cols.repeat(n, 0), axis=1)
    return prefix_ok | (in_tree & node_ok)


def test_tree_verify_forward_equals_jax(setup):
    """Prefill, a 4-token window step rolled back to n_in = 2 (JAX's
    ``_set_cache_index``; the port's cursor), then one tree-verify decode
    forward with per-node positions and the tree mask, on both."""
    jmodel, params, tmodel = setup["jmodel"], setup["params"], setup["tmodel"]
    ids = _ids(2, seed=8)
    window = np.random.default_rng(9).integers(1, 256, size=(2, 4)).astype(np.int32)
    buffers = tmu.generate_medusa_buffers(DEFAULT_CHOICES)
    n = buffers["attn_mask"].shape[0]
    tree = np.random.default_rng(10).integers(1, 256, size=(2, n)).astype(np.int32)
    cur = S + 2
    L = tmodel.config.max_seq_len
    node_pos = cur + buffers["position_ids"]

    _, v = jmodel.clone(mode="prefill").apply(params, jnp.asarray(ids), mutable=["cache"])
    decode = jmodel.clone(mode="decode")
    _, v = decode.apply({**params, "cache": v["cache"]}, jnp.asarray(window), mutable=["cache"])
    cache = _set_cache_index(v["cache"], cur)
    (jlogits, _), _ = decode.apply({**params, "cache": cache}, jnp.asarray(tree),
                                   positions=jnp.asarray(node_pos),
                                   attn_mask=_jax_tree_mask(cur, buffers["attn_mask"], L),
                                   mutable=["cache"])

    tcache = tmodel.new_cache(2)
    with torch.no_grad():
        tmodel.model(torch.from_numpy(ids).long(), "prefill", tcache)
        tmodel.model(torch.from_numpy(window).long(), "decode", tcache)
        tcache.index = cur
        mask = tree_attention_mask(torch.tensor(cur), torch.from_numpy(buffers["attn_mask"]),
                                   torch.arange(L))
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(_jax_tree_mask(cur, buffers["attn_mask"], L)))
        logits, _ = tmodel(torch.from_numpy(tree).long(), "decode", tcache,
                           positions=torch.from_numpy(node_pos).long(), attn_mask=mask)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert int(tcache.cursor) == cur + n  # the forward advanced the cursor by s


# --- medusa_generate --------------------------------------------------------------------

@pytest.mark.parametrize("heads", ["random", "trained"])
@pytest.mark.parametrize("b", [1, 3])
def test_medusa_generate_equals_jax_and_greedy(setup, heads, b):
    model = setup["tmodel"] if heads == "random" else setup["trained"]
    params = setup["params"] if heads == "random" else setup["tparams"]
    ids = _ids(b)  # row 0 is the trained heads' prompt
    want, jacc = jmedusa_generate(setup["jmodel"], params, jnp.asarray(ids), max_new_tokens=NEW)
    got, acc = medusa_generate(model, ids, NEW)
    assert got.shape == (b, NEW) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, generate(setup["base"], ids, GenerationConfig(NEW, temperature=0.0)))
    assert acc == pytest.approx(float(jacc), abs=1e-12)
    if heads == "trained" and b == 1:
        assert acc > 1.0
    if b > 1:
        row, _ = medusa_generate(model, ids[:1], NEW)
        assert torch.equal(got[:1], row)


def test_many_rounds_equal_greedy_generate(setup):
    """60 tokens at B = 1 and B = 3 with the trained heads: rounds emit 1..4
    tokens, leaving tree columns of every length past the cursor; the
    stream must stay the base's greedy one."""
    for b in (1, 3):
        ids = _ids(b)
        stats = MedusaStats()
        got, acc = medusa_generate(setup["trained"], ids, 60, stats=stats)
        assert torch.equal(got, generate(setup["base"], ids, GenerationConfig(60,
                                                                           temperature=0.0)))
        assert sum(stats.emitted) + 1 >= 60 and len(stats.accept_lens) == len(stats.emitted)
        if b == 1:
            assert len(set(stats.emitted)) > 1 and max(stats.emitted) == 4, stats.emitted
        assert acc == pytest.approx(np.mean([np.mean(a) for a in stats.accept_lens]))


def test_overflow_guard(setup):
    with pytest.raises(ValueError, match="max_seq_len"):
        medusa_generate(setup["tmodel"], _ids(1), 10_000)
    # the last length that fits: prompt + new + depth + nodes == max_seq_len
    fits = setup["tmodel"].config.max_seq_len - S - 3 - 8
    with pytest.raises(ValueError, match="max_seq_len"):
        medusa_generate(setup["tmodel"], _ids(1), fits + 1)
    got, _ = medusa_generate(setup["trained"], _ids(1), fits)
    with pytest.raises(ValueError, match="needs 4 Medusa heads"):  # a pool gather out of range
        medusa_generate(setup["trained"], _ids(1), NEW, choices=OTHER_TREES[0])
    assert torch.equal(got, generate(setup["base"], _ids(1), GenerationConfig(fits,
                                                                         temperature=0.0)))


def _round_setup(model, ids):
    """A prefilled cache and the round's buffers at the first round."""
    cache = model.new_cache(ids.shape[0])
    buffers = tmu.medusa_buffers_on(tmu.generate_medusa_buffers(DEFAULT_CHOICES), "cpu")
    chain = torch.zeros((ids.shape[0], 4), dtype=torch.int64)
    with torch.no_grad():
        x = model.model(torch.from_numpy(ids).long(), "prefill", cache)
        chain[:, 0] = torch.argmax(model.lm_head(x[:, -1]), dim=-1)
    return cache, buffers, chain, torch.ones((), dtype=torch.int64), torch.zeros(
        ids.shape[0], dtype=torch.int64)


def test_program_round_equals_direct_round(setup):
    """Three rounds through ``DecodeProgram`` (eager on the CPU) and through
    the round's callable directly give the same chains, acceptances,
    cursors and caches."""
    out = []
    for via_program in (True, False):
        cache, buffers, chain, n_in, accept = _round_setup(setup["trained"], _ids(2))
        prog = medusa_program(setup["trained"], cache, buffers, n_in, chain, accept)
        run = medusa_round(setup["trained"], cache, buffers, n_in, chain, accept)
        assert isinstance(prog, DecodeProgram) and prog.device.type == "cpu"
        seen = []
        for _ in range(3):
            prog() if via_program else run()
            seen.append((chain.clone(), accept.clone(), int(cache.cursor)))
            n_in.fill_(int(accept.min()) + 1)
        out.append((seen, cache.k.clone(), cache.v.clone(), cache.valid.clone()))
        assert prog.captures == prog.replays == 0
    (a, *ca), (b, *cb) = out
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) and x[2] == y[2]
               for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    assert a[0][2] == S + 1  # the cursor ends at the first column + n_in


def test_warmup_before_every_round_leaves_no_trace(setup, monkeypatch):
    """The warm-up the card runs once before capture, here run before EVERY
    round: the cursor and the columns below it are left as they were, and
    the tokens and acceptance are unchanged (the chain, the next round's
    window, was restored)."""
    ids = _ids(3)
    want, wacc = medusa_generate(setup["trained"], ids, 30)
    real, real_new_cache = DecodeProgram.__call__, MedusaForCausalLM.new_cache
    caches, starts = [], []

    def keep_cache(self, b):
        caches.append(real_new_cache(self, b))
        return caches[-1]

    def warm_then_round(self):
        cache = caches[-1]
        cur = int(cache.cursor)
        below = (cache.k[:, :, :cur].clone(), cache.v[:, :, :cur].clone(),
                 cache.valid[:, :cur].clone())
        self._warmup()
        assert int(cache.cursor) == cur
        assert all(torch.equal(x, y) for x, y in zip(
            below, (cache.k[:, :, :cur], cache.v[:, :, :cur], cache.valid[:, :cur])))
        starts.append(cur)
        real(self)

    monkeypatch.setattr(MedusaForCausalLM, "new_cache", keep_cache)
    monkeypatch.setattr(DecodeProgram, "__call__", warm_then_round)
    stats = MedusaStats()
    got, acc = medusa_generate(setup["trained"], ids, 30, stats=stats)
    assert torch.equal(got, want) and acc == wacc
    # round i starts where round i-1 left its cursor: its first column + n_in
    assert starts == [S] + [S + 1 + sum(stats.emitted[:i - 1]) for i in range(1, len(starts))]


def test_round_reads_nothing_and_runs_no_head_in_the_verify(setup, monkeypatch):
    real = DecodeProgram.__call__
    real_head = MedusaForCausalLM.head_logits
    calls, rounds = [], []

    def guarded(self):
        with no_host_reads():
            real(self)
        rounds.append(1)

    def counting(self, i, x):
        calls.append(tuple(x.shape))
        return real_head(self, i, x)

    monkeypatch.setattr(DecodeProgram, "__call__", guarded)
    monkeypatch.setattr(MedusaForCausalLM, "head_logits", counting)
    got, _ = medusa_generate(setup["trained"], _ids(2), NEW)
    assert torch.equal(got, generate(setup["base"], _ids(2), GenerationConfig(NEW,
                                                                        temperature=0.0)))
    # each round: the heads once each, on the gathered slot alone
    assert rounds and calls == [(2, 1, 64)] * (HEADS * len(rounds))


# --- head training ------------------------------------------------------------------------

def _head_tree(params):
    return {k: v for k, v in params["params"].items() if k.startswith("medusa")}


def _loss_setup(setup):
    ids = np.random.default_rng(12).integers(1, 256, size=(2, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    base = setup["params"]["params"]
    heads = _head_tree(setup["params"])
    frozen = {k: v for k, v in base.items() if not k.startswith("medusa")}

    def jloss(h):
        return jmedusa_head_loss(setup["jmodel"], {"params": {**frozen, **h}}, jnp.asarray(ids),
                                 jnp.asarray(labels))

    tmodel = MedusaForCausalLM(setup["tmodel"].config, HEADS, trainable=True,
                               base=_base_of(setup["tmodel"]))
    tmodel.load_state_dict(setup["tmodel"].state_dict(), strict=False)
    return ids, labels, heads, jloss, tmodel


def test_head_loss_and_gradients_equal_jax(setup):
    ids, labels, heads, jloss, tmodel = _loss_setup(setup)
    want, jgrads = jax.value_and_grad(jloss)(heads)
    loss = medusa_head_loss(tmodel, torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    loss.backward()
    for i in range(HEADS):
        pairs = ((f"medusa_{i}.proj.weight", jgrads[f"medusa_{i}"]["proj"]["kernel"], True),
                 (f"medusa_{i}.proj.bias", jgrads[f"medusa_{i}"]["proj"]["bias"], False),
                 (f"medusa_head_{i}.weight", jgrads[f"medusa_head_{i}"]["kernel"], True))
        for name, g, kernel in pairs:
            g = np.asarray(g)
            got = tmodel.get_parameter(name).grad.numpy()
            np.testing.assert_allclose(got, g.T if kernel else g, atol=1e-5, rtol=0)
    assert not any(p.grad is not None for p in tmodel.model.parameters())


def test_six_adam_steps_equal_optax_and_leave_the_base(setup):
    ids, labels, heads, jloss, tmodel = _loss_setup(setup)
    opt = optax.adam(1e-2)
    state = opt.init(heads)
    jlosses = []
    for _ in range(6):
        loss, g = jax.value_and_grad(jloss)(heads)
        jlosses.append(float(loss))
        updates, state = opt.update(g, state, heads)
        heads = optax.apply_updates(heads, updates)

    base_before = {k: v.clone() for k, v in tmodel.state_dict().items()
                   if not k.startswith("medusa")}
    params = tmodel.head_parameters()
    adam = AdamW(1e-2, weight_decay=0.0)
    ostate = adam.init(params)
    losses = []
    x, y = torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
    for _ in range(6):
        loss = medusa_head_loss(tmodel, x, y)
        losses.append(float(loss))
        adam.update(params, torch.autograd.grad(loss, params), ostate)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    after = tmodel.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in base_before.items())
