"""The port's ``generate`` and its helpers against the JAX reference
(CPU, fp32, tiny_llama). Greedy token streams must be IDENTICAL: the logits
agree to ~1e-5 (see test_torch_llama.py), far inside the argmax margins of
these seeded inputs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference import generate as tgen
from neuronx_distributed_tpu_torch.utils import sampling
from test_torch_llama import build_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the JAX package's `inference` re-exports the function `generate` under the
# module's name
jgen = importlib.import_module("neuronx_distributed_tpu.inference.generate")


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=11)


def _left_padded(rng, lengths, s, vocab=256):
    ids = np.zeros((len(lengths), s), np.int32)
    mask = np.zeros((len(lengths), s), bool)
    for i, n in enumerate(lengths):
        ids[i, s - n:] = rng.integers(1, vocab, size=n)
        mask[i, s - n:] = True
    return ids, mask


@pytest.mark.parametrize("eos", [None, "from_stream"])
def test_greedy_generate_matches_jax_on_left_padded_batch(pair, eos):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(7)
    ids, mask = _left_padded(rng, [9, 4, 6], 9)
    cfg = jgen.GenerationConfig(max_new_tokens=10, temperature=0.0)
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), jax.random.PRNGKey(0),
                                    cfg, attention_mask=jnp.asarray(mask)))
    eos_id = None
    if eos == "from_stream":
        eos_id = int(want[1, 3])  # ends row 1 mid-stream
        cfg = jgen.GenerationConfig(max_new_tokens=10, temperature=0.0, eos_token_id=eos_id)
        want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), jax.random.PRNGKey(0),
                                        cfg, attention_mask=jnp.asarray(mask)))
    got = tgen.generate(tmodel, ids, tgen.GenerationConfig(max_new_tokens=10, temperature=0.0,
                                                           eos_token_id=eos_id),
                        attention_mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,padded,side", [(3, 8, "left"), (3, 8, "right"), (8, 8, "left"),
                                           (1, 4, "right")])
def test_pack_padded_prompt_matches_jax(n, padded, side):
    toks = np.arange(1, n + 1)
    for a, b in zip(tgen.pack_padded_prompt(toks, padded, side),
                    jgen.pack_padded_prompt(toks, padded, side)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("bad", [(9, 8, "left"), (3, 8, "middle")])
def test_pack_padded_prompt_rejects_like_jax(bad):
    n, padded, side = bad
    with pytest.raises(ValueError) as te:
        tgen.pack_padded_prompt(np.arange(n), padded, side)
    with pytest.raises(ValueError) as je:
        jgen.pack_padded_prompt(np.arange(n), padded, side)
    assert str(te.value) == str(je.value)


def test_validate_generate_args_matches_jax(pair):
    jmodel, _, tmodel = pair
    ok = np.ones((2, 5), bool)
    right_padded = ok.copy()
    right_padded[1, -1] = False
    cases = [
        (np.ones((2, 100), np.int32), 40, None),     # past max_seq_len
        (np.ones((2, 5), np.int32), 4, np.ones((2, 4), bool)),  # shape mismatch
        (np.ones((2, 5), np.int32), 4, right_padded),
        (np.ones((2, 5), np.int32), 4, ok),          # valid
    ]
    for ids, new, mask in cases:
        errs = []
        for fn, model, m in ((tgen.validate_generate_args, tmodel, mask),
                             (jgen.validate_generate_args, jmodel,
                              None if mask is None else jnp.asarray(mask))):
            try:
                fn(model, ids, new, m)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


def test_sample_and_sample_per_row_agree():
    """Python-config ``sample`` and the per-row sampler draw identical
    tokens for the same (seed, index) — the engine-vs-generate invariant."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(4, 300)).astype(np.float32)) * 3
    seeds = torch.tensor([5, 6, 7, 8])
    for temp, k, p in [(0.0, None, None), (1.0, None, None), (0.7, 20, None),
                       (1.3, None, 0.8), (0.9, 50, 0.9)]:
        a = sampling.sample(logits, seeds, 4, temp, k, p)
        b = sampling.sample_per_row(
            logits, seeds, 4, torch.full((4,), temp),
            torch.full((4,), k or 0), torch.full((4,), p or 1.0))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        for r in range(4):
            c = sampling.sample_row(logits[r], int(seeds[r]), 4, temp, k or 0, p or 1.0)
            assert int(c) == int(a[r])


def test_gumbel_noise_depends_only_on_seed_and_index():
    n1 = sampling.gumbel_noise(torch.tensor([1, 2, 3]), torch.tensor([0, 5, 9]), 64)
    n2 = sampling.gumbel_noise(torch.tensor([3]), 9, 64)
    torch.testing.assert_close(n1[2:], n2, rtol=0, atol=0)
    assert not torch.equal(n1[0], n1[1])
    # a standard Gumbel has mean ~0.5772 (Euler's constant) and var pi^2/6
    big = sampling.gumbel_noise(torch.arange(64), 0, 4096)
    assert abs(float(big.mean()) - 0.5772) < 0.02
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.05
