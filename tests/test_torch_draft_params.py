"""A draft with weights of its own against the JAX package (CPU, fp32,
tiny_llama; weights from one seed through ``flax_to_torch``).

``ServingEngine(draft_model=, draft_params=)`` binds the draft's weights
into a draft module of the engine's own: never ``draft_model`` itself
(which may be the target, as in JAX's poisoned-draft test), no tensor
sharing storage with the target. Held here:

* JAX ``test_speculative_quantized_serving`` (``test_quantized_engine.py``
  :252): an int8 target beside an independent 2-layer float draft gives the
  greedy stream of the quantized spec-off engine, the port's and JAX's.
* JAX ``test_poisoned_draft_all_reject_streams_bit_identical``
  (``test_faults.py`` :329): a draft poisoned at every dispatch leaves the
  streams equal to solo ``generate`` (the port's and JAX's), its acceptance
  under 0.5 against the clean control's over 0.9; ``poisoned_drafts``
  counts it; the draft's bits are the clean ones afterwards.
* The draft setter (in place, refusing ``None``), a mid-flight draft swap on
  the same decode program, and the refusals for a draft that shares the
  target's tensors (the early-exit draft): the setter, ``poison_draft`` and
  ``quantize=``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.quantization.config import QuantConfig as JQuantConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.models.llama import early_exit_draft, shares_storage
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair
from test_torch_serving import _solo

jgen = importlib.import_module("neuronx_distributed_tpu.inference.generate")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    """The JAX suites' target (key 1) and 2-layer draft (key 7)."""
    jt, tp, tt = build_pair(seed=1)
    jd, dp, td = build_pair(seed=7, num_layers=2)
    return jt, tp, tt, jd, dp, td


def _greedy_workload(n=4, seed=17):
    """JAX ``test_faults.py``'s mix, made greedy (sampled slots accept
    nothing by design, which would dilute the acceptance contrast)."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 256, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]
    return prompts, [GenerationConfig(max_new_tokens=m, temperature=0.0)
                     for m in (10, 12, 8, 11)[:n]]


def _run(engine, prompts, gcfgs, seeds=None):
    reqs = [engine.submit(p, g, seed=500 + i if seeds is None else seeds[i])
            for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    return [list(r.tokens) for r in reqs]


def _jsolo(jm, params, prompt, seed, gcfg):
    jc = JGenerationConfig(max_new_tokens=gcfg.max_new_tokens, temperature=0.0)
    return np.asarray(jgen.generate(jm, params, jnp.asarray(prompt)[None],
                                    jax.random.PRNGKey(seed), jc))[0].tolist()


def test_speculative_quantized_serving(setup):
    """JAX ``test_speculative_quantized_serving``: the quantized target's
    verify beside a float draft of its own; the greedy stream equals the
    quantized spec-off engine's, the port's and the JAX engine's."""
    jt, tp, tt, jd, dp, td = setup
    prompts = [np.arange(1, 7, dtype=np.int32)]
    gcfgs = [GenerationConfig(max_new_tokens=12, temperature=0.0)]
    q = QuantConfig(weights="int8")
    off = _run(ServingEngine(tt, num_slots=2, decode_chunk_size=4, quantize=q), prompts, gcfgs)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=4, quantize=q, draft_model=td,
                           draft_params=td.state_dict(), gamma=3)
    assert engine.draft_model is not td and engine.draft_model.config.quantization is None
    assert not shares_storage(engine.draft_model, engine.model)
    assert not shares_storage(engine.draft_model, td)
    on = _run(engine, prompts, gcfgs)
    assert on == off
    assert engine.metrics.snapshot()["spec_rounds"] > 0
    jc = JGenerationConfig(max_new_tokens=12, temperature=0.0)
    jeng = JServingEngine(jt, tp, num_slots=2, decode_chunk_size=4,
                          quantize=JQuantConfig(weights="int8"))
    jr = jeng.submit(prompts[0], jc, key=jax.random.PRNGKey(500))
    jeng.run()
    assert [int(t) for t in jr.tokens] == on[0]


def test_poisoned_draft_all_reject_streams_bit_identical(setup):
    """The target as its own draft (``draft_model=model, draft_params=``
    its state dict, JAX's test): poisoned at every dispatch, the rounds
    all-reject and the streams stay those of solo ``generate``; the clean
    control accepts nearly everything; the draft's bits are its clean ones
    after the run."""
    jt, tp, tt = setup[:3]
    prompts, gcfgs = _greedy_workload()
    refs = [_solo(tt, p, g, 500 + i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    assert refs == [_jsolo(jt, tp, p, 500 + i, g)
                    for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    inj = FaultInjector().poison_draft(at=0, times=None)
    kw = dict(num_slots=2, decode_chunk_size=3, prefix_cache=None, draft_model=tt,
              draft_params=tt.state_dict(), gamma=3)
    engine = ServingEngine(tt, fault_injector=inj, **kw)
    clean = {k: v.clone() for k, v in engine.draft_params.items()}
    toks = _run(engine, prompts, gcfgs)
    assert inj.counters["poisoned_drafts"] > 0
    assert toks == refs
    snap = engine.metrics.snapshot()
    assert snap["spec_accept_rate"] < 0.5 and snap["draft_tokens_wasted"] > 0
    assert all(torch.equal(v, clean[k]) for k, v in engine.draft_params.items())
    assert all(torch.equal(v, tt.state_dict()[k]) for k, v in engine.params.items())
    control = ServingEngine(tt, **kw)
    assert _run(control, prompts, gcfgs) == toks
    assert control.metrics.snapshot()["spec_accept_rate"] > 0.9


def test_poison_window_and_counter(setup):
    """``poison_draft(at=1, times=1)`` poisons exactly the second dispatch
    attempt (JAX's attempt index, shared with ``fail_dispatch``)."""
    tt = setup[2]
    prompts, gcfgs = _greedy_workload(n=2)
    inj = FaultInjector().poison_draft(at=1, times=1)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, prefix_cache=None,
                           draft_model=tt, draft_params=tt.state_dict(), gamma=3,
                           fault_injector=inj)
    assert _run(engine, prompts, gcfgs) == [_solo(tt, p, g, 500 + i)
                                            for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    assert inj.counters["poisoned_drafts"] == 1


def test_own_draft_storage_and_residents(setup):
    """An own draft shares no storage with the target (by the addresses
    of their storages), and the ledger counts its bytes; the early-exit
    draft shares the target's and counts 0."""
    tt, td = setup[2], setup[5]
    own = ServingEngine(tt, num_slots=1, draft_model=td, draft_params=td.state_dict(), gamma=2)
    assert own.draft_model is not td and not shares_storage(own.draft_model, tt)
    nbytes = sum(t.numel() * t.element_size() for t in td.state_dict().values())
    assert own.hbm.snapshot()["residents"]["draft_params"]["bytes"] == nbytes
    target, draft = early_exit_draft(tt, 1, 0.0)
    assert shares_storage(draft, target) and shares_storage(draft, tt)
    alias = ServingEngine(target, num_slots=1, draft_model=draft, gamma=2)
    assert alias.hbm.snapshot()["residents"]["draft_params"]["bytes"] == 0
    # the target as its own draft: every tensor a copy
    both = ServingEngine(tt, num_slots=1, draft_model=tt, draft_params=tt.state_dict(), gamma=2)
    assert both.draft_model is not tt and not shares_storage(both.draft_model, tt)
    with pytest.raises(ValueError, match="draft_params needs draft_model"):
        ServingEngine(tt, num_slots=1, draft_params=td.state_dict())


def test_draft_setter_in_place_and_mid_flight(setup):
    """``engine.draft_params = sd`` copies into the draft's own tensors
    (addresses kept, the decode program the same object), refuses ``None``
    and a mismatched dict without writing; swapped mid-flight, between two
    steps, the streams still equal solo ``generate``."""
    tt, td = setup[2], setup[5]
    _, _, other = build_pair(seed=11, num_layers=2)
    prompts, gcfgs = _greedy_workload(n=3)
    refs = [_solo(tt, p, g, 500 + i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, prefix_cache=None,
                           draft_model=td, draft_params=td.state_dict(), gamma=3)
    ptrs = {k: t.data_ptr() for k, t in engine.draft_params.items()}
    td_bits = {k: v.clone() for k, v in td.state_dict().items()}  # the caller's draft
    program = engine.decode_program
    reqs = [engine.submit(p, g, seed=500 + i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.step()
    engine.step()
    engine.draft_params = other.state_dict()
    assert {k: t.data_ptr() for k, t in engine.draft_params.items()} == ptrs
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in engine.draft_params.items())
    assert all(torch.equal(v, td_bits[k]) for k, v in td.state_dict().items())
    engine.run()
    assert [list(r.tokens) for r in reqs] == refs
    assert engine.decode_program is program
    with pytest.raises(ValueError, match="cannot be unset"):
        engine.draft_params = None
    before = {k: v.clone() for k, v in engine.draft_params.items()}
    bad = dict(td.state_dict())
    bad.pop(list(bad)[-1])
    with pytest.raises(ValueError, match="missing"):
        engine.draft_params = bad
    assert all(torch.equal(v, before[k]) for k, v in engine.draft_params.items())


def test_poison_draft_scheduled_after_construction_is_refused(setup):
    """``poison_draft`` scheduled on an early-exit engine's injector after
    the engine was built is refused at the dispatch, before any tensor is
    written: the target's weights keep every bit (a poisoned aliasing draft
    would write the target's own layer 0, embedding and head)."""
    tt = setup[2]
    target, draft = early_exit_draft(tt, 1, 0.0)
    inj = FaultInjector()
    engine = ServingEngine(target, num_slots=1, draft_model=draft, gamma=2,
                           fault_injector=inj)
    before = {k: v.clone() for k, v in engine.params.items()}
    inj.poison_draft(at=0)
    engine.submit(np.arange(1, 7, dtype=np.int32),
                  GenerationConfig(max_new_tokens=6, temperature=0.0), seed=0)
    with pytest.raises(ValueError, match="shares the target's tensors.*draft_params="):
        engine.run()
    assert inj.counters["poisoned_drafts"] == 0
    assert all(torch.equal(v, before[k]) for k, v in engine.params.items())


def test_aliasing_draft_refusals(setup):
    """A draft that shares the target's tensors (the early-exit draft) takes
    no weights of its own: the draft setter, ``poison_draft`` and
    ``quantize=`` refuse it, each saying that ``draft_params=`` gives the
    draft tensors of its own; without those the engine serves it as
    before."""
    tt = setup[2]
    target, draft = early_exit_draft(tt, 1, 0.3)
    engine = ServingEngine(target, num_slots=1, draft_model=draft, gamma=2)
    with pytest.raises(ValueError, match="draft_params="):
        engine.draft_params = draft.state_dict()
    with pytest.raises(ValueError, match="draft_params="):
        ServingEngine(target, num_slots=1, draft_model=draft, gamma=2,
                      fault_injector=FaultInjector().poison_draft(at=0))
    with pytest.raises(ValueError, match="draft_params="):
        ServingEngine(tt, num_slots=1, draft_model=draft, gamma=2,
                      quantize=QuantConfig(weights="int8"))
    # with tensors of its own the same draft is served beside a quantized target
    own = ServingEngine(tt, num_slots=1, draft_model=draft, draft_params=draft.state_dict(),
                        gamma=2, quantize=QuantConfig(weights="int8"))
    assert not shares_storage(own.draft_model, tt)
