"""Program manifests and the warm spawn (``inference/aot.py``,
``ServingEngine.prewarm(manifest=, cache_dir=)``/``manifest()``/
``save_aot()``) against the JAX package's ``tests/serving/test_aot.py``
(:226 two engines' independent manifests replayed into a third, :256 the
codec's round trip, :289 an opaque leaf refused, :294 save and load; its
red cases :156, :190 and :209 are no oracles) and the prewarm host-read
budget of ``tests/serving/test_host_sync.py:382``. The JAX package's
manifest runs beside the port's on the same traffic: the programs both
name (prefill buckets, first token, slot write and clear, the decode chunk)
appear in both. Only the replayed rung exists in the port (no serialized
CUDA graph): ``deserialized`` stays empty. Kernel libraries in
``cache_dir`` whose source hash is not this tree's raise ``SkewError``."""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference import aot
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.kernels import _build
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=1)


def _fresh(tm, **kw):
    """JAX ``_fresh_engine``: 2 slots, chunk 4, no prefix cache, pages of 8."""
    kw.setdefault("kv_page_size", 8)
    return ServingEngine(tm, num_slots=2, decode_chunk_size=4, prefix_cache=None, **kw)


def _drive(engine, n_req=2, new_tokens=2, vocab=256):
    rng = np.random.RandomState(3)
    gcfg = GenerationConfig(max_new_tokens=new_tokens, temperature=0.0)
    reqs = [engine.submit(rng.randint(1, vocab, size=6).astype(np.int32), gcfg, seed=i)
            for i in range(n_req)]
    engine.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    return reqs


def _compiles(engine):
    return {n: i.compiles for n, i in engine.programs.programs().items()}


def test_two_engines_capture_independent_manifests(pair):
    """JAX :226: each engine's manifest has its own portable decode entry,
    and one replays into a third engine whose traffic then compiles
    nothing (every program's compiles unchanged; on the CPU the decode
    step's compile is its metered warm-up step)."""
    jm, jp, tm = pair
    e1, e2 = _fresh(tm), _fresh(tm)
    _drive(e1, n_req=1)
    _drive(e2, n_req=1)
    for eng in (e1, e2):
        entries = eng.manifest().entries("decode_chunk")
        assert entries and entries[0]["portable"], entries
    m2 = e2.manifest()
    e3 = _fresh(tm)
    rep = e3.prewarm(manifest=m2)
    assert "decode_chunk" in rep["replayed"] and not rep["skipped"], rep["skipped"]
    assert rep["deserialized"] == [] and set(rep["compiled"]) == set(rep["replayed"])
    before = _compiles(e3)
    assert e3.programs.programs()["decode_chunk"].prewarm_dispatches == 1
    _drive(e3, n_req=1)
    assert _compiles(e3) == before
    assert e3.decode_compilations == e1.decode_compilations  # 0 on the CPU, 1 on a card
    e3.cache.check()
    # the JAX engine names the same programs on the same traffic
    jeng = JServingEngine(jm, jp, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                          kv_page_size=8)
    rng = np.random.RandomState(3)
    jeng.submit(rng.randint(1, 256, size=6).astype(np.int32),
                JGenerationConfig(max_new_tokens=2, temperature=0.0), key=jax.random.PRNGKey(0))
    jeng.run()
    shared = {"decode_chunk", "prefill[8]", "first_token", "slot_write", "slot_clear"}
    jnames = {n for n in jeng.manifest().names() if jeng.manifest().entries(n)}
    pnames = {n for n in m2.names() if m2.entries(n)}
    assert shared <= jnames and shared <= pnames


def test_encode_materialize_roundtrip_pedigrees():
    """JAX :256: tensors stay tensors (shape, dtype), numpy stays numpy,
    static Python leaves replay their exact value."""
    args = (torch.ones(2, 3), np.arange(4, dtype=np.int32), 5, 7.5, [1, 2])
    kwargs = {"flag": True}
    node = aot.encode_call(args, kwargs)
    out_args, out_kwargs = aot.materialize_call(node)
    assert out_kwargs == {"flag": True} and len(out_args) == 5
    assert isinstance(out_args[0], torch.Tensor) and out_args[0].shape == (2, 3)
    assert out_args[0].dtype == torch.float32
    assert isinstance(out_args[1], np.ndarray) and out_args[1].dtype == np.int32
    assert out_args[2] == 5 and out_args[3] == 7.5 and out_args[4] == [1, 2]


def test_encode_call_rejects_opaque_leaves():
    """JAX :289; a ledger's recorded opaque argument (a cache view)
    materializes as a stand-in the engine's replayer fills."""
    with pytest.raises(aot.UnportableError, match="opaque"):
        aot.encode_call((object(),), {})
    node = aot.encode_call(None, None, {"args": [{"t": "opaque", "type": "KVCache"}],
                                         "kwargs": {}})
    (stand_in,), _ = aot.materialize_call(node)
    assert isinstance(stand_in, aot.Opaque) and stand_in.type_name == "KVCache"


def test_manifest_save_load_roundtrip(tmp_path):
    """JAX :294."""
    m = aot.ProgramManifest({"p": [{"signature": "s", "call": None, "portable": False,
                                    "note": ""}]}, {"format": 1})
    path = m.save(str(tmp_path))
    assert path.endswith(aot.MANIFEST_NAME)
    m2 = aot.ProgramManifest.load(str(tmp_path))
    assert m2.names() == ["p"] and m2.entries("p")[0]["signature"] == "s"
    with pytest.raises(ValueError):
        aot.ProgramManifest.from_json({"meta": {}})


def test_prewarm_host_read_budget(pair):
    """``test_host_sync.py:382``: after a prewarm from a donor's manifest a
    fresh request costs its first token's read at admission and one read a
    chunk, as on an engine never prewarmed, with no new compile; the stream
    equals the donor's."""
    _, _, tm = pair
    prompt = np.arange(1, 7, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.0)
    donor = _fresh(tm, kv_page_size=None)
    dreq = donor.submit(prompt, gcfg, seed=7)
    donor.run()
    engine = _fresh(tm, kv_page_size=None)
    rep = engine.prewarm(manifest=donor.manifest())
    assert rep["replayed"] and not rep["skipped"], rep
    before, reads = _compiles(engine), engine.host_reads
    req = engine.submit(prompt, gcfg, seed=7)
    assert engine.host_reads == reads  # a submit reads nothing
    engine.step()
    assert engine.host_reads == reads + 2  # the first token and one chunk
    engine.step()
    assert engine.host_reads == reads + 3  # a steady chunk: one
    engine.run()
    assert req.state is RequestState.DONE and req.tokens == dreq.tokens
    assert _compiles(engine) == before
    with pytest.raises(ValueError, match="idle"):
        engine.submit(prompt, gcfg)
        engine.step()
        engine.prewarm(manifest=donor.manifest())


def test_cache_dir_bundle_and_skew(pair, tmp_path):
    """``save_aot`` writes the manifest (and the process's kernel libraries:
    none on the CPU); ``prewarm(cache_dir=)`` replays it; a manifest whose
    kernel library was built from other sources raises ``SkewError``."""
    _, _, tm = pair
    donor = _fresh(tm)
    _drive(donor)
    out = donor.save_aot(str(tmp_path))
    assert out["kernels"] == [] and out["manifest"].endswith(aot.MANIFEST_NAME)
    fresh = _fresh(tm)
    rep = fresh.prewarm(cache_dir=str(tmp_path))
    assert rep["replayed"] and rep["kernels_cached"] == [] and rep["deserialized"] == []
    skewed = aot.ProgramManifest.load(str(tmp_path))
    skewed.meta["kernels"] = {"flash_decode": "libflash_decode-000000000000.so"}
    assert _build.lib_name("flash_decode") != "libflash_decode-000000000000.so"
    with pytest.raises(aot.SkewError, match="other sources"):
        _fresh(tm).prewarm(manifest=skewed)
    current = aot.ProgramManifest.load(str(tmp_path))
    current.meta["kernels"] = {"flash_decode": _build.lib_name("flash_decode")}
    assert _fresh(tm).prewarm(manifest=current)["replayed"]


def test_prewarm_failed_skipped_and_fatal_replays(pair, monkeypatch):
    """A program of another engine (a draft prefill on an engine without a
    draft) and a replay that raises a ``ValueError`` are ``failed``; the
    prefix programs, which run on a stored entry, are ``skipped``; a CUDA
    error, an out-of-memory error and a kernel error raise out of the
    prewarm instead of being reported."""
    _, _, tm = pair
    donor = _fresh(tm)
    _drive(donor, n_req=1)
    base = donor.manifest()
    entry = base.entries("first_token")[0]
    manifest = aot.ProgramManifest(dict(base.programs, **{
        "draft_prefill[8]": [dict(entry)], "prefix_extract": [dict(entry)]}), base.meta)
    engine = _fresh(tm)
    rep = engine.prewarm(manifest=manifest)
    assert set(rep["failed"]) == {"draft_prefill[8]"}, rep["failed"]
    assert set(rep["skipped"]) == {"prefix_extract"} and "stored prefix" in rep["skipped"][
        "prefix_extract"]
    assert "first_token" in rep["replayed"]

    def raising(exc):
        def fn(*args, **kwargs):
            raise exc

        return fn

    engine = _fresh(tm)
    monkeypatch.setattr(engine._first_token, "_inner", raising(ValueError("bad shape")))
    rep = engine.prewarm(manifest=base)
    assert rep["failed"] == {"first_token": "ValueError: bad shape"}
    for exc in (torch.AcceleratorError("CUDA error: an illegal memory access"),
                torch.cuda.OutOfMemoryError("CUDA out of memory"),
                _build.KernelError("flash_decode: CUDA error 700 at launch")):
        engine = _fresh(tm)
        monkeypatch.setattr(engine._first_token, "_inner", raising(exc))
        with pytest.raises(type(exc)):
            engine.prewarm(manifest=base)
