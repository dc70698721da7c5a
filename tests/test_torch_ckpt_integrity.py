"""Verified checkpoints (``integrity/checkpoint.py``) against the JAX
package's (``tests/integrity/test_checkpoint.py``): the manifest contract
on raw storage, every trainer save carrying a verifiable manifest, and the
rotten-shard fallback through the loop.

The manifests are CRC-32s of the same bytes on both sides, so on the same
files the port's digests equal JAX's exactly. Through the loop both sides
run the same schedule from one flax init on the same batches: counters,
flight events and tags exactly, the losses within 2e-6 relative, the port's
retrained stream bit for bit against its clean run."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.integrity import checkpoint as jic
from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.observability.flight_recorder import FlightRecorder as JFlight
from neuronx_distributed_tpu.trainer import OptimizerConfig as JOptimizerConfig
from neuronx_distributed_tpu.trainer import checkpoint as jck
from neuronx_distributed_tpu.trainer import data as jdata
from neuronx_distributed_tpu.trainer import faults as jfaults
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu_torch.integrity.checkpoint import (
    INTEGRITY_MANIFEST,
    compute_digests,
    verify_manifest,
    write_manifest,
)
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.observability.flight_recorder import FlightRecorder
from neuronx_distributed_tpu_torch.trainer import checkpoint as tck
from neuronx_distributed_tpu_torch.trainer import data as tdata
from neuronx_distributed_tpu_torch.trainer import faults as tfaults
from neuronx_distributed_tpu_torch.trainer import loop as tloop
from neuronx_distributed_tpu_torch.trainer import trainer as ttrainer
from neuronx_distributed_tpu_torch.trainer.checkpoint import DONE_MARKER, create_checkpoint_storage

pytestmark = pytest.mark.chaos
torch.set_num_threads(1)
BS, SEQ, STEPS = 8, 16, 6
LOSS_RTOL = 2e-6
_PARAMS = {}


@pytest.fixture(autouse=True)
def _flax_init(monkeypatch):
    def init(model, seed=0):
        if seed not in _PARAMS:
            m = jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=2, max_seq_len=32),
                                        attention_impl="xla")
            p = nn.unbox(m.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
            _PARAMS[seed] = jax.tree_util.tree_map(np.asarray, {"params": p["params"]})
        model.load_state_dict(flax_to_torch(_PARAMS[seed], model.config))
        return model

    monkeypatch.setattr(ttrainer, "init_params", init)


# --- the manifest contract on raw storage ------------------------------------------------


def _fake_tag(root, tag="step_2"):
    storage = create_checkpoint_storage(str(root))
    storage.save_bytes(b"\x00" * 257, os.path.join(tag, "state", "a.npy"))
    storage.save_bytes(b"payload-bytes" * 9, os.path.join(tag, "state", "b.npy"))
    storage.save_text('{"step": 2}', os.path.join(tag, "meta.json"))
    return storage, tag


def test_manifest_round_trip_equals_jax(tmp_path):
    """integrity/test_checkpoint.py:82: the manifest digests every file but
    itself; the port's digests equal JAX's on the same bytes."""
    storage, tag = _fake_tag(tmp_path)
    write_manifest(storage, tag)
    ok, detail = verify_manifest(storage, tag)
    assert ok and detail == "verified 3 files"
    manifest = json.loads(storage.load_text(os.path.join(tag, INTEGRITY_MANIFEST)))
    assert set(manifest["files"]) == {os.path.join("state", "a.npy"),
                                      os.path.join("state", "b.npy"), "meta.json"}
    assert manifest["files"] == compute_digests(storage, tag)
    jstorage = jck.create_checkpoint_storage(str(tmp_path))
    assert jic.compute_digests(jstorage, tag) == manifest["files"]
    assert jic.verify_manifest(jstorage, tag) == (ok, detail)


@pytest.mark.parametrize("damage", ["none", "flip", "missing", "unreadable"])
def test_manifest_verdicts_equal_jax(tmp_path, damage):
    """integrity/test_checkpoint.py:99-:130: legacy without a manifest, a
    flipped byte, a missing file, an unreadable manifest: the same verdict
    and detail as JAX's."""
    storage, tag = _fake_tag(tmp_path)
    if damage != "none":
        write_manifest(storage, tag)
    if damage == "flip":
        victim = os.path.join(tag, "state", "b.npy")
        raw = bytearray(storage.load_bytes(victim))
        raw[len(raw) // 2] ^= 0x01
        storage.save_bytes(bytes(raw), victim)
    elif damage == "missing":
        storage.remove_file(os.path.join(tag, "state", "a.npy"))
    elif damage == "unreadable":
        storage.save_text("{not json", os.path.join(tag, INTEGRITY_MANIFEST))
    got = verify_manifest(storage, tag)
    want = jic.verify_manifest(jck.create_checkpoint_storage(str(tmp_path)), tag)
    assert got == want
    expect = {"none": "legacy", "flip": "digest mismatch", "missing": "missing file",
              "unreadable": "unreadable manifest"}[damage]
    assert got[0] == (damage == "none") and expect in got[1]


def test_flip_byte_in_place(tmp_path):
    storage, tag = _fake_tag(tmp_path)
    path = os.path.join(tag, "state", "b.npy")
    before = storage.load_bytes(path)
    storage.flip_byte(path, 5)
    after = storage.load_bytes(path)
    assert len(after) == len(before) and after[5] == before[5] ^ 1 and after[6:] == before[6:]
    assert storage.file_size(path) == len(before)


# --- through the loop -----------------------------------------------------------------------


def _run(side, root, max_steps, inj=None, async_save=False, resume=False, flight=None, key=0):
    mod = {"jax": (jloop, jfaults, jdata), "port": (tloop, tfaults, tdata)}[side]
    losses = []

    class Rec(mod[0].Callback):
        def on_step_end(self, trainer, metrics):
            losses.append(float(metrics["loss"]))

    cbs = [Rec()]
    if not resume:
        cbs.append(mod[0].CheckpointCallback(root, every=2, async_save=async_save,
                                             save_on_end=False))
    kw = dict(optimizer_config=JOptimizerConfig(zero1=False)) if side == "jax" else {}
    model = (jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=2, max_seq_len=32),
                                     attention_impl="xla") if side == "jax" else
             tllama.LlamaForCausalLM(tllama.tiny_llama(num_layers=2, max_seq_len=32),
                                     device="cpu", trainable=True))
    injector = inj(mod[1]) if inj is not None else None
    tr = mod[0].Trainer(model=model, callbacks=cbs, fault_injector=injector,
                        flight_recorder=flight, **kw)
    tr.fit(mod[2].SyntheticTokens(256, BS, SEQ, seed=3),
           jax.random.PRNGKey(key) if side == "jax" else key, max_steps=max_steps,
           resume_from=root if resume else None)
    return tr, injector, losses


@pytest.mark.parametrize("async_save", [False, True])
def test_trainer_saves_write_verifiable_manifests(tmp_path, async_save):
    """integrity/test_checkpoint.py:140."""
    root = str(tmp_path)
    _run("port", root, 4, async_save=async_save)
    storage = create_checkpoint_storage(root)
    for tag in ("step_2", "step_4"):
        assert storage.file_exists(os.path.join(tag, DONE_MARKER))
        ok, detail = verify_manifest(storage, tag)
        assert ok and detail.startswith("verified ")
        files = json.loads(storage.load_text(os.path.join(tag, INTEGRITY_MANIFEST)))["files"]
        assert "user_content.json" in files
        assert any(f.startswith(os.path.join("state", "optimizer")) for f in files)


def test_rotten_shard_falls_back_and_retrains_bit_identical(tmp_path):
    """integrity/test_checkpoint.py:162: a byte of step_4's committed
    payload rots; the resume refuses step_4 (counted, a flight event, its
    marker stripped), falls back to step_2 and retrains to the clean
    stream. The counters, events and tags equal JAX's."""
    out = {}
    for side, flight_cls in (("jax", JFlight), ("port", FlightRecorder)):
        root = str(tmp_path / side)
        clean = _run(side, str(tmp_path / f"{side}_clean"), STEPS)[2]
        tr, inj, first = _run(side, root, 4,
                              inj=lambda F: F.FaultInjector().flip_bits("checkpoint_shard", at=1))
        storage = (jck if side == "jax" else tck).create_checkpoint_storage(root)
        verify = jic.verify_manifest if side == "jax" else verify_manifest
        rotten = (storage.file_exists(os.path.join("step_4", DONE_MARKER)),
                  verify(storage, "step_4")[0])
        fl = flight_cls(subsystem="trainer")
        tr2, _, losses = _run(side, root, STEPS, resume=True, flight=fl, key=5)
        events = [e["tag"] for e in fl.events() if e["kind"] == "checkpoint_integrity_failure"]
        out[side] = dict(flips=inj.counters["bit_flips"], rotten=rotten,
                         failures=tr2.checkpoint_integrity_failures, steps_run=tr2.steps_run,
                         events=events,
                         marker=os.path.exists(os.path.join(root, "step_4", DONE_MARKER)),
                         tags=sorted(os.listdir(root)), losses=losses, clean=clean)
    p, j = out["port"], out["jax"]
    for k in ("flips", "rotten", "failures", "steps_run", "events", "marker", "tags"):
        assert p[k] == j[k], k
    assert p["flips"] == 1 and p["rotten"] == (True, False) and p["failures"] == 1
    assert p["steps_run"] == 4 and p["events"] == ["step_4"] and not p["marker"]
    assert p["losses"] == p["clean"][2:]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=LOSS_RTOL, atol=0)


def test_rotten_shard_fires_under_async_save(tmp_path):
    """integrity/test_checkpoint.py:195: the async commit writes the manifest
    first, so the flip lands on committed, manifested bytes."""
    root = str(tmp_path)
    _, inj, _ = _run("port", root, 4, async_save=True,
                     inj=lambda F: F.FaultInjector().flip_bits("checkpoint_shard", at=1))
    assert inj.counters["bit_flips"] == 1
    storage = create_checkpoint_storage(root)
    ok, detail = verify_manifest(storage, "step_4")
    assert not ok and "digest mismatch" in detail
    assert verify_manifest(storage, "step_2")[0]
