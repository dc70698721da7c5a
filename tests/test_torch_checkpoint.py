"""The port's checkpoints (``trainer/checkpoint.py``) against the JAX
package's (``tests/trainer/test_checkpoint.py`` :29, :61-:137 and
``test_checkpoint_objectstore.py`` over ``file://``), and the port's own
cases: an async save followed by in-place updates loads the saved bits, a
load checks everything before it writes, payloads load with
``weights_only``.

The same item trees and operations go through both packages; the tags on
disk, ``newest``, the resolved tag and the user content must be equal, the
tensors bit for bit (JAX's resharded load, :40, is multi-GPU work)."""

import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.trainer import checkpoint as jck
from neuronx_distributed_tpu_torch.trainer import checkpoint as tck
from neuronx_distributed_tpu_torch.trainer.checkpoint import (
    DONE_MARKER,
    FsspecCheckpointStorage,
    _with_retries,
    create_checkpoint_storage,
    finalize_checkpoints,
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)
W = np.arange(64.0, dtype=np.float32).reshape(8, 8)


class _Arbitrary:
    """An object ``weights_only`` loading must refuse."""


def _ttree():
    return {"w": torch.from_numpy(W.copy()), "b": torch.ones(3)}


def _jtree():
    return {"w": jnp.asarray(W), "b": jnp.ones((3,), jnp.float32)}


def _tags(d):
    return sorted(t for t in os.listdir(d) if os.path.isdir(os.path.join(d, t)))


def _both(tmp_path, ops):
    """Run ``ops(module, dir, tree_fn)`` on both packages; return their
    results and directories."""
    out = {}
    for side, mod, tree in (("jax", jck, _jtree), ("port", tck, _ttree)):
        d = str(tmp_path / side)
        os.makedirs(d, exist_ok=True)
        out[side] = (ops(mod, d, tree), d)
    return out


def test_save_load_roundtrip(tmp_path):
    """test_checkpoint.py:29."""
    def ops(m, d, tree):
        m.save_checkpoint(d, "step_10", items={"model": tree()}, user_content={"step": 10})
        items, user, tag = m.load_checkpoint(d)
        return tag, user, np.asarray(items["model"]["w"]), np.asarray(items["model"]["b"])

    out = _both(tmp_path, ops)
    (jt, ju, jw, jb), _ = out["jax"]
    (tt, tu, tw, tb), d = out["port"]
    assert (tt, tu) == (jt, ju) == ("step_10", {"step": 10})
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tb, jb)
    assert os.path.exists(os.path.join(d, "step_10", "integrity.json"))


def test_newest_and_retention(tmp_path):
    """test_checkpoint.py:61."""
    def ops(m, d, tree):
        for step in (1, 2, 3):
            m.save_checkpoint(d, f"step_{step}", items={"model": tree()}, num_kept_ckpts=2)
        return m.latest_checkpoint_tag(d), _tags(d)

    out = _both(tmp_path, ops)
    assert out["port"][0] == out["jax"][0] == ("step_3", ["step_2", "step_3"])


def test_corrupted_tag_cleanup(tmp_path):
    """test_checkpoint.py:71: a tag without a marker is never newest and the
    next retention pass removes it."""
    def ops(m, d, tree):
        m.save_checkpoint(d, "step_1", items={"model": tree()})
        os.makedirs(os.path.join(d, "step_2"))
        first = m.latest_checkpoint_tag(d)
        m.save_checkpoint(d, "step_3", items={"model": tree()}, num_kept_ckpts=5)
        return first, m.latest_checkpoint_tag(d), _tags(d)

    out = _both(tmp_path, ops)
    assert out["port"][0] == out["jax"][0] == ("step_1", "step_3", ["step_1", "step_3"])


def test_newest_pointer_fallback_cleans_corrupt_tag(tmp_path):
    """test_checkpoint.py:85: a ``newest`` pointing at a tag that lost its
    marker falls back, removes the tag and repoints ``newest``."""
    def ops(m, d, tree):
        m.save_checkpoint(d, "step_2", items={"model": tree()}, user_content={"step": 2})
        m.save_checkpoint(d, "step_4", items={"model": tree()}, user_content={"step": 4})
        os.remove(os.path.join(d, "step_4", DONE_MARKER))
        latest = m.latest_checkpoint_tag(d)
        newest = open(os.path.join(d, "newest")).read().strip()
        items, user, tag = m.load_checkpoint(d)
        return latest, newest, _tags(d), tag, user, np.asarray(items["model"]["w"])

    out = _both(tmp_path, ops)
    j, t = out["jax"][0], out["port"][0]
    assert t[:5] == j[:5] == ("step_2", "step_2", ["step_2"], "step_2", {"step": 2})
    np.testing.assert_array_equal(t[5], W)


def test_async_save(tmp_path):
    """test_checkpoint.py:106."""
    def ops(m, d, tree):
        m.save_checkpoint(d, "step_7", items={"model": tree()}, async_save=True)
        m.finalize_checkpoints()
        items, _, _ = m.load_checkpoint(d)
        return os.path.exists(os.path.join(d, "step_7", DONE_MARKER)), np.asarray(items["model"]["w"])

    out = _both(tmp_path, ops)
    assert out["port"][0][0] and out["jax"][0][0]
    np.testing.assert_array_equal(out["port"][0][1], W)


def test_async_retention_exact(tmp_path):
    """test_checkpoint.py:116: async saves keep exactly num_kept."""
    def ops(m, d, tree):
        for step in (1, 2, 3):
            m.save_checkpoint(d, f"step_{step}", items={"model": tree()}, num_kept_ckpts=2,
                              async_save=True)
        m.finalize_checkpoints()
        return _tags(d), m.latest_checkpoint_tag(d)

    out = _both(tmp_path, ops)
    assert out["port"][0] == out["jax"][0] == (["step_2", "step_3"], "step_3")


def test_load_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))


def test_model_only_load_skips_optimizer(tmp_path):
    """test_checkpoint.py:137."""
    d = str(tmp_path)
    t = _ttree()
    save_checkpoint(d, "s1", items={"model": t, "optimizer": {"mu": t["w"] * 0}})
    items, _, _ = load_checkpoint(d, items_target={"model": None})
    assert set(items) == {"model"}


# --- the port's own -------------------------------------------------------------------


@pytest.mark.parametrize("async_save", [True, False])
def test_save_then_in_place_updates_loads_the_saved_bits(tmp_path, async_save):
    """The state the train step updates in place: a save taken now, then
    more in-place writes before its commit lands, loads the saved bits (the
    host copy is taken before save_checkpoint returns)."""
    d = str(tmp_path)
    live = {"w": torch.randn(256, 64), "count": torch.tensor(3, dtype=torch.int32),
            "mu": [torch.randn(64), torch.randn(7, 5)]}
    want = {"w": live["w"].clone(), "count": live["count"].clone(),
            "mu": [t.clone() for t in live["mu"]]}
    save_checkpoint(d, "step_3", items={"optimizer": live}, async_save=async_save)
    for _ in range(5):
        live["w"].add_(1.0)
        live["count"].add_(1)
        for t in live["mu"]:
            t.mul_(-2.0)
    finalize_checkpoints()
    items, _, _ = load_checkpoint(d, tag="step_3")
    got = items["optimizer"]
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["count"], want["count"])
    assert all(torch.equal(a, b) for a, b in zip(got["mu"], want["mu"]))


def test_trainer_async_save_then_more_steps_loads_that_step(tmp_path):
    """The same through the loop: an async save at step 2 followed by two
    more in-place steps loads step 2's parameters bit for bit."""
    from neuronx_distributed_tpu_torch.models import llama as tllama
    from neuronx_distributed_tpu_torch.trainer import loop as tloop
    from neuronx_distributed_tpu_torch.trainer.data import SyntheticTokens

    snaps = {}

    class Snap(tloop.Callback):
        def on_step_end(self, trainer, metrics):
            snaps[trainer.step] = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    model = tllama.LlamaForCausalLM(tllama.tiny_llama(num_layers=2, max_seq_len=32),
                                    device="cpu", trainable=True)
    d = str(tmp_path)
    tr = tloop.Trainer(model=model, callbacks=[
        Snap(), tloop.CheckpointCallback(d, every=2, async_save=True, save_on_end=False)])
    tr.fit(SyntheticTokens(256, 8, 16, seed=3), 0, max_steps=4)
    fresh = tllama.LlamaForCausalLM(model.config, device="cpu", trainable=True)
    load_checkpoint(d, tag="step_2", items_target={"model": fresh})
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, snaps[2][k]), k
    assert not torch.equal(fresh.state_dict()["lm_head.weight"], snaps[4]["lm_head.weight"])


def test_in_place_load_checks_everything_before_writing(tmp_path):
    """A target whose keys, shapes or dtypes differ is refused before any
    tensor is written; a matching one is filled at its own addresses."""
    d = str(tmp_path)
    save_checkpoint(d, "t", items={"model": {"a": torch.ones(4), "b": torch.full((2, 3), 7.0)}})
    target = {"a": torch.zeros(4), "b": torch.zeros(3, 2)}
    with pytest.raises(ValueError, match="'b'"):
        load_checkpoint(d, items_target={"model": target})
    assert torch.equal(target["a"], torch.zeros(4))  # nothing written
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(d, items_target={"model": {"a": torch.zeros(4)}})
    target = {"a": torch.zeros(4), "b": torch.zeros(2, 3)}
    ptrs = [t.data_ptr() for t in target.values()]
    items, _, _ = load_checkpoint(d, items_target={"model": target})
    assert items["model"] is target and [t.data_ptr() for t in target.values()] == ptrs
    assert torch.equal(target["b"], torch.full((2, 3), 7.0))


def test_payloads_load_weights_only(tmp_path):
    """Nothing but tensors and containers is unpickled: a shard holding an
    arbitrary object is refused."""
    d = str(tmp_path)
    save_checkpoint(d, "t", items={"model": {"a": torch.ones(2)}})
    shard = os.path.join(d, "t", "state", "model", "shard_00000.pt")
    torch.save({"a": torch.ones(2), "x": _Arbitrary()}, shard)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(d, tag="t", verify_integrity=False)


def test_shards_split_large_items(tmp_path, monkeypatch):
    """Items are written as shards of at most SHARD_BYTES (a larger tensor
    alone), and load back whole."""
    monkeypatch.setattr(tck, "SHARD_BYTES", 100)
    d = str(tmp_path)
    tree = {f"t{i}": torch.full((10,), float(i)) for i in range(5)}
    tree["big"] = torch.arange(50.0)
    save_checkpoint(d, "s", items={"model": tree})
    files = os.listdir(os.path.join(d, "s", "state", "model"))
    assert len(files) == 4  # 40+40 | 40+40 | 40 | 200
    items, _, _ = load_checkpoint(d)
    assert list(items["model"]) == list(tree)
    assert all(torch.equal(items["model"][k], v) for k, v in tree.items())


# --- object stores (file://) ----------------------------------------------------------


def test_uri_dispatch(tmp_path):
    assert isinstance(create_checkpoint_storage(f"file://{tmp_path}"), FsspecCheckpointStorage)
    assert isinstance(create_checkpoint_storage("gs://bucket/run"), FsspecCheckpointStorage)
    assert not isinstance(create_checkpoint_storage(str(tmp_path)), FsspecCheckpointStorage)


def test_uri_roundtrip_and_retention_equal_jax(tmp_path):
    """test_checkpoint_objectstore.py:46 and :56 over file://."""
    def ops(m, d, tree):
        url = f"file://{d}"
        m.save_checkpoint(url, "step_10", items={"model": tree()}, user_content={"step": 10})
        items, user, tag = m.load_checkpoint(url)
        for step in (1, 2, 3):
            m.save_checkpoint(url, f"step_{step}", items={"model": tree()}, num_kept_ckpts=2)
        tags = m.create_checkpoint_storage(url).list_checkpoint_tags()
        os.makedirs(os.path.join(d, "step_99"))
        open(os.path.join(d, "step_99", "junk"), "w").write("x")
        m.save_checkpoint(url, "step_4", items={"model": tree()}, num_kept_ckpts=2)
        return (tag, user, tags, m.create_checkpoint_storage(url).list_checkpoint_tags(),
                m.latest_checkpoint_tag(url)), np.asarray(items["model"]["w"])

    out = _both(tmp_path, ops)
    assert out["port"][0][0] == out["jax"][0][0]
    assert out["port"][0][0][2] == ["step_2", "step_3"] and out["port"][0][0][4] == "step_4"
    np.testing.assert_array_equal(out["port"][0][1], W)


def test_retry_decrementing_jitter(monkeypatch):
    """test_checkpoint_objectstore.py:80."""
    waits = []
    monkeypatch.setattr("time.sleep", lambda s: waits.append(s))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("503 slow down")
        return "ok"

    assert _with_retries(flaky, "flaky-op") == "ok"
    assert calls["n"] == 3 and len(waits) == 2 and waits[0] > 0 and waits[1] > 0

    def dead():
        raise OSError("gone")

    with pytest.raises(OSError, match="gone"):
        _with_retries(dead, "dead-op", max_attempts=3)


class _FlakyFS:
    """Every wrapped method raises a transient OSError on its first N calls."""

    _WRAPPED = ("exists", "open", "ls", "info", "rm_file")

    def __init__(self, real, fails_per_op: int = 1):
        self._real = real
        self._budget = {m: fails_per_op for m in self._WRAPPED}
        self.injected = 0

    def __getattr__(self, name):
        real_attr = getattr(self._real, name)
        if name not in self._WRAPPED:
            return real_attr

        def wrapper(*args, **kw):
            if self._budget[name] > 0:
                self._budget[name] -= 1
                self.injected += 1
                raise OSError(f"injected transient failure in {name}")
            return real_attr(*args, **kw)

        return wrapper


def test_full_checkpoint_flow_through_flaky_store(tmp_path, monkeypatch):
    """test_checkpoint_objectstore.py:133."""
    monkeypatch.setattr("time.sleep", lambda s: None)
    url = f"file://{tmp_path}"
    storage = create_checkpoint_storage(url)
    flaky = _FlakyFS(storage._fs, fails_per_op=2)
    storage._fs = flaky
    storage.save_text("step_5", "newest")
    assert storage.load_text("newest") == "step_5"
    assert storage.file_exists("newest")
    storage.remove_file("newest")
    assert flaky.injected >= 4
    save_checkpoint(url, "step_5", items={"model": _ttree()}, user_content={"s": 5})
    items, user, tag = load_checkpoint(url)
    assert tag == "step_5" and user == {"s": 5}
    np.testing.assert_array_equal(items["model"]["w"].numpy(), W)


def test_exhausted_retries_surface_the_error(tmp_path, monkeypatch):
    """test_checkpoint_objectstore.py:167."""
    monkeypatch.setattr("time.sleep", lambda s: None)
    storage = create_checkpoint_storage(f"file://{tmp_path}")
    calls = {"n": 0}

    def always_fails(*a, **kw):
        calls["n"] += 1
        raise OSError("persistent outage")

    monkeypatch.setattr(storage._fs, "exists", always_fails)
    with pytest.raises(OSError, match="persistent outage"):
        storage.file_exists("newest")
    assert calls["n"] == 5
    nf = {"n": 0}

    def not_found(*a, **kw):
        nf["n"] += 1
        raise FileNotFoundError("no such object")

    monkeypatch.setattr(storage._fs, "open", lambda *a, **kw: not_found())
    with pytest.raises(FileNotFoundError):
        storage.load_text("missing")
    assert nf["n"] == 1


def test_storage_metadata_ops_retry_through_fs_errors(tmp_path, monkeypatch):
    """test_checkpoint_objectstore.py:203."""
    storage = create_checkpoint_storage(f"file://{tmp_path}")
    monkeypatch.setattr("time.sleep", lambda s: None)
    real_exists = storage._fs.exists
    state = {"fails": 2}

    def flaky_exists(path):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise OSError("transient")
        return real_exists(path)

    monkeypatch.setattr(storage._fs, "exists", flaky_exists)
    storage.save_text("hello", "newest")
    assert storage.load_text("newest") == "hello"
    assert storage.file_exists("newest") and state["fails"] == 0


def test_uri_without_fsspec_names_the_package(tmp_path, monkeypatch):
    """fsspec is imported at the first IO: choosing the storage works
    without it, the first IO raises an ImportError naming it."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
    storage = create_checkpoint_storage(f"file://{tmp_path}")
    with pytest.raises(ImportError, match="fsspec"):
        storage.file_exists("newest")
