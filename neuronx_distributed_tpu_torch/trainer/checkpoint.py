"""Checkpoint save and load with the tag / done / newest / retention
protocol (counterpart of ``neuronx_distributed_tpu/trainer/checkpoint.py``:
``DONE_MARKER``/``NEWEST_FILE``/``META_FILE``, the storages,
``_with_retries``, ``create_checkpoint_storage``, ``CheckpointIOState``,
``finalize_checkpoints``, ``_commit``, the tag order and retention,
``save_checkpoint``, ``latest_checkpoint_tag`` and ``load_checkpoint``).

The control protocol is JAX's, file for file: a tag directory holds the
payload, then ``user_content.json``, then the integrity manifest
(``integrity/checkpoint.py``), then the ``done`` marker; ``newest`` points
at the last committed tag; retention keeps the newest ``num_kept_ckpts``
completed tags and removes tags without a marker (a save killed midway)
unless their save is still in flight; a ``newest`` pointer at a tag that
lost its marker falls back to the newest completed tag.

The payload format is PyTorch's own where JAX writes orbax: each item (e.g.
``{"model": state_dict, "optimizer": opt_state}``) is flattened to
``path -> tensor`` (dict keys and ``[i]`` list indices joined by ``/``) and
written by ``torch.save`` as shards of at most :data:`SHARD_BYTES` under
``<tag>/state/<item>/shard_<k>.pt``, in parallel threads. Each shard's
CRC-32 is taken from the bytes as they are written (the manifest's digest
of that file, so a save reads nothing back). A load reads them with
``torch.load(weights_only=True)``, so nothing but tensors and containers
is unpickled.

**Async saves against in-place updates.** JAX arrays are immutable, so
orbax writes them in the background. The port's train step updates the
parameters, the AdamW moments, the count and the guard IN PLACE, so a
background writer reading the live tensors would tear. An async save
therefore copies every tensor to the host before :func:`save_checkpoint`
returns (pinned buffers on the card, one synchronize), and only the file
writes, the manifest and the commit run on the worker thread. One host copy
is in flight at a time: a save first waits for the previous async commit,
so host memory stays at one state's bytes and the pinned buffers are the
caching host allocator's, reused from the previous save.

**Loading in place.** With an ``items_target`` (a module or a tree of
tensors), every key, shape and dtype is checked before the first tensor is
written, then each is ``copy_``-ed into the target: the addresses stay, so
a fingerprint table built over them (TF) stays valid.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import io
import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.utils.fingerprint import bytes_fingerprint
from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy, with_retries

logger = logging.getLogger(__name__)

DONE_MARKER = "done"
NEWEST_FILE = "newest"
META_FILE = "user_content.json"
_ITEMS_DIRNAME = "state"
SHARD_BYTES = 1 << 30  # a shard file holds at most this many payload bytes (or one tensor)
READ_CHUNK = 64 << 20  # the digests stream files in chunks of this size
IO_THREADS = 8


# --- storages -------------------------------------------------------------------


class _DigestingWriter:
    """A write-through file wrapper keeping the CRC-32 of every byte that
    passed (``torch.save`` writes a zip stream front to back)."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, data) -> int:
        self.crc = bytes_fingerprint(data, self.crc)
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()


class BaseCheckpointStorage:
    """Where a checkpoint directory lives (JAX ``BaseCheckpointStorage``):
    the control files (markers, ``newest``, user content), byte access for
    the integrity manifests, and the tensor payload files."""

    def __init__(self, dirname: str):
        self._dirname = dirname

    @property
    def dirname(self) -> str:
        return self._dirname

    def file_exists(self, filename: str) -> bool:
        raise NotImplementedError

    def file_mtime(self, filename: str) -> float:
        raise NotImplementedError

    def remove_file(self, filename: str) -> None:
        raise NotImplementedError

    def save_text(self, text: str, filename: str) -> None:
        raise NotImplementedError

    def load_text(self, filename: str) -> str:
        raise NotImplementedError

    def list_files(self, prefix: str) -> List[str]:
        """Relative paths (to ``prefix``) of every FILE under it,
        recursive, sorted: the digest surface of a tag."""
        raise NotImplementedError

    def save_bytes(self, data: bytes, filename: str) -> None:
        raise NotImplementedError

    def load_bytes(self, filename: str) -> bytes:
        raise NotImplementedError

    def iter_bytes(self, filename: str, chunk: int = READ_CHUNK) -> Iterator[bytes]:
        """The file's bytes in chunks (bounded memory for the digests); a
        chunk may be a view that the next one overwrites."""
        yield self.load_bytes(filename)

    def file_size(self, filename: str) -> int:
        return len(self.load_bytes(filename))

    def flip_byte(self, filename: str, offset: int, mask: int = 0x01) -> None:
        """``byte[offset] ^= mask`` of a stored file (the shard-rot chaos)."""
        raw = bytearray(self.load_bytes(filename))
        raw[offset] ^= mask
        self.save_bytes(bytes(raw), filename)

    def list_checkpoint_tags(self) -> List[str]:
        raise NotImplementedError

    def remove_checkpoint(self, tag: str) -> None:
        raise NotImplementedError

    def prepare_tag(self, tag: str) -> None:
        """Make the tag writable and clear a stale payload."""
        raise NotImplementedError

    def list_items(self, tag: str) -> List[str]:
        """Names of the saved items under ``tag`` (model, optimizer, ...)."""
        raise NotImplementedError

    def write_payload(self, filename: str, obj) -> int:
        """``torch.save`` of ``obj`` (CPU tensors in containers); returns the
        CRC-32 of the bytes written."""
        raise NotImplementedError

    def read_payload(self, filename: str):
        """``torch.load(weights_only=True)`` of a payload file, on the CPU."""
        raise NotImplementedError


class FilesystemCheckpointStorage(BaseCheckpointStorage):
    """A local or network directory (JAX ``FilesystemCheckpointStorage``)."""

    def _full(self, filename: str) -> str:
        return os.path.join(self._dirname, filename)

    def file_exists(self, filename: str) -> bool:
        return os.path.exists(self._full(filename))

    def file_mtime(self, filename: str) -> float:
        return os.path.getmtime(self._full(filename))

    def remove_file(self, filename: str) -> None:
        path = self._full(filename)
        if os.path.exists(path):
            os.remove(path)

    def _atomic_write(self, filename: str, mode: str, write):
        path = self._full(filename)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, mode) as f:
            out = write(f)
        os.replace(tmp, path)
        return out

    def save_text(self, text: str, filename: str) -> None:
        self._atomic_write(filename, "w", lambda f: f.write(text))

    def load_text(self, filename: str) -> str:
        with open(self._full(filename)) as f:
            return f.read()

    def list_files(self, prefix: str) -> List[str]:
        root = self._full(prefix)
        if not os.path.isdir(root):
            return []
        out = []
        for dirpath, _, names in os.walk(root):
            out += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
        return sorted(out)

    def save_bytes(self, data: bytes, filename: str) -> None:
        self._atomic_write(filename, "wb", lambda f: f.write(data))

    def load_bytes(self, filename: str) -> bytes:
        with open(self._full(filename), "rb") as f:
            return f.read()

    def iter_bytes(self, filename: str, chunk: int = READ_CHUNK) -> Iterator[memoryview]:
        # one buffer reused: each block is valid until the next is read
        buf = memoryview(bytearray(chunk))
        with open(self._full(filename), "rb", buffering=0) as f:
            while True:
                n = f.readinto(buf)
                if not n:
                    return
                yield buf[:n]

    def file_size(self, filename: str) -> int:
        return os.path.getsize(self._full(filename))

    def flip_byte(self, filename: str, offset: int, mask: int = 0x01) -> None:
        with open(self._full(filename), "r+b") as f:
            f.seek(offset)
            b = f.read(1)[0]
            f.seek(offset)
            f.write(bytes([b ^ mask]))

    def list_checkpoint_tags(self) -> List[str]:
        if not os.path.isdir(self._dirname):
            return []
        return sorted(d for d in os.listdir(self._dirname)
                      if os.path.isdir(os.path.join(self._dirname, d)))

    def remove_checkpoint(self, tag: str) -> None:
        shutil.rmtree(self._full(tag), ignore_errors=True)

    def prepare_tag(self, tag: str) -> None:
        os.makedirs(self._full(tag), exist_ok=True)
        items = self._full(os.path.join(tag, _ITEMS_DIRNAME))
        if os.path.exists(items):
            shutil.rmtree(items)

    def list_items(self, tag: str) -> List[str]:
        root = self._full(os.path.join(tag, _ITEMS_DIRNAME))
        return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))

    def write_payload(self, filename: str, obj) -> int:
        def write(f):
            w = _DigestingWriter(f)
            torch.save(obj, w)
            return w.crc

        return self._atomic_write(filename, "wb", write)

    def read_payload(self, filename: str):
        # mmap: the tensors stay in the page cache until they are copied
        return torch.load(self._full(filename), map_location="cpu", weights_only=True, mmap=True)


# Transient errors worth retrying on object stores (JAX _TRANSIENT_ERRORS).
_TRANSIENT_ERRORS: Tuple[type, ...] = (OSError, IOError, TimeoutError)


def _with_retries(fn, what: str, max_attempts: int = 5, first_wait: float = 4.0,
                  min_wait: float = 0.5, sleep=None, rng=None):
    """Retry ``fn`` on transient object-store errors with a DEcreasing
    jittered wait (JAX ``_with_retries``, over the port's
    ``utils/retry.with_retries``)."""
    return with_retries(fn, what,
                        policy=RetryPolicy(max_attempts=max_attempts, first_wait=first_wait,
                                           min_wait=min_wait),
                        transient=_TRANSIENT_ERRORS, sleep=sleep, rng=rng)


class FsspecCheckpointStorage(BaseCheckpointStorage):
    """Any ``scheme://`` URI over fsspec (JAX ``FsspecCheckpointStorage``):
    ``file://``, ``memory://``, and the object stores fsspec implements,
    with the same protocol and decrementing-jitter retries on every
    operation. fsspec is imported at the first real IO, never when a module
    is imported or a storage is chosen; without it that IO raises an
    ``ImportError`` that names the package."""

    def __init__(self, url: str):
        super().__init__(url.rstrip("/"))
        self._lazy_fs = None
        self._protocol = self._dirname.split("://", 1)[0]

    @property
    def _fs(self):
        if self._lazy_fs is None:
            try:
                import fsspec
            except ImportError as e:
                raise ImportError(f"checkpoint URI {self._dirname!r} needs the 'fsspec' package, "
                                  "which is not installed; use a local directory path") from e
            self._lazy_fs, self._lazy_root = fsspec.core.url_to_fs(self._dirname)
        return self._lazy_fs

    @_fs.setter
    def _fs(self, fs):
        # fault-injection harnesses wrap the live filesystem in place
        self._fs  # noqa: B018 (materialize so _lazy_root is set)
        self._lazy_fs = fs

    @property
    def _root(self):
        self._fs  # noqa: B018
        return self._lazy_root

    def _path(self, filename: str) -> str:
        return f"{self._root}/{filename}"

    def file_exists(self, filename: str) -> bool:
        return _with_retries(lambda: self._fs.exists(self._path(filename)),
                             f"exists({filename})")

    def file_mtime(self, filename: str) -> float:
        def get():
            info = self._fs.info(self._path(filename))
            m = info.get("mtime") or info.get("LastModified") or 0.0
            return m.timestamp() if hasattr(m, "timestamp") else float(m)

        return _with_retries(get, f"mtime({filename})")

    def remove_file(self, filename: str) -> None:
        def rm():
            p = self._path(filename)
            if self._fs.exists(p):
                self._fs.rm_file(p)

        _with_retries(rm, f"remove({filename})")

    def _put(self, filename: str, mode: str, write, what: str) -> None:
        def put():
            path = self._path(filename)
            try:  # object stores have no real directories
                self._fs.makedirs(path.rsplit("/", 1)[0], exist_ok=True)
            except Exception:
                pass
            with self._fs.open(path, mode) as f:
                write(f)

        _with_retries(put, f"{what}({filename})")

    def save_text(self, text: str, filename: str) -> None:
        self._put(filename, "w", lambda f: f.write(text), "save_text")

    def load_text(self, filename: str) -> str:
        def get():
            with self._fs.open(self._path(filename), "r") as f:
                return f.read()

        return _with_retries(get, f"load_text({filename})")

    def list_files(self, prefix: str) -> List[str]:
        def ls():
            root = self._path(prefix)
            if not self._fs.exists(root):
                return []
            out = []
            for p in self._fs.find(root):
                rel = p[len(root):].lstrip("/")
                if rel:
                    out.append(rel)
            return sorted(out)

        return _with_retries(ls, f"list_files({prefix})")

    def save_bytes(self, data: bytes, filename: str) -> None:
        self._put(filename, "wb", lambda f: f.write(data), "save_bytes")

    def file_size(self, filename: str) -> int:
        return int(_with_retries(lambda: self._fs.size(self._path(filename)),
                                 f"size({filename})"))

    def load_bytes(self, filename: str) -> bytes:
        def get():
            with self._fs.open(self._path(filename), "rb") as f:
                return f.read()

        return _with_retries(get, f"load_bytes({filename})")

    def list_checkpoint_tags(self) -> List[str]:
        def ls():
            if not self._fs.exists(self._root):
                return []
            return sorted(info["name"].rstrip("/").rsplit("/", 1)[-1]
                          for info in self._fs.ls(self._root, detail=True)
                          if info.get("type") == "directory")

        return _with_retries(ls, "list_tags")

    def remove_checkpoint(self, tag: str) -> None:
        def rm():
            p = self._path(tag)
            if self._fs.exists(p):
                self._fs.rm(p, recursive=True)

        _with_retries(rm, f"remove_checkpoint({tag})")

    def prepare_tag(self, tag: str) -> None:
        def prep():
            items = self._path(f"{tag}/{_ITEMS_DIRNAME}")
            if self._fs.exists(items):
                self._fs.rm(items, recursive=True)
            try:  # object stores have no real directories
                self._fs.makedirs(self._path(tag), exist_ok=True)
            except Exception:
                pass

        _with_retries(prep, f"prepare_tag({tag})")

    def list_items(self, tag: str) -> List[str]:
        def ls():
            target = self._path(f"{tag}/{_ITEMS_DIRNAME}")
            return sorted(info["name"].rstrip("/").rsplit("/", 1)[-1]
                          for info in self._fs.ls(target, detail=True)
                          if info.get("type") == "directory")

        return _with_retries(ls, f"list_items({tag})")

    def write_payload(self, filename: str, obj) -> int:
        buf = io.BytesIO()
        torch.save(obj, buf)
        data = buf.getvalue()
        self.save_bytes(data, filename)
        return bytes_fingerprint(data)

    def read_payload(self, filename: str):
        return torch.load(io.BytesIO(self.load_bytes(filename)), map_location="cpu",
                          weights_only=True)


def create_checkpoint_storage(dirname: str) -> BaseCheckpointStorage:
    """A ``scheme://`` URI goes through fsspec, a path to the filesystem
    backend (JAX ``create_checkpoint_storage``)."""
    if "://" in dirname:
        return FsspecCheckpointStorage(dirname)
    return FilesystemCheckpointStorage(dirname)


# --- trees of tensors ----------------------------------------------------------------


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor of a tree of dicts, lists, tuples
    and modules (a module by its ``state_dict``), in order."""
    if isinstance(tree, torch.Tensor):
        return [("/".join(prefix), tree)]
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        children = []
        for k, v in tree.items():
            k = str(k)
            if "/" in k or k.startswith("["):
                raise ValueError(f"checkpoint tree key {k!r} may not hold '/' or start with '['")
            children.append((k, v))
    elif isinstance(tree, (list, tuple)):
        children = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        raise TypeError(f"checkpoint trees hold tensors, dicts, lists and modules, not "
                        f"{type(tree).__name__}")
    out = []
    for k, v in children:
        out += _flatten(v, prefix + (k,))
    return out


def _unflatten(flat: Mapping[str, torch.Tensor]):
    """The tree of :func:`_flatten`'s paths (lists where every key of a
    level is an index)."""
    if list(flat) == [""]:
        return flat[""]
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, t in flat.items():
        head, _, rest = path.partition("/")
        groups.setdefault(head, {})[rest] = t
    if groups and all(k.startswith("[") for k in groups):
        return [_unflatten(groups[k]) for k in sorted(groups, key=lambda k: int(k[1:-1]))]
    return {k: _unflatten(v) for k, v in groups.items()}


def _shards(flat: List[Tuple[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
    """Consecutive groups of at most :data:`SHARD_BYTES` (a larger tensor
    alone)."""
    out, cur, size = [], {}, 0
    for k, t in flat:
        n = t.numel() * t.element_size()
        if cur and size + n > SHARD_BYTES:
            out.append(cur)
            cur, size = {}, 0
        cur[k] = t
        size += n
    if cur or not out:
        out.append(cur)
    return out


def _to_host(items: Mapping[str, Any]) -> Dict[str, List[Tuple[str, torch.Tensor]]]:
    """A host copy of every tensor of ``items``, taken now: pinned buffers
    filled by ``non_blocking`` copies and one synchronize for CUDA tensors,
    clones for CPU tensors. Nothing the caller does afterwards reaches it."""
    out, sync = {}, False
    for name, tree in items.items():
        flat = []
        for k, t in _flatten(tree):
            t = t.detach()
            if t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                sync = True
            else:
                h = t.clone(memory_format=torch.contiguous_format)
            flat.append((k, h))
        out[name] = flat
    if sync:
        torch.cuda.synchronize()
    return out


def _item_dir(tag: str, name: str) -> str:
    return os.path.join(tag, _ITEMS_DIRNAME, name)


def _write_items(storage: BaseCheckpointStorage, tag: str,
                 host: Mapping[str, List[Tuple[str, torch.Tensor]]]) -> Dict[str, int]:
    """Every item's shards, written in parallel threads; returns each
    shard's CRC-32 by its path relative to the tag."""
    jobs = [(os.path.join(_ITEMS_DIRNAME, name, f"shard_{k:05d}.pt"), shard)
            for name, flat in host.items() for k, shard in enumerate(_shards(flat))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, min(IO_THREADS, len(jobs)))) as pool:
        futures = [(rel, pool.submit(storage.write_payload, os.path.join(tag, rel), shard))
                   for rel, shard in jobs]
        return {rel: f.result() for rel, f in futures}


# --- async IO state ---------------------------------------------------------------


class CheckpointIOState:
    """In-flight async saves (JAX ``CheckpointIOState``): commits run on a
    single worker thread, so markers, ``newest`` and retention change in
    submission order; in-flight tags are never classed as corrupted."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []
        self._in_flight: List[str] = []

    def in_flight_tags(self) -> List[str]:
        with self._lock:
            return list(self._in_flight)

    def register(self, tag: str) -> None:
        """Mark ``tag`` as being written BEFORE any byte lands."""
        with self._lock:
            if tag not in self._in_flight:
                self._in_flight.append(tag)

    def unregister(self, tag: str) -> None:
        with self._lock:
            if tag in self._in_flight:
                self._in_flight.remove(tag)

    def begin(self, storage: BaseCheckpointStorage, tag: str, host,
              num_kept_ckpts: Optional[int]) -> None:
        """Queue the write of ``host`` (:func:`_to_host`'s copy), the
        manifest and the commit of ``tag`` (already registered)."""

        def finish() -> None:
            from neuronx_distributed_tpu_torch.integrity.checkpoint import write_manifest

            try:
                write_manifest(storage, tag, known=_write_items(storage, tag, host))
                _commit(storage, tag, num_kept_ckpts, current_tag=tag)
                logger.info("async checkpoint '%s' committed", tag)
            finally:
                self.unregister(tag)

        with self._lock:
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-commit")
            still = []
            for f in self._pending:
                if f.done():
                    f.result()  # a failed earlier commit raises here
                else:
                    still.append(f)
            self._pending = still
            self._pending.append(self._executor.submit(finish))

    def wait_all(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()


_IO_STATE = CheckpointIOState()
atexit.register(_IO_STATE.wait_all)


def finalize_checkpoints() -> None:
    """Block until every async save has committed (a failed one raises)."""
    _IO_STATE.wait_all()


# --- the commit protocol --------------------------------------------------------------


def _commit(storage: BaseCheckpointStorage, tag: str, num_kept_ckpts: Optional[int],
            current_tag: Optional[str] = None) -> None:
    storage.save_text("", os.path.join(tag, DONE_MARKER))
    storage.save_text(tag, NEWEST_FILE)
    if num_kept_ckpts is not None and num_kept_ckpts > 0:
        for victim in _determine_remove_tags(storage, num_kept_ckpts, current_tag):
            logger.info("retention: removing checkpoint '%s'", victim)
            storage.remove_checkpoint(victim)


def _tag_step(tag: str) -> int:
    """The trailing integer of a tag (step_100 -> 100), else -1."""
    digits = ""
    for ch in reversed(tag):
        if not ch.isdigit():
            break
        digits = ch + digits
    return int(digits) if digits else -1


def _tag_order_key(storage: BaseCheckpointStorage, tag: str):
    """Retention and ``newest`` order: the done marker's mtime, the
    trailing step number breaking ties."""
    try:
        mtime = storage.file_mtime(os.path.join(tag, DONE_MARKER))
    except OSError:
        mtime = 0.0
    return (mtime, _tag_step(tag))


def _determine_remove_tags(storage: BaseCheckpointStorage, num_kept_ckpts: int,
                           current_tag: Optional[str] = None) -> List[str]:
    """Tags without a ``done`` marker (leftovers of a killed save, but not
    saves in flight) and completed tags beyond the newest
    ``num_kept_ckpts``, oldest first. ``current_tag``, whose commit runs
    this pass, counts as completed."""
    in_flight = set(_IO_STATE.in_flight_tags()) - {current_tag}
    tags = [t for t in storage.list_checkpoint_tags() if t not in in_flight]
    done = [t for t in tags if storage.file_exists(os.path.join(t, DONE_MARKER))]
    corrupted = [t for t in tags if t not in done]
    done.sort(key=lambda t: _tag_order_key(storage, t))
    return corrupted + done[: max(0, len(done) - num_kept_ckpts)]


def save_checkpoint(checkpoint_dir: str, tag: str, items: Mapping[str, Any],
                    user_content: Optional[Dict[str, Any]] = None,
                    num_kept_ckpts: Optional[int] = None, async_save: bool = False,
                    storage: Optional[BaseCheckpointStorage] = None) -> None:
    """Save ``items`` (named trees: ``{"model": module, "optimizer":
    opt_state}``) under ``checkpoint_dir/tag``, each item in its own
    directory so a model-only load never reads optimizer bytes. With
    ``async_save`` the host copy is taken before this returns and the rest
    runs on the commit worker (:func:`finalize_checkpoints` waits); a save
    first waits for an async commit still in flight."""
    storage = storage or create_checkpoint_storage(checkpoint_dir)
    _IO_STATE.wait_all()  # one host copy in flight (a failed earlier commit raises here)
    _IO_STATE.register(tag)  # before the tag exists: retention must not take it
    queued = False
    try:
        # re-saving a tag drops its marker FIRST: a crash mid-rewrite must not
        # leave a half-written tag that still passes the done check
        storage.remove_file(os.path.join(tag, DONE_MARKER))
        storage.prepare_tag(tag)
        if user_content is not None:
            storage.save_text(json.dumps(user_content), os.path.join(tag, META_FILE))
        host = _to_host(items)
        if async_save:
            _IO_STATE.begin(storage, tag, host, num_kept_ckpts)
            queued = True  # the worker unregisters after the commit
            return
        from neuronx_distributed_tpu_torch.integrity.checkpoint import write_manifest

        # the manifest BEFORE the marker blesses the payload
        write_manifest(storage, tag, known=_write_items(storage, tag, host))
        _commit(storage, tag, num_kept_ckpts, current_tag=tag)
    finally:
        if not queued:
            _IO_STATE.unregister(tag)


def latest_checkpoint_tag(checkpoint_dir: str) -> Optional[str]:
    """The newest completed tag: the ``newest`` pointer when its tag holds
    a marker, else the newest tag with one. A pointer at a tag without a
    marker (killed between the payload and the marker) removes that tag,
    unless its save is in flight in this process, and repoints ``newest``
    at the fallback. One writer process a directory, as in JAX."""
    storage = create_checkpoint_storage(checkpoint_dir)
    corrupt_newest = None
    if storage.file_exists(NEWEST_FILE):
        tag = storage.load_text(NEWEST_FILE).strip()
        if storage.file_exists(os.path.join(tag, DONE_MARKER)):
            return tag
        if tag not in _IO_STATE.in_flight_tags():
            corrupt_newest = tag
    done = [t for t in storage.list_checkpoint_tags()
            if storage.file_exists(os.path.join(t, DONE_MARKER))]
    newest_done = max(done, key=lambda t: _tag_order_key(storage, t)) if done else None
    if corrupt_newest is not None:
        logger.warning("newest pointer targets '%s' which has no done marker (killed mid-save?) "
                       "— removing it and falling back to the newest completed tag",
                       corrupt_newest)
        storage.remove_checkpoint(corrupt_newest)
        if newest_done is not None:
            storage.save_text(newest_done, NEWEST_FILE)
        else:
            storage.remove_file(NEWEST_FILE)
    return newest_done


def _read_item(storage: BaseCheckpointStorage, tag: str, name: str) -> Dict[str, torch.Tensor]:
    root = _item_dir(tag, name)
    flat: Dict[str, torch.Tensor] = {}
    for rel in storage.list_files(root):
        if rel.endswith(".pt"):
            flat.update(storage.read_payload(os.path.join(root, rel)))
    return flat


def _check_target(name: str, target, flat: Mapping[str, torch.Tensor]) -> List[Tuple]:
    """``(dst, src)`` pairs of an in-place load, every key, shape and dtype
    checked first (``copy_state_dict_``'s rule)."""
    own = _flatten(target)
    keys = {k for k, _ in own}
    missing, unexpected = sorted(keys - set(flat)), sorted(set(flat) - keys)
    if missing or unexpected:
        raise ValueError(f"checkpoint item {name!r} does not match its target: missing "
                         f"{missing[:4]}{'...' if len(missing) > 4 else ''}, unexpected "
                         f"{unexpected[:4]}{'...' if len(unexpected) > 4 else ''}")
    pairs = []
    for k, dst in own:
        src = flat[k]
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"checkpoint item {name!r}[{k!r}] is {src.dtype} "
                             f"{tuple(src.shape)}; the target holds {dst.dtype} "
                             f"{tuple(dst.shape)}")
        pairs.append((dst, src))
    return pairs


def load_checkpoint(checkpoint_dir: str, tag: Optional[str] = None,
                    items_target: Optional[Mapping[str, Any]] = None,
                    verify_integrity: bool = True,
                    on_corrupt=None) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], str]:
    """``(items, user_content, tag)`` from ``checkpoint_dir``.

    ``tag=None`` resolves the newest completed tag. ``items_target`` maps
    item names to a module or a tree of tensors filled IN PLACE (every
    item's keys, shapes and dtypes checked before the first write; the item
    returned is the target itself) or to None (loaded as a tree of CPU
    tensors); only the named items are read. Without it every item loads
    as CPU tensors.

    With ``verify_integrity`` every manifested file is re-digested before
    a byte is loaded: a mismatch strips the tag's marker, calls
    ``on_corrupt(tag, detail)`` and falls back to the previous completed
    tag (``FileNotFoundError`` when none passes). A tag without a manifest
    loads as ``legacy``."""
    storage = create_checkpoint_storage(checkpoint_dir)
    if tag is None:
        tag = latest_checkpoint_tag(checkpoint_dir)
        if tag is None:
            raise FileNotFoundError(f"no completed checkpoint under {checkpoint_dir}")
    if not storage.file_exists(os.path.join(tag, DONE_MARKER)):
        raise FileNotFoundError(f"checkpoint '{tag}' has no done marker (corrupted?)")
    if verify_integrity:
        from neuronx_distributed_tpu_torch.integrity.checkpoint import verify_manifest

        while True:
            ok, detail = verify_manifest(storage, tag)
            if ok:
                if detail == "legacy":
                    logger.info("checkpoint '%s' predates integrity manifests — loading "
                                "unverified", tag)
                break
            logger.error("checkpoint '%s' FAILED integrity verification (%s) — quarantining "
                         "it and falling back to the previous completed tag", tag, detail)
            if on_corrupt is not None:
                on_corrupt(tag, detail)
            # without its marker the tag is invisible to latest_checkpoint_tag,
            # whose corrupt-newest cleanup removes it and repoints `newest`
            storage.remove_file(os.path.join(tag, DONE_MARKER))
            tag = latest_checkpoint_tag(checkpoint_dir)
            if tag is None:
                raise FileNotFoundError(f"no completed checkpoint under {checkpoint_dir} "
                                        "passes integrity verification")
    names = list(items_target) if items_target is not None else storage.list_items(tag)
    flats = {name: _read_item(storage, tag, name) for name in names}
    copies = {name: _check_target(name, items_target[name], flats[name])
              for name in names if items_target is not None and items_target[name] is not None}
    items: Dict[str, Any] = {}
    with torch.no_grad():
        for name in names:
            if name in copies:
                for dst, src in copies[name]:
                    dst.copy_(src)
                items[name] = items_target[name]
            else:
                items[name] = _unflatten(flats[name])
    user_content = None
    if storage.file_exists(os.path.join(tag, META_FILE)):
        user_content = json.loads(storage.load_text(os.path.join(tag, META_FILE)))
    return items, user_content, tag
