"""Program manifests and the warm spawn (counterpart of
``neuronx_distributed_tpu/inference/aot.py``, the parts with a counterpart:
``SkewError`` ``:81``, ``encode_call`` ``:194``, ``materialize_call``
``:261``, ``call_signature`` ``:300``, ``ProgramManifest`` ``:319`` and
``prewarm_programs`` ``:584``).

A :class:`ProgramManifest` records every program a serving engine's ledger
(``observability/programs.py``) has seen: its name and, per signature, the
description of each argument (shape and dtype of a tensor, value of a
scalar, the type of an opaque object such as a cache view), plus the kernel
libraries the process had loaded (``kernels/_build.py``: file names that
carry the hash of their sources). It is JSON, saved beside a checkpoint.

:func:`prewarm_programs` replays it on a fresh engine before the first
request: each program dispatched once with dummies that match its recorded
arguments, under ``ledger.prewarming()``, so that the compiles (the decode
step's CUDA-graph capture, each variant's first dispatch) and the kernel
loads happen then and not inside a request's TTFT. Only that rung, JAX's
"replayed", exists here: a CUDA graph cannot be serialized (it is captured
in the process that replays it), so the report's ``deserialized`` stays
empty, and PyTorch runs the rest eagerly, with no compile cache to fill.
``cache_dir`` names a directory of kernel libraries built by ``_build.py``
(:func:`save_kernels`); :func:`load_kernels` loads them instead of running
``nvcc`` and raises :class:`SkewError` when their source hash differs from
the tree's.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.observability.programs import _pedigree, call_signature

__all__ = ["MANIFEST_NAME", "Opaque", "ProgramManifest", "SkewError", "UnportableError",
           "call_signature", "encode_call", "load_kernels", "materialize_call",
           "prewarm_programs", "save_kernels"]

MANIFEST_NAME = "manifest.json"
_FORMAT = 1


class SkewError(RuntimeError):
    """A cached kernel library was built from other sources than this tree's
    (its hash differs): it must not be loaded."""


class UnportableError(RuntimeError):
    """A call cannot be encoded or replayed faithfully (an opaque object)."""


class Opaque:
    """The stand-in :func:`materialize_call` puts where the recorded call
    held an opaque object (a cache view): the engine's replayer supplies its
    own."""

    def __init__(self, type_name: str):
        self.type_name = type_name

    def __repr__(self) -> str:
        return f"Opaque({self.type_name})"


def _encode_leaf(x) -> dict:
    if isinstance(x, np.ndarray):
        return {"t": "np", "shape": list(x.shape), "dtype": str(x.dtype)}
    ped = _pedigree(x)
    if ped["t"] == "opaque":
        raise UnportableError(f"opaque leaf {type(x).__name__}")
    return ped


def encode_call(args, kwargs=None, pedigree=None) -> dict:
    """Encode one call, ``(args, kwargs)``, as JSON-safe per-argument nodes:
    a tensor's shape, dtype and device kind, a numpy array's shape and
    dtype, a scalar's value, a sequence's items. Concrete opaque objects
    raise :class:`UnportableError`; a ledger's recorded ``pedigree`` (whose
    opaque arguments are type names) is taken as it is."""
    if pedigree is not None:
        return {"t": "call", "args": list(pedigree["args"]),
                "kwargs": dict(pedigree.get("kwargs", {}))}
    return {"t": "call", "args": [_encode_leaf(a) for a in args],
            "kwargs": {k: _encode_leaf(v) for k, v in dict(kwargs or {}).items()}}


def _dummy(node: dict, device):
    t = node.get("t")
    if t == "py":
        return node["v"]
    if t == "np":
        return np.zeros(tuple(node["shape"]), np.dtype(node["dtype"]))
    if t == "tensor":
        dev = device if node.get("device", "cpu") != "cpu" else "cpu"
        return torch.zeros(tuple(node["shape"]), dtype=getattr(torch, node["dtype"]), device=dev)
    if t == "seq":
        items = [_dummy(n, device) for n in node["items"]]
        return tuple(items) if node.get("tuple") else items
    if t == "opaque":
        return Opaque(node.get("type", "?"))
    raise UnportableError(f"unknown manifest leaf {t!r}")


def materialize_call(node: dict, device=None):
    """Dummy ``(args, kwargs)`` for one encoded call: zeros of each recorded
    shape and dtype (on ``device`` when the recorded tensor was on a
    device), each scalar's recorded value, :class:`Opaque` stand-ins."""
    if not isinstance(node, dict) or node.get("t") != "call":
        raise UnportableError("manifest call node is not an encoded call")
    args = tuple(_dummy(n, device) for n in node["args"])
    kwargs = {k: _dummy(n, device) for k, n in node.get("kwargs", {}).items()}
    return args, kwargs


class ProgramManifest:
    """Every program a ledger recorded: ``programs`` maps a name to its
    variants ``{"signature", "call", "portable", "note"}``; ``meta`` holds
    the format, the torch version, the device and the loaded kernel
    libraries (``kernels``: source name -> file name)."""

    def __init__(self, programs: Dict[str, List[dict]], meta=None):
        self.programs = programs
        self.meta = dict(meta or {})

    @classmethod
    def from_ledger(cls, ledger, names=None) -> "ProgramManifest":
        from neuronx_distributed_tpu_torch.kernels import _build

        programs: Dict[str, List[dict]] = {}
        for name, info in ledger.programs().items():
            if names is not None and name not in names:
                continue
            entries = []
            for var in info.variants:
                entry: Dict[str, Any] = {"signature": var.signature, "call": None,
                                         "portable": False, "note": ""}
                if var.captured:
                    entry["call"] = encode_call(None, None, var.pedigree)
                    entry["portable"] = True
                else:
                    entry["note"] = "signature not captured"
                entries.append(entry)
            programs[name] = entries
        peaks = ledger.peaks
        meta = {"format": _FORMAT, "torch": torch.__version__, "platform": peaks["platform"],
                "device_kind": peaks["kind"], "kernels": _build.loaded()}
        return cls(programs, meta)

    def names(self):
        return list(self.programs)

    def entries(self, name: str) -> List[dict]:
        return list(self.programs.get(name, ()))

    def to_json(self) -> dict:
        return {"meta": self.meta, "programs": self.programs}

    @classmethod
    def from_json(cls, obj: dict) -> "ProgramManifest":
        if not isinstance(obj, dict) or "programs" not in obj:
            raise ValueError("not a ProgramManifest JSON object")
        return cls(dict(obj["programs"]), obj.get("meta"))

    def save(self, path: str) -> str:
        """Write as JSON: ``path`` a directory (``manifest.json`` inside) or
        a file. Atomic replace."""
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "ProgramManifest":
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        with open(path) as f:
            return cls.from_json(json.load(f))


# --- kernel libraries -------------------------------------------------------


def save_kernels(cache_dir: str) -> List[str]:
    """Copy every kernel library this process has loaded into ``cache_dir``
    (file names carry their source hash). Returns the file names."""
    from neuronx_distributed_tpu_torch.kernels import _build

    os.makedirs(cache_dir, exist_ok=True)
    out = []
    for fname in _build.loaded().values():
        src = os.path.join(_build.BUILD_DIR, fname)
        dst = os.path.join(cache_dir, fname)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst + ".tmp")
            os.replace(dst + ".tmp", dst)
        out.append(fname)
    return out


def load_kernels(cache_dir: Optional[str], kernels: Dict[str, str]) -> List[str]:
    """Check and load the kernel libraries a manifest names (``kernels``:
    source name -> file name): :class:`SkewError` when a recorded file name
    (its source hash) differs from the one this tree builds; each library
    present in ``cache_dir`` is loaded from there, the others are built.
    Returns the names loaded from ``cache_dir``."""
    from neuronx_distributed_tpu_torch.kernels import _build

    for name, fname in sorted(kernels.items()):
        want = _build.lib_name(name)
        if fname != want:
            raise SkewError(f"kernel library {fname} was built from other sources than this "
                            f"tree's ({want}): rebuild the cache")
    if not torch.cuda.is_available():
        return []
    cached = []
    for name, fname in sorted(kernels.items()):
        path = os.path.join(cache_dir, fname) if cache_dir is not None else None
        if path is not None and os.path.exists(path):
            _build.load(name, path=path)
            cached.append(name)
        else:
            _build.load(name)
    return cached


# --- prewarm ----------------------------------------------------------------


def prewarm_programs(manifest: ProgramManifest, resolve: Callable[[str], Any], *, ledger=None,
                     cache_dir: Optional[str] = None, flight=None, device=None) -> dict:
    """Replay every manifest program once before the first request:
    ``resolve(name)`` gives the callable (the live ledger proxy, or an
    engine's replayer for a program with opaque arguments), called with
    :func:`materialize_call`'s dummies under ``ledger.prewarming()``. The
    kernel libraries of ``manifest.meta["kernels"]`` are loaded first
    (:func:`load_kernels`; :class:`SkewError` raises). JAX's ``mode=``
    has no counterpart: the replay is the one rung. A program that is not
    replayed by design (``resolve`` raises :class:`UnportableError` with
    the reason) or an entry that is not portable is ``skipped``; a program
    this engine does not have (``resolve`` gives None) or a replay that
    raises a ``ValueError``, ``TypeError``, ``IndexError`` or another
    ``RuntimeError`` (arguments this engine's program does not take) is
    ``failed``; a CUDA error, an out-of-memory
    error and a kernel's build or launch error (``KernelError``) raise,
    since the context or the kernel is then unusable. The report:
    ``replayed``, ``compiled`` (replays that compiled), ``skipped``,
    ``failed``, ``kernels_cached``, ``deserialized`` (always empty: no rung
    of serialized programs), ``skew`` and ``wall_s``."""
    import contextlib
    import time

    from neuronx_distributed_tpu_torch.kernels._build import KernelError

    t0 = time.perf_counter()
    report: Dict[str, Any] = {"deserialized": [], "compiled": [], "replayed": [], "skipped": {},
                              "failed": {}, "skew": [], "kernels_cached": []}

    def note(event, **kw):
        if flight is not None:
            flight.record(event, **kw)

    report["kernels_cached"] = load_kernels(cache_dir, manifest.meta.get("kernels", {}))
    scope = ledger.prewarming() if ledger is not None else contextlib.nullcontext()
    with scope:
        for name in manifest.names():
            entries = manifest.entries(name)
            try:
                fn, why = resolve(name), None
            except UnportableError as e:
                fn, why = None, str(e)
            for entry in entries:
                key = f"{name}@{entry['signature']}" if len(entries) > 1 else name
                if why is not None:
                    report["skipped"][key] = why
                    continue
                if fn is None:
                    report["failed"][key] = "no such program on this engine"
                    continue
                if not entry.get("portable") or entry.get("call") is None:
                    report["skipped"][key] = entry.get("note") or "not portable"
                    continue
                try:
                    args, kwargs = materialize_call(entry["call"], device)
                except UnportableError as e:
                    report["skipped"][key] = str(e)
                    continue
                compiles = getattr(getattr(fn, "_record", None), "compiles", None)
                try:
                    fn(*args, **kwargs)
                except (torch.AcceleratorError, torch.cuda.OutOfMemoryError, KernelError):
                    raise
                except (RuntimeError, ValueError, TypeError, IndexError) as e:
                    report["failed"][key] = f"{type(e).__name__}: {e}"[:200]
                    note("aot_prewarm_failed", program=name, error=report["failed"][key])
                    continue
                report["replayed"].append(key)
                rec = getattr(fn, "_record", None)
                if getattr(fn, "last_call_compiled", False) or (
                        compiles is not None and rec.compiles != compiles):
                    report["compiled"].append(key)
    report["wall_s"] = round(time.perf_counter() - t0, 4)
    note("aot_prewarm", replayed=len(report["replayed"]), compiled=len(report["compiled"]),
         skipped=len(report["skipped"]), failed=len(report["failed"]), wall_s=report["wall_s"])
    return report
