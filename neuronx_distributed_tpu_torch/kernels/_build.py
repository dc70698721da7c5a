"""Build and load the CUDA kernels of ``csrc/`` (no JAX counterpart: Pallas
compiles inside ``jit``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library that ``ctypes`` loads — no
PyTorch headers, so a build takes seconds. Libraries land in ``build/kernels``
at the repository root (git-ignored), named by a hash of the source and the
shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt and a built
one is reused. ``nvcc`` runs with ``-Xptxas -v``; its report (registers,
shared memory and spills of every kernel) is kept beside each library and
read with :func:`resource_report`. Every pointer and the stream cross as
``c_void_p`` (a strides array as a pointer to ``c_longlong``); each C entry
point returns ``cudaGetLastError()`` (or one of ``hopper.cuh``'s codes of
900 and up when a TMA tensor map cannot be made) and :func:`check` raises
when it is not 0. A failed build or launch raises :class:`KernelError`,
which the serving engine never treats as a recoverable fault.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel library that could not be built, or a launch its entry
    point refused: a fault of the program or the card, never retried."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found: the CUDA kernels are built on the GPU machine")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the shared headers
    of ``csrc/`` (which every source may include) and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(final_path, tmp_path, process)`` or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return out, tmp, proc


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together."""
    jobs: List = [j for j in (_start_build(n) for n in names) if j is not None]
    errors = []
    for out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {out}:\n{log.decode(errors='replace')}")
        else:
            with open(out + ".ptxas.txt", "wb") as f:
                f.write(log)
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise KernelError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def resource_report(name: str) -> str:
    """``ptxas -v``'s report for ``csrc/<name>.cu`` (built on first use)."""
    build([name])
    with open(_lib_path(name) + ".ptxas.txt", encoding="utf-8", errors="replace") as f:
        return f.read()


def check(err: int, what: str) -> None:
    if err >= 900:  # hopper.cuh's codes: no tensor-map encoder, or a map refused
        raise KernelError(f"{what}: could not make a TMA tensor map (code {err})")
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
