"""Build and load the CUDA kernels of ``csrc/`` (no JAX counterpart: Pallas
compiles inside ``jit``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library that ``ctypes`` loads — no
PyTorch headers, so a build takes seconds. Libraries land in ``build/kernels``
at the repository root (git-ignored), named by a hash of the source and the
shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt and a built
one is reused. ``nvcc`` runs with ``-Xptxas -v``; its report (registers,
shared memory and spills of every kernel) is kept beside each library and
read with :func:`resource_report`. The attention kernels are also built
for the other head dims of ``HEAD_DIMS``: ``<source>_d<d>`` (say
``flash_attention_d96``) is ``csrc/<source>.cu`` under that head dim's
flags, named and hashed apart from the default build (head dim 128), so
the two never mix; :func:`head_dim_lib` names the library of a head dim and
:func:`head_dim_counter` the launch count of its build.
Every pointer and the stream cross as
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
import time
from typing import Callable, Dict, Iterable, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the head dim of every default build
DEFAULT_HEAD_DIM = 128
# the attention kernels' other head dims -> their extra nvcc flags; the
# build of csrc/<source>.cu for head dim d is the library <source>_d<d>
HEAD_DIMS = {96: ["-DNXD_HEAD_DIM=96"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compile-event callbacks ``fn(event, seconds, name=)``: "build" (an nvcc
# run), "load" (a library loaded), "capture" (a CUDA graph captured, from
# inference/graphs.py); observability/profiler.install_compile_listener
# adds one
COMPILE_LISTENERS: List[Callable] = []
# nvcc runs and library loads in this process
stats = {"builds": 0, "loads": 0}


def notify(event: str, seconds: float, **kw) -> None:
    """Tell every compile listener of one event."""
    for fn in list(COMPILE_LISTENERS):
        fn(event, seconds, **kw)


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


def head_dim_lib(name: str, d: int) -> str:
    """The library of ``csrc/<name>.cu`` built for head dim ``d`` (the
    default build for 128, ``<name>_d<d>`` for a head dim of
    ``HEAD_DIMS``); ValueError for any other."""
    if d == DEFAULT_HEAD_DIM:
        return name
    if d not in HEAD_DIMS:
        dims = " and ".join(map(str, [DEFAULT_HEAD_DIM, *HEAD_DIMS]))
        raise ValueError(f"{name} is built for head_dim {dims}, got {d}")
    return f"{name}_d{d}"


def head_dim_counter(wrapper, d: int):
    """The launch counter of ``wrapper``'s build for head dim ``d``: the
    wrapper itself for 128, its attribute ``d<d>`` for another."""
    return wrapper if d == DEFAULT_HEAD_DIM else getattr(wrapper, f"d{d}")


def _source(name: str):
    """(source name, extra flags) of a library: ``<source>_d<d>`` is the
    source's build for head dim d."""
    for d, flags in HEAD_DIMS.items():
        if name.endswith(f"_d{d}"):
            return name[:-len(f"_d{d}")], flags
    return name, []


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the shared headers
    of ``csrc/`` (which every source may include) and the flags."""
    src, extra = _source(name)
    h = hashlib.sha1(" ".join(NVCC_FLAGS + extra).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [src + ".cu", *headers]:
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
    src, extra = _source(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, os.path.join(CSRC, src + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return out, tmp, proc


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together."""
    t0 = time.perf_counter()
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
            stats["builds"] += 1
            notify("build", time.perf_counter() - t0, name=os.path.basename(out))
    if errors:
        raise KernelError("\n".join(errors))


def lib_name(name: str) -> str:
    """The file name of library ``name`` (``csrc/<name>.cu``, or its
    build for another head dim): ``lib<name>-<hash>.so``, the hash over its source,
    the shared headers and the flags."""
    return os.path.basename(_lib_path(name))


def loaded() -> Dict[str, str]:
    """The libraries this process has loaded: source name -> file name."""
    return {name: lib_name(name) for name in sorted(_libs)}


def load(name: str, path: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, or
    loaded from ``path`` (a library built from the same sources: the
    caller checks its name, ``inference/aot.py``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            if path is None:
                build([name])
                path = _lib_path(name)
            lib = ctypes.CDLL(path)
            _libs[name] = lib
            stats["loads"] += 1
            notify("load", time.perf_counter() - t0, name=name)
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
