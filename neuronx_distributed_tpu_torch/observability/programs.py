"""The program ledger: per-program dispatches, compiles, cost and roofline
(counterpart of ``neuronx_distributed_tpu/observability/programs.py``:
``weak_reader`` ``:88``, ``device_peaks`` ``:121``,
``_Variant``/``VariantInfo``/``ProgramInfo``, ``LedgeredProgram`` ``:465``
and ``ProgramLedger`` ``:524``; JAX's ``per_instance`` ``:69`` isolates jit
caches per engine, and the port's programs keep no cache keyed on the
function object, so it has no counterpart).

What the port calls a PROGRAM is each callable the serving engine dispatches
(the captured decode and speculative steps, the eager prefills by padded
length, the suffix prefills, slot write and clear, the first-token step,
prefix extract and seed, the page and integrity fingerprints), wrapped by
:meth:`ProgramLedger.wrap` in a :class:`LedgeredProgram` that counts its
dispatches on the host. A COMPILE is a variant's first dispatch (a new
signature, :func:`call_signature`: the shapes and dtypes of the tensor
arguments, the types of the scalar ones) or, for a program that captures a
CUDA graph (the decode step, ``inference/graphs.DecodeProgram``), the
capture.

Cost, once per variant, never at a replay and never at an ordinary
dispatch (a request must not pay for it): at the variant's first dispatch
under :meth:`ProgramLedger.prewarming` (a manifest prewarm,
``inference/aot.py``), at a graph program's capture (its eager
warm-up; on the CPU, where nothing is captured, its first dispatch), or at
the first dispatch of a program wrapped with ``meter_first=True`` (the
trainer's steps: no request waits on them), the call runs under
:class:`CostMeter`, a ``TorchDispatchMode``. A variant
first dispatched outside both is a compile that runs unmetered, and its
cost reads UNAVAILABLE until a prewarm dispatches it. The meter counts

* FLOPs of the aten ops that ``torch.utils.flop_counter`` has formulas for:
  products only (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
  convolutions, ``_scaled_mm`` and the fused attention ops); elementwise
  ops, reductions and softmax count 0, as XLA's cost analysis nearly does;
* bytes as each op's operand bytes plus its output bytes (XLA's "bytes
  accessed" convention): views and ``empty`` move none;
* each port kernel's own count, from its wrapper (:func:`kernel_cost`,
  the formulas ``chip_smoke.py`` bounds it with, on shapes only: the
  decode kernels count every column they are handed, as a static cost
  analysis would), with the aten ops of its plain version not counted
  again. So a program costs the same on the CPU and the card.

The hot path touches only host state (a counter, the signature's host
metadata, two clock reads): the engine's ``host_reads`` are the same with
the ledger as without it. MFU and bandwidth use are derived at export from
the walls the caller feeds (:meth:`ProgramLedger.observe_wall`) against
:func:`device_peaks`; any gap reads ``"unavailable"``
(:data:`UNAVAILABLE`), never a guessed number."""

from __future__ import annotations

import contextlib
import functools
import hashlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry, MetricsView

__all__ = ["UNAVAILABLE", "CostMeter", "LedgeredProgram", "ProgramInfo", "ProgramLedger",
           "VariantInfo", "call_signature", "device_peaks", "kernel_cost", "metered",
           "weak_reader"]

UNAVAILABLE = "unavailable"


def weak_reader(target, fn, default=0):
    """A lazy read over a WEAK reference to ``target``: ``fn(target)``, or
    ``default`` when the target is gone or the value is not a number. A
    ledger or registry kept for a last scrape never pins a retired
    engine."""
    ref = weakref.ref(target)

    def read():
        obj = ref()
        if obj is None:
            return default
        v = fn(obj)
        return v if isinstance(v, (int, float)) else default

    return read


# Dense peaks by device-name substring: bf16 tensor-core FLOP/s and memory
# bytes/s from NVIDIA's datasheets (SXM parts at their full power limit;
# the PCIe H100 at its own). An unknown name (the CPU) reports UNAVAILABLE.
_PEAKS = (
    ("h100 pcie", 756e12, 2.0e12, "datasheet, H100 PCIe: 756 TFLOP/s dense bf16, 2.0 TB/s"),
    ("h100", 989e12, 3.35e12, "datasheet, H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s"),
    ("h200", 989e12, 4.8e12, "datasheet, H200 SXM: 989 TFLOP/s dense bf16, 4.8 TB/s"),
)


def device_peaks(device=None) -> dict:
    """``{"flops", "hbm_bytes_per_s", "kind", "platform", "source"}`` for
    ``device`` (default: the current CUDA device, else the CPU). The peaks
    are datasheet figures, not measurements; a device not in the table
    (the CPU) reports UNAVAILABLE."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        kind, platform = torch.cuda.get_device_name(dev), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    for sub, flops, bw, source in _PEAKS:
        if dev.type == "cuda" and sub in kind.lower():
            return {"flops": flops, "hbm_bytes_per_s": bw, "kind": kind, "platform": platform,
                    "source": source}
    return {"flops": UNAVAILABLE, "hbm_bytes_per_s": UNAVAILABLE, "kind": kind,
            "platform": platform, "source": f"unknown device kind {kind!r}"}


# --- cost ---------------------------------------------------------------------

_ACTIVE = threading.local()  # the meter of this thread's metered dispatch


def _grouped_mm_flops(mat_a, mat_b, *args, out_val=None, **kwargs) -> int:
    """``torch._grouped_mm``'s count (``torch.utils.flop_counter`` has none).
    Grouped along the rows, (N, in) x (E, in, out) -> (N, out) (the MoE
    blockwise route's products and their input gradients): every row
    through one group's weight, 2 x in x the output's elements. Grouped
    along the contraction, (M, N) x (N, K) with ``offs`` -> (E, M, K) (the
    weight gradients): every one of the N columns in one group, 2 x M x N x K,
    not 2 x N x the E groups' outputs. Batched, (E, M, in) x (E, in, out):
    2 x in x the output's elements."""
    if mat_a.dim() == 2 and mat_b.dim() == 2 and out_val.dim() == 3:
        return 2 * mat_a.shape[0] * mat_a.shape[1] * mat_b.shape[1]
    k = mat_a.shape[-1] if mat_a.dim() == 2 and mat_b.dim() == 3 else mat_b.shape[-2]
    return 2 * k * out_val.numel()


# FLOP formulas for products ``flop_registry`` lacks, by op packet
_EXTRA_FLOPS = {torch.ops.aten._grouped_mm: _grouped_mm_flops}
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


class CostMeter(TorchDispatchMode):
    """Counts the FLOPs and bytes of what runs under it (module docstring).
    ``flops``/``bytes`` are floats; ``kernels`` counts the port kernels'
    calls by name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self._suppress = 0
        self._prev = None

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # TorchDispatchMode otherwise wraps __torch_dispatch__ so that
        # torch.compile never traces into it, and the wrapper's first call
        # imports torch._dynamo: seconds in a fresh process (on the capture
        # that meters the decode step), after which torch.fx keeps the
        # calling stack, an engine, for the process's life. Nothing of the
        # port runs under torch.compile.
        return False

    def __enter__(self):
        self._prev = getattr(_ACTIVE, "meter", None)
        _ACTIVE.meter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.meter = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suppress:
            return out
        packet = func._overloadpacket
        formula = flop_registry.get(packet) or _EXTRA_FLOPS.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        returns = func._schema.returns
        is_view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                        for r in returns)
        if not is_view and packet.__name__ not in _NO_DATA:
            self.bytes += float(_tensor_bytes(args) + _tensor_bytes(kwargs)
                                + _tensor_bytes(out))
        return out


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return 0


@contextlib.contextmanager
def kernel_cost(name: str, flops: float, nbytes: float):
    """A port kernel's own count, noted on the thread's active meter (none
    outside a metered dispatch); the aten ops inside (the plain version on
    the CPU, the wrapper's allocations on the card) are not counted again."""
    meter = getattr(_ACTIVE, "meter", None)
    if meter is None:
        yield
        return
    if not meter._suppress:
        meter.flops += float(flops)
        meter.bytes += float(nbytes)
        meter.kernels[name] = meter.kernels.get(name, 0) + 1
    meter._suppress += 1
    try:
        yield
    finally:
        meter._suppress -= 1


def metered(name: str, cost: Callable[..., Tuple[float, float]]):
    """Decorate a kernel wrapper with its cost formula ``cost(*args,
    **kwargs) -> (flops, bytes)``, evaluated only inside a metered
    dispatch (outside one the wrapper costs one attribute read more)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if getattr(_ACTIVE, "meter", None) is None:
                return fn(*args, **kwargs)
            with kernel_cost(name, *cost(*args, **kwargs)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# --- signatures ---------------------------------------------------------------


def _leaf_sig(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype)[6:]}{list(x.shape)}"
    if isinstance(x, (bool, str)) or x is None:
        return repr(x)
    if isinstance(x, (int, float)):
        return type(x).__name__  # a value that changes per call is no new variant
    if isinstance(x, (list, tuple)):
        return f"{type(x).__name__}[{len(x)}]" if all(
            isinstance(v, int) for v in x) else "(" + ",".join(_leaf_sig(v) for v in x) + ")"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_leaf_sig(v)}" for k, v in sorted(x.items())) + "}"
    return type(x).__name__


def _in_bytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_in_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_in_bytes(v) for v in x.values())
    return _tensor_bytes(x)


def call_signature(args, kwargs=None) -> str:
    """A short stable id of a call's signature (JAX ``aot.call_signature``):
    a digest over each argument's dtype and shape (tensors), value (bool,
    str), type (int, float: a host scalar that changes per call, a seed or
    a slot, makes no new variant; a list of ints by its length) or type
    name (other objects), with the argument count and the tensors' bytes.
    Host metadata only."""
    args, kwargs = tuple(args), dict(kwargs or {})
    body = _leaf_sig(args) + "|" + _leaf_sig(kwargs)
    digest = hashlib.sha1(body.encode()).hexdigest()[:10]
    return f"{digest}:{len(args) + len(kwargs)}args:{_in_bytes((args, kwargs))}B"


def _pedigree(x):
    """The replayable description of one argument (``inference/aot.py``
    encodes and materializes it): a tensor's shape, dtype and device kind, a
    scalar's value, a sequence's items; other objects are opaque."""
    if isinstance(x, torch.Tensor):
        return {"t": "tensor", "shape": list(x.shape), "dtype": str(x.dtype)[6:],
                "device": x.device.type}
    if isinstance(x, (bool, int, float, str)) or x is None:
        return {"t": "py", "v": x}
    if isinstance(x, (list, tuple)):
        return {"t": "seq", "tuple": isinstance(x, tuple), "items": [_pedigree(v) for v in x]}
    return {"t": "opaque", "type": type(x).__name__}


# --- records ------------------------------------------------------------------


class _Variant:
    """One signature of a program: its pedigree (for a replay) and its cost,
    recorded once."""

    __slots__ = ("sig", "pedigree", "analyzed", "flops", "bytes_accessed", "kernels",
                 "cost_source")

    def __init__(self, sig: str, pedigree=None):
        self.sig = sig
        self.pedigree = pedigree
        self.analyzed = False
        self.flops: Any = UNAVAILABLE
        self.bytes_accessed: Any = UNAVAILABLE
        self.kernels: Dict[str, int] = {}
        self.cost_source = UNAVAILABLE

    def fill_from(self, meter: CostMeter, source: str) -> None:
        self.analyzed = True
        self.flops = meter.flops
        self.bytes_accessed = meter.bytes
        self.kernels = dict(meter.kernels)
        self.cost_source = source


class VariantInfo:
    """Read-only view of one signature of a ledgered program."""

    __slots__ = ("signature", "_variant")

    def __init__(self, variant: _Variant):
        self.signature = variant.sig
        self._variant = variant

    @property
    def captured(self) -> bool:
        return self._variant.pedigree is not None

    @property
    def pedigree(self):
        """``{"args": [...], "kwargs": {...}}`` of per-argument descriptions
        (see ``inference/aot.py``), recorded at the first dispatch."""
        return self._variant.pedigree


class _ProgramRecord:
    """The accumulating ledger entry of one named program."""

    __slots__ = ("name", "dispatches", "compiles", "compile_wall_s", "variants", "last_wall_s",
                 "wall_hist", "c_dispatch", "c_compiles", "prewarm_dispatches")

    def __init__(self, name: str):
        self.name = name
        self.dispatches = 0
        self.prewarm_dispatches = 0
        self.compiles = 0
        self.compile_wall_s = 0.0
        self.variants: "OrderedDict[str, _Variant]" = OrderedDict()
        self.last_wall_s: Optional[float] = None
        self.wall_hist = None
        self.c_dispatch = None
        self.c_compiles = None

    def sole_variant(self) -> Optional[_Variant]:
        if len(self.variants) == 1:
            return next(iter(self.variants.values()))
        return None


class ProgramInfo:
    """Read-only view of one ledgered program."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str, record: _ProgramRecord):
        self.name = name
        self._record = record

    @property
    def dispatches(self) -> int:
        return self._record.dispatches

    @property
    def compiles(self) -> int:
        return self._record.compiles

    @property
    def prewarm_dispatches(self) -> int:
        """Dispatches inside :meth:`ProgramLedger.prewarming`, kept out of
        ``dispatches``."""
        return self._record.prewarm_dispatches

    @property
    def variants(self) -> Tuple[VariantInfo, ...]:
        return tuple(VariantInfo(v) for v in self._record.variants.values())


class LedgeredProgram:
    """A dispatch proxy over one callable: counts its dispatches, notes a
    compile at a new signature or a graph capture (and records that
    variant's cost), and forwards every other attribute to the callable
    (``captures``, ``replays``, ``launches_per_replay`` of a
    ``DecodeProgram``). ``last_call_compiled`` lets a caller skip a
    compile-polluted wall."""

    def __init__(self, ledger: "ProgramLedger", record: _ProgramRecord, fn,
                 meter_first: bool = False):
        self._ledger = ledger
        self._record = record
        self._inner = fn
        self._meter_first = meter_first
        self.last_call_compiled = False

    @property
    def __wrapped__(self):
        return self._inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _captures(self) -> Optional[int]:
        """A graph-capturing program's capture count on the card, else None."""
        inner = self._inner
        if getattr(inner, "device", None) is None or not hasattr(inner, "captures"):
            return None
        return inner.captures if inner.device.type == "cuda" else None

    def capture(self) -> float:
        """Compile a graph program now: on the card its capture
        (``DecodeProgram.capture``), with the compile and the warm-up's cost
        noted; on the CPU, where nothing is captured, its masked warm-up
        step once, metered, as the variant's first dispatch. Under
        :meth:`ProgramLedger.prewarming` it counts one prewarm dispatch.
        Returns the capture's wall (0 on the CPU)."""
        inner, rec, ledger = self._inner, self._record, self._ledger
        before = self._captures()
        seconds = 0.0
        self.last_call_compiled = False
        if before is not None:
            meter = CostMeter()
            inner.cost_meter = meter
            try:
                seconds = inner.capture()
            finally:
                inner.cost_meter = None
            if inner.captures != before:
                self.last_call_compiled = True
                ledger._note_compile(rec, (), {}, seconds, meter, "capture warm-up")
        elif hasattr(inner, "_warmup") and call_signature((), {}) not in rec.variants:
            meter = CostMeter()
            t0 = ledger._clock()
            with meter:
                inner._warmup()
            self.last_call_compiled = True
            ledger._note_compile(rec, (), {}, ledger._clock() - t0, meter, "warm-up step")
        if ledger._prewarm_depth:
            rec.prewarm_dispatches += 1
        return seconds

    def __call__(self, *args, **kwargs):
        rec, ledger = self._record, self._ledger
        inner = self._inner
        self.last_call_compiled = False
        captures = self._captures()
        if captures is not None:
            # a graph program captures at its own first call (or never, with
            # its step patched to run eagerly): meter that call's warm-up
            meter = CostMeter() if inner.graph is None else None
            inner.cost_meter = meter
            try:
                out = inner(*args, **kwargs)
            finally:
                inner.cost_meter = None
                if meter is not None and inner.captures != captures:
                    self.last_call_compiled = True
                    ledger._note_compile(rec, args, kwargs, inner.capture_s, meter,
                                         "capture warm-up")
        else:
            var = rec.variants.get(call_signature(args, kwargs))
            # metered only under prewarming() (or, on the CPU, at a graph
            # program's first dispatch, its capture's stand-in): an ordinary
            # dispatch, such as one serving a request, never runs under the
            # dispatch mode
            meter = CostMeter() if (var is None or not var.analyzed) and (
                ledger._prewarm_depth or hasattr(inner, "captures")
                or self._meter_first) else None
            if var is None:
                t0 = ledger._clock()
                try:
                    with meter if meter is not None else contextlib.nullcontext():
                        out = inner(*args, **kwargs)
                finally:
                    # a dispatch that raised still saw its signature once
                    self.last_call_compiled = True
                    ledger._note_compile(rec, args, kwargs, ledger._clock() - t0, meter,
                                         "prewarm dispatch" if ledger._prewarm_depth
                                         else "first dispatch")
            elif meter is not None:
                with meter:
                    out = inner(*args, **kwargs)
                var.fill_from(meter, "prewarm dispatch")
            else:
                out = inner(*args, **kwargs)
        if ledger._prewarm_depth:
            rec.prewarm_dispatches += 1
        else:
            rec.dispatches += 1
            if rec.c_dispatch is not None:
                rec.c_dispatch.inc()
        return out


class ProgramLedger:
    """Every program a subsystem dispatches (JAX ``ProgramLedger``).

    ``view``/``registry`` wire its labeled metric families
    (``{prefix}_program_dispatches{program=...}``, compiles, walls, FLOPs,
    achieved FLOP/s, MFU) into the shared metrics surface; with neither it
    keeps a registry of its own, so ``snapshot()`` always works. The export
    gauges hold weak references to the ledger."""

    def __init__(self, registry=None, view=None, prefix: str = "program",
                 subsystem: Optional[str] = None, timeline=None,
                 clock: Callable[[], float] = time.perf_counter, device=None):
        if view is None:
            view = MetricsView(registry if registry is not None else MetricsRegistry())
        self._view = view
        self.registry = view.registry
        self._prefix = prefix
        self._subsystem = subsystem or prefix
        self._timeline = timeline
        self._clock = clock
        self._prewarm_depth = 0
        self._records: "OrderedDict[str, _ProgramRecord]" = OrderedDict()
        self.peaks = device_peaks(device)
        name = self._name
        self._fam_dispatch = view.family("counter", name("program_dispatches"),
                                         labels=("program",),
                                         help="dispatches of each ledgered program")
        self._fam_compiles = view.family("counter", name("program_compiles"),
                                         labels=("program",),
                                         help="compiles (new signatures, graph captures) per "
                                              "ledgered program")
        self._fam_wall = view.family("histogram", name("program_wall_s"), labels=("program",),
                                     help="measured wall per dispatch (caller-fed; s)")
        self._fam_flops = view.family("gauge", name("program_flops"), labels=("program",),
                                      help="metered FLOPs per dispatch (-1 = unavailable)")
        self._fam_achieved = view.family("gauge", name("program_achieved_flops"),
                                         labels=("program",),
                                         help="FLOPs/s over the last observed wall "
                                              "(-1 = unavailable)")
        self._fam_mfu = view.family("gauge", name("program_mfu"), labels=("program",),
                                    help="achieved FLOPs/s over the device peak "
                                         "(-1 = unavailable)")
        self._h_compile = view.histogram(name("compile_wall_s"),
                                         help="wall of each compiling dispatch (s)")

    @property
    def view(self):
        return self._view

    def _name(self, suffix: str) -> str:
        return f"{self._prefix}_{suffix}" if self._prefix else suffix

    # --- registration ---------------------------------------------------------

    def _get_record(self, name: str) -> _ProgramRecord:
        rec = self._records.get(name)
        if rec is None:
            rec = _ProgramRecord(name)
            self._records[name] = rec
            view = self._view
            rec.c_dispatch = view.child(self._fam_dispatch, name)
            rec.c_compiles = view.child(self._fam_compiles, name)
            rec.wall_hist = view.child(self._fam_wall, name)
            view.child(self._fam_flops, name).set_fn(weak_reader(
                self, lambda led: led.flops_per_dispatch(name), -1.0))
            view.child(self._fam_achieved, name).set_fn(weak_reader(
                self, lambda led: led._achieved_flops_last(name), -1.0))
            view.child(self._fam_mfu, name).set_fn(weak_reader(
                self, lambda led: led._mfu_last(name), -1.0))
        return rec

    def wrap(self, name: str, fn, meter_first: bool = False) -> LedgeredProgram:
        """A dispatch-counting proxy for ``fn`` under ``name``. Wrapping a
        name again (a lazy rebuild, a second engine on a shared ledger)
        shares the record: counts ACCUMULATE. ``meter_first``: a new
        variant's first ordinary dispatch runs under the cost meter (for
        programs no request waits on, such as a train step)."""
        if isinstance(fn, LedgeredProgram):
            fn = fn.__wrapped__
        return LedgeredProgram(self, self._get_record(name), fn, meter_first)

    @contextlib.contextmanager
    def prewarming(self):
        """Every dispatch inside is a prewarm replay: compiles count, the
        dispatches go to ``prewarm_dispatches``. Re-entrant."""
        self._prewarm_depth += 1
        try:
            yield self
        finally:
            self._prewarm_depth -= 1

    def manifest(self):
        """The :class:`~neuronx_distributed_tpu_torch.inference.aot.
        ProgramManifest` of every recorded signature (the prewarm input)."""
        from neuronx_distributed_tpu_torch.inference.aot import ProgramManifest

        return ProgramManifest.from_ledger(self)

    def _note_compile(self, rec: _ProgramRecord, args, kwargs, wall_s: float,
                      meter: Optional[CostMeter], source: str) -> None:
        rec.compiles += 1
        rec.compile_wall_s += float(wall_s)
        if rec.c_compiles is not None:
            rec.c_compiles.inc()
        self._h_compile.observe(float(wall_s))
        sig = call_signature(args, kwargs)
        var = rec.variants.get(sig)
        if var is None:
            var = _Variant(sig)
            rec.variants[sig] = var
        var.pedigree = {"args": [_pedigree(a) for a in args],
                        "kwargs": {k: _pedigree(v) for k, v in kwargs.items()}}
        if not var.analyzed and meter is not None:
            var.fill_from(meter, source)
        if self._timeline is not None:
            self._timeline.instant(f"compile {rec.name}", self._subsystem,
                                   args={"wall_s": round(float(wall_s), 4),
                                         "compiles": rec.compiles})

    # --- the roofline feed ----------------------------------------------------

    def observe_wall(self, name: str, wall_s: float, dispatches: int = 1) -> None:
        """Feed one measured wall (a host float the caller owns: the serving
        chunk's dispatch and read) covering ``dispatches`` dispatches of
        ``name``; the histogram keeps the wall a dispatch. Nothing here
        touches the device."""
        rec = self._records.get(name)
        if rec is None or wall_s <= 0 or dispatches < 1:
            return
        per = float(wall_s) / dispatches
        rec.last_wall_s = per
        if rec.wall_hist is not None:
            rec.wall_hist.observe(per)

    # --- reads ----------------------------------------------------------------

    def record(self, name: str) -> Optional[_ProgramRecord]:
        return self._records.get(name)

    def dispatches(self, name: str) -> int:
        rec = self._records.get(name)
        return rec.dispatches if rec is not None else 0

    def programs(self) -> "OrderedDict[str, ProgramInfo]":
        """Every registered program, by name (host metadata only)."""
        return OrderedDict((name, ProgramInfo(name, rec)) for name, rec in self._records.items())

    def _sole(self, name: str) -> Optional[_Variant]:
        rec = self._records.get(name)
        var = rec.sole_variant() if rec is not None else None
        return var if var is not None and var.analyzed else None

    def flops_per_dispatch(self, name: str):
        """Metered FLOPs of one dispatch of ``name``: defined while it has
        ONE signature (the decode step), UNAVAILABLE otherwise."""
        var = self._sole(name)
        return var.flops if var is not None else UNAVAILABLE

    def bytes_per_dispatch(self, name: str):
        var = self._sole(name)
        return var.bytes_accessed if var is not None else UNAVAILABLE

    def _achieved_flops_last(self, name: str):
        rec = self._records.get(name)
        flops = self.flops_per_dispatch(name)
        if rec is None or not rec.last_wall_s or not isinstance(flops, float):
            return UNAVAILABLE
        return flops / rec.last_wall_s

    def _mfu_last(self, name: str):
        achieved = self._achieved_flops_last(name)
        peak = self.peaks["flops"]
        if not isinstance(achieved, float) or not isinstance(peak, float):
            return UNAVAILABLE
        return achieved / peak

    # --- export ---------------------------------------------------------------

    def _entry(self, rec: _ProgramRecord, include_timing: bool) -> dict:
        sole = rec.sole_variant()
        done = sole is not None and sole.analyzed
        flops = sole.flops if done else UNAVAILABLE
        nbytes = sole.bytes_accessed if done else UNAVAILABLE
        entry = {
            "dispatches": rec.dispatches,
            "compiles": rec.compiles,
            "variants": len(rec.variants),
            "cost_source": sole.cost_source if done else UNAVAILABLE,
            "kernels": dict(sole.kernels) if done else {},
            "flops_per_dispatch": flops,
            "bytes_per_dispatch": nbytes,
            "arithmetic_intensity": (flops / nbytes if isinstance(flops, float)
                                     and isinstance(nbytes, float) and nbytes > 0
                                     else UNAVAILABLE),
            "flops_total": flops * rec.dispatches if isinstance(flops, float) else UNAVAILABLE,
            "bytes_total": nbytes * rec.dispatches if isinstance(nbytes, float) else UNAVAILABLE,
        }
        if rec.prewarm_dispatches:
            entry["prewarm_dispatches"] = rec.prewarm_dispatches
        if len(rec.variants) > 1:
            entry["variant_cost"] = {
                v.sig: {"flops": v.flops if v.analyzed else UNAVAILABLE,
                        "bytes_accessed": v.bytes_accessed if v.analyzed else UNAVAILABLE}
                for v in rec.variants.values()}
        if include_timing:
            entry["compile_wall_s"] = round(rec.compile_wall_s, 6)
            h = rec.wall_hist
            if h is not None and h.count:
                p50 = h.percentile(0.50)
                entry["wall"] = {"count": h.count, "sum_s": float(h.sum), "p50_s": p50,
                                 "p95_s": h.percentile(0.95)}
                peak, bw = self.peaks["flops"], self.peaks["hbm_bytes_per_s"]
                if isinstance(flops, float) and p50 > 0:
                    entry["achieved_flops_p50"] = flops / p50
                    entry["mfu_p50"] = (flops / p50 / peak if isinstance(peak, float)
                                        else UNAVAILABLE)
                else:
                    entry["achieved_flops_p50"] = entry["mfu_p50"] = UNAVAILABLE
                entry["hbm_bw_util_p50"] = (nbytes / p50 / bw if isinstance(nbytes, float)
                                            and p50 > 0 and isinstance(bw, float)
                                            else UNAVAILABLE)
        return entry

    def snapshot(self, include_timing: bool = True) -> dict:
        """``{"device", "by_program", "totals"}``. ``include_timing=False``
        drops every wall-derived field: what is left is the same across
        identical runs."""
        programs = {name: self._entry(rec, include_timing)
                    for name, rec in sorted(self._records.items())}
        totals: Dict[str, Any] = {
            "programs": len(programs),
            "dispatches": sum(r.dispatches for r in self._records.values()),
            "compiles": sum(r.compiles for r in self._records.values()),
        }
        known = [e["flops_total"] for e in programs.values() if isinstance(e["flops_total"], float)]
        totals["flops_total_known"] = sum(known) if known else UNAVAILABLE
        if include_timing:
            totals["compile_wall_s"] = round(sum(r.compile_wall_s
                                                 for r in self._records.values()), 6)
        device = {"kind": self.peaks["kind"], "platform": self.peaks["platform"],
                  "peak_flops": self.peaks["flops"],
                  "peak_hbm_bytes_per_s": self.peaks["hbm_bytes_per_s"],
                  "peak_source": self.peaks["source"]}
        return {"device": device, "by_program": programs, "totals": totals}

    def halt_summary(self, top: int = 6) -> dict:
        """The top ``top`` programs by dispatches, scalars only (flat enough
        for the flight recorder's redaction)."""
        ranked = sorted(self._records.values(), key=lambda r: (-r.dispatches, r.name))[:top]
        return {rec.name: {"dispatches": rec.dispatches, "compiles": rec.compiles,
                           "variants": len(rec.variants),
                           "compile_wall_s": round(rec.compile_wall_s, 4),
                           "flops_per_dispatch": self.flops_per_dispatch(rec.name)}
                for rec in ranked}

    def table(self) -> str:
        """A human-readable table of the ledger."""
        snap = self.snapshot()
        rows = [("program", "disp", "compiles", "flops/disp", "bytes/disp", "AI", "compile_s",
                 "wall_p50_s", "mfu_p50")]

        def fmt(v, nd=3):
            return f"{v:.{nd}g}" if isinstance(v, float) else str(v)

        by = snap["by_program"]
        for name in sorted(by, key=lambda n: (-by[n]["dispatches"], n)):
            e = by[name]
            wall = e.get("wall", {})
            rows.append((name, str(e["dispatches"]), str(e["compiles"]),
                         fmt(e["flops_per_dispatch"], 4), fmt(e["bytes_per_dispatch"], 4),
                         fmt(e["arithmetic_intensity"]), fmt(e.get("compile_wall_s", 0.0)),
                         fmt(wall.get("p50_s", UNAVAILABLE)), fmt(e.get("mfu_p50", UNAVAILABLE))))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip() for row in rows]
        dev = snap["device"]
        lines.append(f"device: {dev['platform']}/{dev['kind']}  "
                     f"peak_flops={fmt(dev['peak_flops'], 4)}  "
                     f"peak_hbm_B/s={fmt(dev['peak_hbm_bytes_per_s'], 4)}")
        return "\n".join(lines)
