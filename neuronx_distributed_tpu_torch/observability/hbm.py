"""The HBM ledger: static residents reconciled against the device's memory
(counterpart of ``neuronx_distributed_tpu/observability/hbm.py``; its
``UNAVAILABLE`` and ``weak_reader`` come from ``observability/programs.py``,
as JAX's do).

The serving engine knows which big allocations it owns (the weights, the
page pool or the row cache, the slot state, the draft's, the prefix store's
copies) and, with a host page tier, the pinned host bytes of the pages it
spilled. :class:`HBMLedger` adds them up per tier, compares the device tier
with what the allocator says is in use, and answers capacity questions
(``plan``: how many more pages fit a budget, per tier).

Residents are callables over live objects returning bytes from tensor
metadata (``numel() * element_size()``), so reading the ledger never touches
device data. On the card the device fields come from the CUDA caching
allocator: ``bytes_limit`` is the card's total memory
(``torch.cuda.mem_get_info``), ``bytes_in_use`` and ``peak_bytes_in_use``
are ``torch.cuda.memory_allocated`` and ``max_memory_allocated``. On the CPU
every device-derived field is the string ``"unavailable"``, as the JAX
ledger reports on a backend without memory stats; resident accounting and a
``plan`` with an explicit budget work on both."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import torch

from neuronx_distributed_tpu_torch.observability.programs import UNAVAILABLE, weak_reader
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry, MetricsView

__all__ = ["HBMLedger", "tree_nbytes", "UNAVAILABLE", "weak_reader"]

def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples (metadata
    only: no device read)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    n = getattr(tree, "nbytes", None)
    return int(n) if isinstance(n, int) else 0


def _as_fn(source) -> Callable[[], int]:
    if callable(source):
        return source
    if isinstance(source, int):
        return lambda: source
    return lambda: tree_nbytes(source)


class _Resident:
    __slots__ = ("name", "bytes_fn", "unit_bytes_fn", "count_fn", "unit", "tier")

    def __init__(self, name, bytes_fn, unit_bytes_fn, count_fn, unit, tier="device"):
        self.name = name
        self.bytes_fn = bytes_fn
        self.unit_bytes_fn = unit_bytes_fn
        self.count_fn = count_fn
        self.unit = unit
        self.tier = tier


def _default_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


class HBMLedger:
    """Named resident accounting for one device (JAX ``HBMLedger``).

    ``add_resident(name, source)`` registers a byte source: a callable
    returning bytes (closures over weak references, so a kept ledger never
    pins an engine), a tree of tensors, or an int. ``unit_bytes=`` and
    ``count=`` (values or callables) declare the resident's granularity,
    what :meth:`plan` sizes budgets in; ``tier="host"`` places it in the host
    spill tier, sized against ``plan(host_budget_bytes=)`` and never against
    the device's headroom. The registered gauges
    (``hbm_resident_bytes{resident=}``, the total, the limit, the
    utilization) resolve at export; -1 means unavailable there."""

    def __init__(self, device="auto", registry=None, view=None, prefix: str = "hbm"):
        self.device = _default_device() if device == "auto" else (
            torch.device(device) if device is not None else None)
        if view is None:
            view = MetricsView(registry if registry is not None else MetricsRegistry())
        self._view = view
        self._residents: "OrderedDict[str, _Resident]" = OrderedDict()
        self._fam_resident = view.family("gauge", f"{prefix}_resident_bytes",
                                         labels=("resident",),
                                         help="bytes of each accounted static resident")
        view.gauge(f"{prefix}_resident_bytes_total",
                   help="sum of accounted residents (bytes)").set_fn(
            weak_reader(self, lambda led: led.resident_bytes_total(), -1))
        view.gauge(f"{prefix}_bytes_limit",
                   help="the device's total memory (-1 = unavailable)").set_fn(
            weak_reader(self, lambda led: (led.memory_stats() or {}).get("bytes_limit"), -1))
        view.gauge(f"{prefix}_utilization",
                   help="accounted resident bytes / bytes_limit (-1 = unavailable)").set_fn(
            weak_reader(self, lambda led: led._utilization(), -1))

    # --- residents ----------------------------------------------------------

    def add_resident(self, name: str, source, unit_bytes=None, count=None,
                     unit: Optional[str] = None, tier: str = "device") -> None:
        """Register (or replace) the byte source of resident ``name``."""
        if tier not in ("device", "host"):
            raise ValueError(f"unknown resident tier {tier!r}")
        res = _Resident(name, _as_fn(source),
                        None if unit_bytes is None else _as_fn(unit_bytes),
                        None if count is None else _as_fn(count), unit, tier)
        fresh = name not in self._residents
        self._residents[name] = res
        if fresh:
            self._view.child(self._fam_resident, name).set_fn(
                weak_reader(self, lambda led, name=name: led.resident_bytes(name), -1))

    def remove_resident(self, name: str) -> None:
        self._residents.pop(name, None)

    def resident_bytes(self, name: str) -> int:
        res = self._residents.get(name)
        if res is None:
            return 0
        try:
            return int(res.bytes_fn())
        except Exception:
            return 0

    def resident_bytes_total(self, tier: str = "device") -> int:
        """Resident bytes of one tier (the device's by default: host spill
        bytes never count against the device's limit)."""
        return sum(self.resident_bytes(n) for n, res in self._residents.items()
                   if res.tier == tier)

    # --- device reconciliation ----------------------------------------------

    def memory_stats(self) -> Optional[dict]:
        """The device's allocator stats under the JAX ledger's keys, or None
        on a device without them (the CPU)."""
        if self.device is None or self.device.type != "cuda":
            return None
        _, total = torch.cuda.mem_get_info(self.device)
        return {"bytes_limit": int(total),
                "bytes_in_use": int(torch.cuda.memory_allocated(self.device)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(self.device))}

    def _utilization(self):
        limit = (self.memory_stats() or {}).get("bytes_limit")
        return self.resident_bytes_total() / float(limit) if limit else None

    def _kind(self) -> dict:
        if self.device is None:
            return {"kind": "", "platform": ""}
        if self.device.type == "cuda":
            return {"kind": torch.cuda.get_device_name(self.device), "platform": "gpu"}
        return {"kind": self.device.type, "platform": self.device.type}

    def snapshot(self) -> dict:
        """Residents and the device reconciliation. Device entries keep the
        single-tier schema; only host-tier entries carry a ``tier`` key."""
        residents = {}
        host_total = 0
        for name, res in self._residents.items():
            entry: Dict[str, Any] = {"bytes": self.resident_bytes(name)}
            if res.unit_bytes_fn is not None:
                try:
                    entry["unit_bytes"] = int(res.unit_bytes_fn())
                except Exception:
                    entry["unit_bytes"] = 0
                if res.unit:
                    entry["unit"] = res.unit
            if res.count_fn is not None:
                try:
                    entry["count"] = int(res.count_fn())
                except Exception:
                    entry["count"] = 0
            if res.tier != "device":
                entry["tier"] = res.tier
                host_total += entry["bytes"]
            residents[name] = entry
        total = sum(e["bytes"] for e in residents.values() if "tier" not in e)
        stats = self.memory_stats() or {}
        limit, in_use = stats.get("bytes_limit"), stats.get("bytes_in_use")
        return {
            "device": self._kind(),
            "residents": residents,
            "resident_bytes_total": total,
            "host_resident_bytes_total": host_total,
            "bytes_limit": int(limit) if limit else UNAVAILABLE,
            "bytes_in_use": int(in_use) if in_use is not None else UNAVAILABLE,
            "peak_bytes_in_use": (int(stats["peak_bytes_in_use"])
                                  if "peak_bytes_in_use" in stats else UNAVAILABLE),
            "utilization": total / float(limit) if limit else UNAVAILABLE,
            "unaccounted_bytes": int(in_use) - total if in_use is not None else UNAVAILABLE,
        }

    def plan(self, budget_bytes: Optional[int] = None,
             host_budget_bytes: Optional[int] = None) -> dict:
        """How many MORE units of each unit-declaring resident fit: device
        residents against ``budget_bytes`` (default the device's limit),
        host residents against ``host_budget_bytes`` only. No budget for
        either tier: UNAVAILABLE throughout."""
        total = self.resident_bytes_total()
        host_total = self.resident_bytes_total("host")
        if budget_bytes is None:
            budget_bytes = (self.memory_stats() or {}).get("bytes_limit") or None
        if not budget_bytes and not host_budget_bytes:
            return {"budget_bytes": UNAVAILABLE, "free_bytes": UNAVAILABLE,
                    "host_budget_bytes": UNAVAILABLE, "host_free_bytes": UNAVAILABLE,
                    "fits": {}}
        free = max(0, int(budget_bytes) - total) if budget_bytes else None
        host_free = max(0, int(host_budget_bytes) - host_total) if host_budget_bytes else None
        fits = {}
        for name, res in self._residents.items():
            if res.unit_bytes_fn is None:
                continue
            try:
                unit = int(res.unit_bytes_fn())
            except Exception:
                unit = 0
            entry: Dict[str, Any] = {"unit_bytes": unit, "unit": res.unit or name}
            if res.tier != "device":
                entry["tier"] = res.tier
            tier_free = host_free if res.tier == "host" else free
            if unit > 0 and tier_free is not None:
                entry["additional"] = tier_free // unit
                if res.count_fn is not None:
                    try:
                        entry["max_total"] = int(res.count_fn()) + tier_free // unit
                    except Exception:
                        pass
            else:
                entry["additional"] = UNAVAILABLE
            fits[name] = entry
        return {
            "budget_bytes": int(budget_bytes) if budget_bytes else UNAVAILABLE,
            "free_bytes": free if free is not None else UNAVAILABLE,
            "host_budget_bytes": int(host_budget_bytes) if host_budget_bytes else UNAVAILABLE,
            "host_free_bytes": host_free if host_free is not None else UNAVAILABLE,
            "fits": fits,
        }

    def halt_summary(self) -> dict:
        """Flat scalars for a halt post-mortem (the flight recorder's
        depth-capped redaction keeps them)."""
        snap = self.snapshot()
        out = {f"resident_{name}_bytes": entry["bytes"]
               for name, entry in snap["residents"].items()}
        for key in ("resident_bytes_total", "host_resident_bytes_total", "bytes_limit",
                    "bytes_in_use", "utilization"):
            out[key] = snap[key]
        return out
