"""The serving decode step as one captured device program (counterpart of
the JAX engine's jitted decode chunk, ``serving/engine.py:864-877``, and of
the in-process prewarm of ``inference/aot.py``, ``prewarm_programs``).

JAX compiles the chunk once per engine and dispatches the compiled program
for every chunk after. The PyTorch counterpart is a ``torch.cuda.CUDAGraph``:
:class:`DecodeProgram` captures one decode step, whose inputs and outputs
are buffers that live as long as the engine, and replays it for every step
after. A replay launches the step's hundreds of kernels with one host call.
A speculative engine's program is its draft-verify ROUND
(``inference/spec_decode.py``, the JAX ``spec_decode_chunk``): one capture
holds the draft's ``gamma`` decode steps and the target's verify forward,
over both caches.

On the card the first call warms the step up on a side stream (one masked
no-op step that leaves no trace, so that cuBLAS handles, the kernels'
libraries and the allocator are settled before capture), captures it and
replays it; every later call replays. A failed capture or replay raises:
there is no eager fallback on the card. On the CPU every call runs the step
eagerly and nothing is captured.

A replay launches kernels without calling their Python wrappers, so the
wrappers' ``launches`` counters see no replay. The program records how
many launches of each wrapper the capture recorded
(``launches_per_replay``) and leaves the counters as they were before the
capture, which recorded launches and made none; ``replays`` times
``launches_per_replay`` is then the launch count of the replays (a
speculative round's K4 or K5 count is the draft's ``draft_layers x gamma``
plus the target's ``num_layers``: both models call the same wrapper). The JAX
persistent compile cache and serialized executables (``aot.py:94-530``)
have no counterpart for a CUDA graph: a graph is captured in the process
that replays it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch


def kernel_wrappers() -> Dict[str, Callable]:
    """The kernel wrappers that count their launches, by name (a wrapper's
    head_dim-96 build counts in an entry of its own)."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_dkdv,
        flash_attention_dq,
        flash_attention_fwd,
    )
    from neuronx_distributed_tpu_torch.kernels.dequantize import dequantize_fwd
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        paged_flash_decode_fwd,
        qpaged_flash_decode_fwd,
        qpaged_write_attend_fwd,
    )
    from neuronx_distributed_tpu_torch.kernels.kv_quant import window_requantize_fwd
    from neuronx_distributed_tpu_torch.kernels.moe_experts import (
        moe_experts,
        moe_experts_quantized,
    )
    from neuronx_distributed_tpu_torch.kernels.page_fingerprint import pool_pages_fingerprint_fwd
    from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import tree_fingerprint_fwd

    return {"flash_attention": flash_attention_fwd, "flash_attention_dkdv": flash_attention_dkdv,
            "flash_attention_dq": flash_attention_dq, "flash_decode": flash_decode_fwd,
            "paged_flash_decode": paged_flash_decode_fwd,
            "qpaged_flash_decode": qpaged_flash_decode_fwd,
            "qpaged_write_attend": qpaged_write_attend_fwd, "dequantize": dequantize_fwd,
            "window_requantize": window_requantize_fwd,
            "page_fingerprint": pool_pages_fingerprint_fwd,
            "tree_fingerprint": tree_fingerprint_fwd, "moe_experts": moe_experts,
            "moe_experts_quantized": moe_experts_quantized,
            # the head_dim-96 builds of K1, K4 and K5: kernels of their own
            "flash_attention_d96": flash_attention_fwd.d96, "flash_decode_d96": flash_decode_fwd.d96,
            "paged_flash_decode_d96": paged_flash_decode_fwd.d96}


class DecodeProgram:
    """One decode step, captured once on the card and replayed.

    ``step`` runs one step on fixed buffers (every result lands in place);
    ``warmup`` runs it once as a masked no-op that leaves every buffer as
    it found it. ``captures`` counts graph captures (at most 1),
    ``replays`` graph replays, ``capture_s`` is the wall of the capture
    (warm-up included) and ``launches_per_replay`` the kernel-wrapper
    launches one replay makes."""

    def __init__(self, step: Callable[[], None], warmup: Callable[[], None],
                 device: torch.device):
        self.step = step
        self._warmup = warmup
        self.device = torch.device(device)
        self.graph = None
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self.launches_per_replay: Dict[str, int] = {}
        # a program ledger's cost meter for the capture's eager warm-up
        # (observability/programs.py); None meters nothing
        self.cost_meter = None

    def __call__(self) -> None:
        """Run one decode step: a replay on the card (captured at the first
        call), the eager step on the CPU."""
        if self.device.type != "cuda":
            self.step()
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1

    def capture(self) -> float:
        """Warm the step up on a side stream and capture it (once; later
        calls do nothing). Returns the wall seconds it took, 0 when nothing
        was captured."""
        if self.graph is not None or self.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), self.cost_meter or contextlib.nullcontext():
            self._warmup()
        torch.cuda.current_stream(self.device).wait_stream(side)
        wrappers = kernel_wrappers()
        before = {name: w.launches for name, w in wrappers.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.step()
        for name, w in wrappers.items():
            if w.launches != before[name]:
                self.launches_per_replay[name] = w.launches - before[name]
            w.launches = before[name]  # the capture recorded these launches, it made none
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
        from neuronx_distributed_tpu_torch.kernels import _build

        _build.notify("capture", self.capture_s)
        return self.capture_s
