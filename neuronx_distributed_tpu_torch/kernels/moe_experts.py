"""The routed expert product of a MoE decode step: MX (bf16 experts) and MXq
(int8 or fp8 e4m3 experts with f32 scales). No Pallas counterpart: XLA fuses
JAX's selective-loading strategy (``modules/moe/expert_mlps.py:327``
``_selective``), and the dequantize ``_declare_kernel`` puts in the
weights' load (``parallel/layers.py:48``), into one program.

For each token ``t`` and slot ``j`` of its top-k,
``y_t = sum_j w_tj * down[e_tj] . (silu(gate[e_tj] . x_t) * (up[e_tj] . x_t))``.
Weights are torch's ``(E, out, in)``: ``gate``/``up`` ``(E, I, H)``,
``down`` ``(E, H, I)``; quantized stacks hold codes with f32 scales
``(E, out)`` per channel or ``(E,)`` per tensor.

:func:`moe_experts_plain` is JAX's gathered einsum formulation in torch
(it gathers each token's k expert slices, dequantized as
``(f32(q) * scale).to(dtype)``, DQ's arithmetic): CPU tensors run it. :func:`moe_experts`
(bf16 weights, MX) and :func:`moe_experts_quantized` (MXq) launch
``csrc/moe_experts.cu`` for CUDA tensors, SwiGLU only and bf16 activations
only, or raise; each counts its calls in ``launches``. The kernel reads
each expert that some pair routes to once, and no other (design and
rounding in the source).
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_tpu_torch.observability.programs import metered

# JAX's activations: jax.nn.gelu is the tanh approximation by default
ACTIVATIONS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu}
_FORMATS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def gathered(w: torch.Tensor, scale: Optional[torch.Tensor], top_e: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's k expert slices of the stack ``w`` (E, out, in),
    dequantized with ``scale`` ((E, out) or (E,)) when given: (T, k, out,
    in) in ``dtype``."""
    g = w[top_e]
    if scale is None:
        return g.to(dtype)
    s = scale[top_e]  # (T, k, out) per channel, (T, k) per tensor
    s = s[..., None] if s.dim() == 3 else s[..., None, None]
    return (g.to(torch.float32) * s.to(torch.float32)).to(dtype)  # DQ's arithmetic


def moe_experts_plain(x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
                      gate: Optional[torch.Tensor], up: torch.Tensor, down: torch.Tensor,
                      gate_scale=None, up_scale=None, down_scale=None,
                      act: str = "silu", glu: bool = True) -> torch.Tensor:
    """JAX ``_selective`` in torch: ``x`` (T, H), ``top_e`` (T, k) expert
    ids, ``top_w`` (T, k) affinities -> (T, H) in ``x``'s dtype."""
    dt = x.dtype
    h = torch.einsum("th,tkih->tki", x, gathered(up, up_scale, top_e, dt))
    if glu:
        g = torch.einsum("th,tkih->tki", x, gathered(gate, gate_scale, top_e, dt))
        h = ACTIVATIONS[act](g) * h
    else:
        h = ACTIVATIONS[act](h)
    y = torch.einsum("tki,tkhi->tkh", h, gathered(down, down_scale, top_e, dt))
    return torch.einsum("tkh,tk->th", y, top_w.to(y.dtype))


@functools.lru_cache(maxsize=None)
def _lib() -> SimpleNamespace:
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("moe_experts")
    fn = lib.nxd_moe_experts_fwd
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.restype = i
    fn.argtypes = [vp] * 12 + [ll, i, i, i, i, i, vp]
    return SimpleNamespace(fn=fn, max_pairs=lib.nxd_moe_experts_max_pairs())


def _row_scales(scale: torch.Tensor, e: int, rows: int) -> torch.Tensor:
    if tuple(scale.shape) == (e, rows):
        return scale
    if tuple(scale.shape) == (e,):
        return scale[:, None].expand(e, rows).contiguous()
    raise ValueError(f"expert scales must be (E, out) or (E,), got {tuple(scale.shape)}")


def _kernel_call(x, top_e, top_w, gate, up, down, gate_scale, up_scale, down_scale):
    """Launch the three kernels; returns ``(out, act, y)`` (the SwiGLU
    activations (T*k, I) and each pair's down output (T*k, H), the two
    scratches, for the card's stage checks)."""
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _lib()
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"the expert kernel takes bf16 (T, H) activations, got {x.dtype} "
                        f"{tuple(x.shape)}")
    fmt = _FORMATS.get(up.dtype)
    if fmt is None or not (gate.dtype == up.dtype == down.dtype):
        raise TypeError(f"expert weights must all be bf16, int8 or fp8 e4m3, got "
                        f"{gate.dtype}, {up.dtype}, {down.dtype}")
    t, h = x.shape
    e, i = up.shape[0], up.shape[1]
    k = top_e.shape[1]
    if (tuple(gate.shape) != (e, i, h) or tuple(up.shape) != (e, i, h)
            or tuple(down.shape) != (e, h, i)):
        raise ValueError(f"expert stacks must be gate/up (E, I, H) and down (E, H, I) for x "
                         f"(T, {h}); got {tuple(gate.shape)}, {tuple(up.shape)}, "
                         f"{tuple(down.shape)}")
    if h % 16 or i % 16 or t * k > lib.max_pairs:
        raise ValueError(f"the expert kernel takes H and I multiples of 16 and at most "
                         f"{lib.max_pairs} (token, slot) pairs; got H={h} I={i} T*k={t * k}")
    ws = (gate, up, down)
    if any(w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16 for w in ws):
        raise ValueError("expert stacks must be contiguous, 16-byte aligned, on x's device")
    if fmt:
        if gate_scale is None or up_scale is None or down_scale is None:
            raise ValueError("quantized experts need gate_scale, up_scale and down_scale")
        scales = [_row_scales(s, e, r) for s, r in
                  ((gate_scale, i), (up_scale, i), (down_scale, h))]
        if any(s.dtype != torch.float32 or s.device != x.device or not s.is_contiguous()
               for s in scales):
            raise ValueError("expert scales must be contiguous f32 on x's device")
        sptr = [s.data_ptr() for s in scales]
    else:
        scales, sptr = (), [None, None, None]
    x = x.contiguous()
    pair_expert = top_e.reshape(-1).to(torch.int32)
    w_flat = top_w.reshape(-1).to(torch.float32).contiguous()
    act = torch.empty((t * k, i), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((t * k, h), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((t, h), dtype=torch.bfloat16, device=x.device)
    err = lib.fn(x.data_ptr(), pair_expert.data_ptr(), w_flat.data_ptr(), gate.data_ptr(),
                 up.data_ptr(), down.data_ptr(), *sptr, act.data_ptr(), y.data_ptr(),
                 out.data_ptr(), t, k, e, h, i, fmt, _build.stream_ptr(x.device))
    _build.check(err, "moe_experts_fwd")
    return out, act, y


def expert_bytes(gate, up, down, scales, experts: int) -> int:
    """Bytes of ``experts`` experts' weights and their scales (``scales``
    may hold None)."""
    total = sum(w.numel() * w.element_size() for w in (gate, up, down))
    total += sum(s.numel() * s.element_size() for s in scales if s is not None)
    return total * experts // up.shape[0]


def _cost(x, top_e, top_w, gate, up, down, scales):
    """MX/MXq's count for the program ledger, on shapes alone: 2 x (3 x H x
    I + H) operations a (token, slot) pair (the three products and the
    weighted combine); bytes of min(E, T*k) experts'
    weights and scales (the most the pairs can touch), the activations,
    routes and output."""
    t, h = x.shape
    k = top_e.shape[1]
    i = up.shape[1]
    touched = min(up.shape[0], t * k)
    nbytes = expert_bytes(gate, up, down, scales, touched)
    nbytes += 2 * x.numel() * x.element_size() + top_e.numel() * 4 + top_w.numel() * 4
    return 2.0 * t * k * (3 * h * i + h), nbytes


def _mx_cost(x, top_e, top_w, gate, up, down, *_, **__):
    return _cost(x, top_e, top_w, gate, up, down, ())


def _mxq_cost(x, top_e, top_w, gate, up, down, gate_scale, up_scale, down_scale, *_, **__):
    return _cost(x, top_e, top_w, gate, up, down, (gate_scale, up_scale, down_scale))


def _call(fn, x, top_e, top_w, gate, up, down, gate_scale, up_scale, down_scale,
          act, glu):
    if x.device.type == "cpu":
        return moe_experts_plain(x, top_e, top_w, gate, up, down, gate_scale, up_scale,
                                 down_scale, act=act, glu=glu)
    if act != "silu" or not glu:
        raise ValueError(f"the expert kernel computes SwiGLU experts only, got act={act!r} "
                         f"glu={glu}")
    out = _kernel_call(x, top_e, top_w, gate, up, down, gate_scale, up_scale, down_scale)[0]
    fn.launches += 1
    return out


@metered("moe_experts", _mx_cost)
def moe_experts(x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
                gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                act: str = "silu", glu: bool = True) -> torch.Tensor:
    """MX: the routed product with bf16 expert stacks (module docstring).
    CUDA tensors launch the kernel (bf16 only) or raise; CPU tensors run
    :func:`moe_experts_plain`."""
    if up.dtype not in (torch.bfloat16, torch.float32, torch.float16):
        raise TypeError(f"moe_experts takes float experts, got {up.dtype}: quantized experts "
                        "go through moe_experts_quantized")
    return _call(moe_experts, x, top_e, top_w, gate, up, down, None, None, None,
                 act, glu)


@metered("moe_experts_quantized", _mxq_cost)
def moe_experts_quantized(x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
                          gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                          gate_scale: torch.Tensor, up_scale: torch.Tensor,
                          down_scale: torch.Tensor, act: str = "silu",
                          glu: bool = True) -> torch.Tensor:
    """MXq: the routed product with int8 or fp8 e4m3 expert codes and f32
    scales, dequantized in the load as ``bf16(f32(q) * scale)``. CUDA
    tensors launch the kernel or raise; CPU tensors run
    :func:`moe_experts_plain`."""
    if up.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"moe_experts_quantized takes int8 or fp8 e4m3 codes, got {up.dtype}")
    return _call(moe_experts_quantized, x, top_e, top_w, gate, up,
                 down, gate_scale, up_scale, down_scale, act, glu)


moe_experts.launches = 0
moe_experts_quantized.launches = 0
