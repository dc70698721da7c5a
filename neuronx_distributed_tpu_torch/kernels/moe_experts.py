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
each expert that some pair routes to once a pass of up to ``np`` of its
pairs, and no other (design and rounding in the source); :func:`plan`
picks ``np`` and ``down``'s column split from the shapes alone.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional

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


# pairs a pass over an expert's rows (the product's N); the kernel's row
# tile; what the split sizes down's grid for: an H100 SXM's SMs and the
# kernel's blocks an SM
PASS_WIDTHS = (8, 16)
ROWS = 64
SMS, BLOCKS_AN_SM = 132, 2
MAX_SPLIT = 8


class Plan(NamedTuple):
    """What one call passes the kernel: ``np`` pairs a pass and ``down``'s
    input columns cut into ``split`` shares (the grids follow in the
    kernel from these and the shapes)."""
    np: int
    split: int


def plan(t: int, k: int, e: int, h: int, i: int) -> Plan:
    """The kernel's plan for ``t`` tokens, top-``k`` of ``e`` experts, hidden
    ``h``, intermediate ``i``: shapes alone, so a CUDA graph bakes in
    nothing that depends on the routes. ``np`` is 8 for at most 8 pairs,
    else 16: a top-2 decode step's 16 pairs take one pass even when all
    route to one expert, and an expert with more pairs takes further
    passes. ``split`` is the least power of two (at most 8, and each share
    at least 1024 columns of ``i``) that gives ``down`` (``h / 64`` row
    tiles an expert) four waves of blocks on the card when ``min(e, t k)``
    experts are touched; gate and up are not split."""
    pairs = t * k
    np_ = PASS_WIDTHS[0] if pairs <= PASS_WIDTHS[0] else PASS_WIDTHS[1]
    tiles = -(-h // ROWS)
    touched = min(e, pairs)
    split = 1
    while (split < MAX_SPLIT and 2 * split <= max(1, i // 1024)
           and touched * tiles * split < 4 * SMS * BLOCKS_AN_SM):
        split *= 2
    return Plan(np_, split)


@functools.lru_cache(maxsize=None)
def _lib() -> SimpleNamespace:
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("moe_experts")
    fn = lib.nxd_moe_experts_fwd
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.restype = i
    fn.argtypes = [vp] * 15 + [ll, i, i, i, i, i, i, i, vp]
    return SimpleNamespace(fn=fn, max_pairs=lib.nxd_moe_experts_max_pairs())


def _row_scales(scale: torch.Tensor, e: int, rows: int) -> torch.Tensor:
    if tuple(scale.shape) == (e, rows):
        return scale
    if tuple(scale.shape) == (e,):
        return scale[:, None].expand(e, rows).contiguous()
    raise ValueError(f"expert scales must be (E, out) or (E,), got {tuple(scale.shape)}")


def _kernel_call(x, top_e, top_w, gate, up, down, gate_scale, up_scale, down_scale):
    """Launch the kernels (three; four for codes) with :func:`plan`'s pass
    width and split; returns ``(out, act, y)`` (the SwiGLU activations (T*k, I) and
    each pair's down output (T*k, H), two of the scratches, for the card's
    stage checks)."""
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
    pl = plan(t, k, e, h, i)
    act = torch.empty((t * k, i), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((t * k, h), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((pl.split, t * k, h), dtype=torch.float32, device=x.device)
    out = torch.empty((t, h), dtype=torch.bfloat16, device=x.device)
    if fmt:  # the pairs' inputs in the code product's column order, rows padded to 128
        xp = torch.empty((t, -(-h // 128) * 128), dtype=torch.bfloat16, device=x.device)
        actp = (torch.empty if i % 128 == 0 else torch.zeros)(
            (t * k, -(-i // 128) * 128), dtype=torch.bfloat16, device=x.device)
        qptr = [xp.data_ptr(), actp.data_ptr()]
    else:
        qptr = [None, None]
    err = lib.fn(x.data_ptr(), pair_expert.data_ptr(), w_flat.data_ptr(), gate.data_ptr(),
                 up.data_ptr(), down.data_ptr(), *sptr, act.data_ptr(), y.data_ptr(),
                 part.data_ptr(), out.data_ptr(), *qptr, t, k, e, h, i, fmt, pl.np, pl.split,
                 _build.stream_ptr(x.device))
    _build.check(err, "moe_experts_fwd")
    return out, act, y


def all_codes(kind: str) -> torch.Tensor:
    """Every int8 code (-128..127), or every finite e4m3 code (254: NaN's
    two left out), as uint8."""
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    return b if kind == "int8" else b[(b & 0x7F) != 0x7F]


def dequant_probe(kind: str, h: int, i: int) -> dict:
    """Inputs on the card that hold MXq's dequantize code by code (the
    card's checks): 8 tokens, x one-hot (token t at column t), each
    token's two slots on experts 0 and 1 (weights 1/2), so every sum is a
    single term. ``gate``
    dequantizes to 128 everywhere (silu(128) = 128); ``up`` carries code
    (r + c) of :func:`all_codes` at row r, column c under per-row scales
    spread over [2^-30, 2^19], so act = 128 bf16(f32(q) scale); ``up1`` is
    1/128 at row 37 t + 5, column t, else 0, so act is one-hot and each
    pair's down output is ``down``'s dequantized column, code (3 r + c)
    under the same spread. Stacks are (codes, scales) of two identical
    experts; ``h``, ``i`` >= 300."""
    t, device = 8, "cuda"
    dt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    codes = all_codes(kind).to(device)

    def stack(rows, cols, fill):
        r = torch.arange(rows, device=device)
        q = codes[fill(r[:, None], torch.arange(cols, device=device)[None, :]) % codes.numel()]
        s = torch.ldexp(1.0 + (r % 5).float() / 8, (r * 7) % 50 - 30)
        return q.view(dt).expand(2, rows, cols).contiguous(), s.expand(2, rows).contiguous()

    g128 = (64, 2.0) if kind == "int8" else (0x70, 1.0)  # the codes of 64 and of 128.0
    up1 = torch.zeros(i, h, dtype=torch.uint8, device=device)
    up1[torch.arange(t) * 37 + 5, torch.arange(t)] = 1 if kind == "int8" else 0x38  # 1.0
    x = torch.zeros(t, h, dtype=torch.bfloat16, device=device)
    x[torch.arange(t), torch.arange(t)] = 1.0
    full = lambda rows, cols, code: torch.full((2, rows, cols), code, dtype=torch.uint8,
                                                device=device).view(dt)
    return dict(
        x=x, top_e=torch.tensor([[0, 1]] * t, device=device),
        top_w=torch.full((t, 2), 0.5, device=device),
        gate=(full(i, h, g128[0]), torch.full((2, i), g128[1], device=device)),
        up=stack(i, h, lambda r, c: r + c), down=stack(h, i, lambda r, c: 3 * r + c),
        up1=(up1.view(dt).expand(2, i, h).contiguous(),
             torch.full((2, i), 2.0 ** -7, device=device)))


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
