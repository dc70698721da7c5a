"""The train step on one device (counterpart of
``neuronx_distributed_tpu/trainer/trainer.py``).

JAX jits one SPMD step — fwd → bwd → clip → AdamW — over donated state.
PyTorch runs eagerly, so the step is a Python function over tensors that
stay on the model's device: autograd through the model (activation
checkpointing per layer when ``config.remat``; attention's backward in the
K2/K3 kernels), the global-norm clip, and optax's AdamW chain written out per
leaf. Where JAX donates the state and returns a new one, the port updates
the parameters, the optimizer state and the guard carry IN PLACE and
returns the same :class:`TrainState`. Nothing in the step reads the device
from the host: metrics come back as device tensors.

One device has nothing to shard, so the ZeRO-1 and mesh arguments of the
JAX API are gone (``create_train_state`` returns the state alone, and
``build_train_step`` takes no shardings). The training loop over this step
(checkpoints, resume, faults, the SDC sentinel) is ``trainer/loop.py``.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from neuronx_distributed_tpu_torch.models.dbrx import DbrxForCausalLM
from neuronx_distributed_tpu_torch.models.llama import init_params
from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
from neuronx_distributed_tpu_torch.models.mixtral import init_params as init_mixtral_params
from neuronx_distributed_tpu_torch.parallel.grads import clip_grad_norm
from neuronx_distributed_tpu_torch.parallel.losses import parallel_cross_entropy
from neuronx_distributed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW and step settings (JAX ``OptimizerConfig``, ``trainer.py:39``)
    without ``zero1`` (one device has nothing to shard; ZeRO-1 comes with the
    multi-GPU slice). ``grad_accum_steps`` > 1 splits each batch into that
    many microbatches whose gradients the step accumulates; the training
    loop reads it, as JAX's does (``build_train_step(grad_accum_steps=)``
    takes it directly)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    warmup_steps: int = 0
    lr_schedule: str = "constant"  # constant | cosine
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass(frozen=True)
class AnomalyGuardConfig:
    """On-device anomaly detection in the train step (JAX
    ``AnomalyGuardConfig``, ``trainer.py:63``).

    A step is anomalous when its loss or pre-clip grad norm is non-finite,
    or — after ``warmup_steps`` good steps — when the pre-clip grad norm
    exceeds ``spike_factor ×`` the EMA of past good steps' norms. Anomalous
    steps leave params and optimizer state bit-identical (a per-leaf
    ``torch.where`` on the device, no host read); the EMA learns only from
    good steps.

    ``budget`` bounds the TOTAL skipped steps: the training loop
    (``trainer/loop.py``) reads the ``anomaly_skips`` metric one step late
    and halts with an emergency checkpoint once it exceeds the budget
    (``None``: unbounded). The guard carry rides every checkpoint, so a
    resumed run detects and budgets exactly as the uninterrupted run would."""

    spike_factor: float = 10.0
    warmup_steps: int = 10
    ema_decay: float = 0.95
    budget: Optional[int] = 25


def init_anomaly_guard_state(values: Optional[dict] = None,
                             device=None) -> Dict[str, torch.Tensor]:
    """The guard carry for ``TrainState.guard`` (JAX
    ``init_anomaly_guard_state``): zeros for a fresh run, or a checkpoint's
    carry (``values`` keyed like the tree) on resume. On the card unless
    ``device`` says otherwise (:func:`~neuronx_distributed_tpu_torch.utils.
    device.resolve_device`)."""
    device = resolve_device(device)
    values = values or {}

    def leaf(name, dtype):
        return torch.tensor(values.get(name, 0), dtype=dtype, device=device)

    return {
        "gnorm_ema": leaf("gnorm_ema", torch.float32),
        "good_steps": leaf("good_steps", torch.int32),
        "skips": leaf("skips", torch.int32),
    }


@dataclasses.dataclass
class TrainState:
    """``step`` counts the steps taken (a host int: JAX's device scalar is
    only ever incremented); ``params`` is the trainable model, whose fp32
    parameters are the masters; ``opt_state`` is :meth:`AdamW.init`'s dict;
    ``guard`` the anomaly-guard carry, or None without a guard.

    ``updating`` is True from a step's first in-place write of the state to
    its last: a step that raised with it set left the state torn (JAX's
    consumed donated buffers), one that raised before it left the state as
    it was."""

    step: int
    params: nn.Module
    opt_state: Dict
    guard: Optional[Dict[str, torch.Tensor]] = None
    updating: bool = False


# --- learning-rate schedules: optax's formulas on a device count ---------------

def _linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """``optax.linear_schedule`` (polynomial, power 1, no delay)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, 0, transition_steps).to(torch.float32)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float):
    """``optax.cosine_decay_schedule`` (exponent 1)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def make_lr_schedule(cfg: OptimizerConfig) -> Union[float, Callable[[torch.Tensor], torch.Tensor]]:
    """The learning rate as a constant, or as a function of the optimizer's
    update count (an int32 device tensor, evaluated BEFORE the update, as
    optax does: with warmup the first update has lr 0). Formula for formula
    optax's ``warmup_cosine_decay_schedule`` and ``linear_schedule``."""
    if cfg.lr_schedule == "cosine":
        warmup = max(cfg.warmup_steps, 1)
        peak, end = cfg.learning_rate, cfg.learning_rate * cfg.min_lr_ratio
        alpha = 0.0 if peak == 0.0 else end / peak
        warm = _linear_schedule(0.0, peak, warmup)
        decay = _cosine_decay_schedule(peak, cfg.total_steps - warmup, alpha)

        def schedule(count: torch.Tensor) -> torch.Tensor:  # optax.join_schedules
            return torch.where(count < warmup, warm(count), decay(count - warmup))

        return schedule
    if cfg.warmup_steps > 0:
        return _linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
    return cfg.learning_rate


# --- AdamW: optax's chain, per leaf, in place ------------------------------------

def _commit(dst: torch.Tensor, new: torch.Tensor, good: Optional[torch.Tensor]) -> None:
    """``dst <- new``, or with the guard ``dst <- where(good, new, dst)``."""
    if good is None:
        dst.copy_(new)
    else:
        torch.where(good, new, dst, out=dst)


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``, written out: the chain
    ``scale_by_adam`` (eps outside the square root, ``eps_root = 0``, bias
    correction with the count plus 1) → ``add_decayed_weights`` (no mask:
    every leaf decays, norms and embedding included) → ``scale_by_learning_rate``
    (the schedule at the count before the update). ``torch.optim.AdamW``
    applies the decay as a separate multiply and would round otherwise.

    The update runs leaf by leaf in place; with the anomaly guard each new
    value is selected against the old one before the next leaf, so at most a
    couple of leaf-sized temporaries are alive at a time."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        device = params[0].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               opt_state: Dict, good: Optional[torch.Tensor] = None) -> None:
        """One AdamW step on ``params`` in place. ``good`` (a 0-d bool device
        tensor) keeps params and state bit-identical where it is False."""
        b1, b2 = self.b1, self.b2
        count = opt_state["count"]
        lr = self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate
        count_inc = (count + 1).to(torch.float32)
        bc1 = 1 - torch.pow(b1, count_inc)
        bc2 = 1 - torch.pow(b2, count_inc)
        for p, g, mu, nu in zip(params, grads, opt_state["mu"], opt_state["nu"]):
            _commit(mu, (g * (1 - b1)).add_(mu, alpha=b1), good)
            _commit(nu, torch.square(g).mul_(1 - b2).add_(nu, alpha=b2), good)
            denom = (nu / bc2).sqrt_().add_(self.eps)
            upd = (mu / bc1).div_(denom)
            del denom
            upd.add_(p, alpha=self.weight_decay).mul_(-lr).add_(p)
            _commit(p, upd, good)
        _commit(count, count + 1, good)


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    """AdamW with fp32 state; clipping is done in the train step so the
    pre-clip norm can be reported (JAX ``make_optimizer``)."""
    return AdamW(make_lr_schedule(cfg), b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)


# --- loss and step -----------------------------------------------------------------

def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-token position WITHIN its segment for contiguous-run segment
    layouts (packed windows): positions restart at 0 at every document
    boundary (JAX ``segment_positions``, ``trainer.py:229``)."""
    s = segment_ids.shape[-1]
    idx = torch.arange(s, dtype=torch.int64, device=segment_ids.device)
    is_new = torch.ones_like(segment_ids, dtype=torch.bool)
    is_new[..., 1:] = segment_ids[..., 1:] != segment_ids[..., :-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=-1).values
    return idx - seg_start


def default_loss_fn(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean token cross entropy, weighted by ``loss_mask`` when present;
    packed batches (``segment_ids``) attend within their documents and
    restart RoPE at each (JAX ``default_loss_fn``, ``trainer.py:255``). A
    model that returns ``(logits, aux)`` (a Mixtral) raises ``TypeError``,
    as JAX's does: its objective is ``model.loss``."""
    seg = batch.get("segment_ids")
    if seg is not None:
        logits = model(batch["input_ids"], positions=segment_positions(seg), segment_ids=seg)
    else:
        logits = model(batch["input_ids"])
    if isinstance(logits, tuple):
        raise TypeError(
            f"{type(model).__name__} returns (logits, aux) — MoE objectives need the aux "
            "losses: pass loss_fn=lambda b, generator: model.loss(b['input_ids'], "
            "b['labels'], segment_ids=b.get('segment_ids'), loss_mask=b.get('loss_mask'), "
            "deterministic=False, generator=generator) to build_train_step")
    losses = parallel_cross_entropy(logits, batch["labels"])
    mask = batch.get("loss_mask")
    if mask is not None:
        return (losses * mask).sum() / torch.clamp(mask.sum(), min=1)
    return losses.mean()


_M64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """A 63-bit seed for step ``step`` of a run seeded ``seed``: splitmix64
    of the pair, a pure function of both (counter-based, as the port's
    sampling noise is), so a resumed run's step seeds equal the
    uninterrupted run's."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded :func:`step_seed` (seed,
    step): the port's ``fold_in(base, step)`` (JAX ``examples/train_moe.py``
    :205), made from host integers only."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _takes_generator(loss_fn) -> bool:
    try:
        return "generator" in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


_BATCH_DTYPES = {"input_ids": torch.int64, "labels": torch.int64,
                 "segment_ids": torch.int32, "loss_mask": torch.float32}


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch on ``device`` in the step's dtypes. Host data bound for the
    card goes through pinned staging and a ``non_blocking`` copy (cast on the
    card after), so moving a batch never waits for the step in flight."""
    device = torch.device(device)
    out = {}
    for name, x in batch.items():
        t = torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) else x
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t.to(device=device, dtype=_BATCH_DTYPES.get(name, t.dtype))
    return out


def build_train_step(model, optimizer: AdamW, max_grad_norm: float = 1.0,
                     loss_fn: Optional[Callable] = None, grad_accum_steps: int = 1,
                     anomaly_guard: Optional[AnomalyGuardConfig] = None, seed: int = 0):
    """One train step: fwd → bwd → clip → AdamW (JAX ``build_train_step``,
    ``trainer.py:292``). Returns ``step_fn(state, batch) -> (state,
    metrics)``; the state is updated in place and returned.

    ``batch`` maps names to numpy arrays or tensors (moved to the model's
    device). ``loss_fn(batch)`` defaults to :func:`default_loss_fn` on
    ``model``. A ``loss_fn`` with a ``generator`` parameter is called
    ``loss_fn(batch, generator=g)``, ``g`` made afresh for each step on the
    model's device by :func:`step_generator` (``seed``, ``state.step``):
    the router jitter and the token shuffle of a MoE step draw from it
    (JAX folds ``batch["step"]`` into its key; the port reads the host
    step count and nothing from the device), so a re-run of the same step
    (the canary's) and a resumed run draw what the first run drew. With
    ``grad_accum_steps = A > 1`` every leaf is shaped (A,
    B/A, ...): the A microbatches' gradients are summed and scaled by 1/A,
    and the loss is the mean of their losses. Metrics are device tensors:
    ``loss`` and the pre-clip ``grad_norm``; with ``anomaly_guard`` also
    ``good_step`` and the cumulative ``anomaly_skips`` (the state's
    ``guard`` carry must be set, :func:`init_anomaly_guard_state`)."""
    loss_fn = loss_fn or partial(default_loss_fn, model)
    params: List[torch.Tensor] = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters: build it with trainable=True")
    device = params[0].device
    draws = _takes_generator(loss_fn)

    def loss_of(batch, gen):
        return loss_fn(batch, generator=gen) if draws else loss_fn(batch)

    def value_and_grad(batch, gen):
        if grad_accum_steps == 1:
            loss = loss_of(batch, gen)
            loss.backward()
            return loss.detach().to(torch.float32)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(grad_accum_steps):
            loss = loss_of({name: x[i] for name, x in batch.items()}, gen)
            loss.backward()  # .grad accumulates the microbatches' sum
            loss_sum += loss.detach().to(torch.float32)
        inv = 1.0 / grad_accum_steps
        for p in params:
            if p.grad is not None:
                p.grad.mul_(inv)
        return loss_sum * inv

    def step_fn(state: TrainState, batch):
        if anomaly_guard is not None and state.guard is None:
            raise ValueError("anomaly_guard needs state.guard = init_anomaly_guard_state(...)")
        for p in params:
            p.grad = None
        gen = step_generator(seed, state.step, device) if draws else None
        loss = value_and_grad(_to_device(batch, device), gen)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = clip_grad_norm(grads, max_grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        good = None
        if anomaly_guard is not None:
            g = state.guard
            finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
            warmed = g["good_steps"] >= anomaly_guard.warmup_steps
            # spike check on the PRE-clip norm (clipping would mask it)
            spike = warmed & (grad_norm > anomaly_guard.spike_factor * g["gnorm_ema"])
            good = finite & ~spike
        state.updating = True  # the first in-place write of the state
        optimizer.update(params, grads, state.opt_state, good)
        if anomaly_guard is not None:
            d = anomaly_guard.ema_decay
            ema = torch.where(g["good_steps"] == 0, grad_norm,
                              d * g["gnorm_ema"] + (1.0 - d) * grad_norm)
            # the EMA learns only from good steps
            torch.where(good, ema, g["gnorm_ema"], out=g["gnorm_ema"])
            g["good_steps"].add_(good.to(torch.int32))
            g["skips"].add_(1 - good.to(torch.int32))
            metrics["good_step"] = good
            metrics["anomaly_skips"] = g["skips"].clone()
        state.step += 1
        state.updating = False
        return state, metrics

    return step_fn


def create_train_state(model, optimizer: AdamW, seed: int = 0) -> TrainState:
    """Initialise a trainable model's parameters from ``seed`` (its
    family's ``init_params``: :func:`~neuronx_distributed_tpu_torch.models.
    llama.init_params`, or :func:`~neuronx_distributed_tpu_torch.models.
    mixtral.init_params` for a Mixtral or a DBRX; the port's counterpart of the JAX
    ``rng_key``) and the optimizer state beside them on the model's device
    (JAX ``create_train_state``, ``trainer.py:438``, minus the shardings)."""
    if not getattr(model, "trainable", False):
        raise ValueError("create_train_state needs a model built with trainable=True")
    moe = isinstance(model, (MixtralForCausalLM, DbrxForCausalLM))
    init = init_mixtral_params if moe else init_params
    init(model, seed=seed)
    params = [p for p in model.parameters() if p.requires_grad]
    return TrainState(step=0, params=model, opt_state=optimizer.init(params))
