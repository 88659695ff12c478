"""Learning-rate schedules and the optimizer of the JAX package's training
(fangyan_tts_tpu/train/scheduler.py), without optax.

Each schedule is a plain function of the optimizer step (an int) with the
optax schedule's semantics, computed in float32 in the JAX formulas' order
(numpy float32 scalars; Python floats enter as JAX's weakly typed
constants do), so the learning rates are the JAX package's to the last bit
or two. `cosine` is optax.warmup_cosine_decay_schedule.

`build_optimizer` is the JAX chain, as plain functions on lists of tensors:
clip_by_global_norm (optax's formula: leaves scaled by max_norm / norm only
when the norm is at least max_norm, and no epsilon), then adam or adamw
(optax's eps outside the square root, bias correction, decoupled weight
decay, and `mu_dtype`: with moments_dtype="bfloat16" the first moment is
stored in bfloat16 and the second in float32, and b1 is rounded to
bfloat16 before it scales mu, as the jitted JAX step does), all inside apply_if_finite
(max_consecutive_errors 100, optax's three counters), and optax's MultiSteps
around it for accum_grad > 1. `plain_adam` is the bare chain that the JAX
package's GAN and GRPO code builds itself (optax.adam / adamw at a constant
rate, optionally after clip_by_global_norm): no finite skip, no MultiSteps.
torch.optim.Adam cannot keep a bfloat16 first moment beside a float32
second one. Counters are host ints: apply_if_finite reads one device flag a
step to choose its branch, where optax runs a lax.cond.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]
_f32 = np.float32


def warmup_lr(lr: float, warmup_steps: int = 25000) -> Schedule:
    """WarmupLR: lr * w^0.5 * min(step^-0.5, step * w^-1.5), step >= 1."""

    def sched(step: int) -> float:
        s = _f32(max(step, 1))
        w = float(warmup_steps)
        return float(lr * w**0.5 * np.minimum(s**-0.5, s * w**-1.5))

    return sched


def constant_lr(lr: float, **_) -> Schedule:
    return lambda step: float(_f32(lr))


def noam_hold_annealing(lr: float, warmup_steps: int = 25000, hold_steps: int = 25000, decay_rate: float = 0.5,
                        min_lr: float = 1e-5) -> Schedule:
    """NoamHoldAnnealing: linear warmup, hold, then ((w + h) / step)^rate,
    floored at min_lr."""

    def sched(step: int) -> float:
        s = _f32(max(step, 1))
        w, h = float(warmup_steps), float(hold_steps)
        val = lr * (s / w if s <= w else _f32(1.0) if s <= w + h else ((w + h) / s) ** decay_rate)
        return float(np.maximum(_f32(val), min_lr))

    return sched


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (polynomial_schedule, power 1)."""
    if steps <= 0:
        return lambda count: _f32(init)

    def sched(count: int):
        frac = 1 - _f32(min(max(count, 0), steps)) / _f32(steps)
        return (init - end) * frac + end

    return sched


def _cosine_decay(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule, exponent 1."""

    def sched(count: int):
        c = _f32(min(count, decay_steps))
        cosine = 0.5 * (1 + np.cos(_f32(np.pi) * c / _f32(decay_steps)))
        return init * ((1 - alpha) * cosine + alpha)

    return sched


def cosine_annealing(lr: float, total_steps: int, warmup_steps: int = 0, min_lr: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule(init 0 with a warmup else lr, peak
    lr, warmup max(warmup_steps, 1), decay max(total_steps, warmup + 1),
    end min_lr)."""
    warm = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1)
    if decay_steps <= warm:
        raise ValueError(f"cosine: total_steps {total_steps} leaves no decay after {warm} warmup steps")
    alpha = 0.0 if lr == 0.0 else min_lr / lr
    first = _linear(0.0 if warmup_steps else lr, lr, warm)
    second = _cosine_decay(lr, decay_steps - warm, alpha)
    return lambda step: float(_f32(first(step) if step < warm else second(step - warm)))


def noam_annealing(lr: float, warmup_steps: int = 25000, d_model: int = 896, **_) -> Schedule:
    """NoamAnnealing: d^-0.5 * min(s^-0.5, s * w^-1.5), scaled so the peak is lr."""

    def sched(step: int) -> float:
        s = _f32(max(step, 1))
        w = float(warmup_steps)
        base = d_model**-0.5 * np.minimum(s**-0.5, s * w**-1.5)
        return float(lr * base / (d_model**-0.5 * w**-0.5))

    return sched


def square_root_constant_lr(lr: float, constant_steps: int = 10000, **_) -> Schedule:
    """SquareRootConstantLR: lr / sqrt(constant_steps), constant."""
    return lambda step: float(_f32(lr / float(constant_steps) ** 0.5))


def _warm(s, warmup_steps: int):
    return np.minimum(s / max(warmup_steps, 1), _f32(1.0)) if warmup_steps > 0 else _f32(1.0)


def square_root_annealing(lr: float, warmup_steps: int = 0, min_lr: float = 0.0, total_steps: int = 1000000,
                          **_) -> Schedule:
    """SquareRootAnnealing: warmup, then lr * sqrt(1 - step / total)."""

    def sched(step: int) -> float:
        s = _f32(step)
        frac = np.clip(1.0 - s / float(total_steps), _f32(0.0), _f32(1.0))
        return float(np.maximum(lr * _warm(s, warmup_steps) * np.sqrt(frac), min_lr))

    return sched


def square_annealing(lr: float, warmup_steps: int = 0, min_lr: float = 1e-5, max_steps: int = 1000000,
                     **_) -> Schedule:
    """SquareAnnealing: linear warmup, then lr * ((max - s) / max)^2 over the
    post-warmup span, floored at min_lr."""

    def sched(step: int) -> float:
        s = _f32(step)
        span = float(max(max_steps - warmup_steps, 1))
        frac = np.clip((span - (s - warmup_steps)) / span, _f32(0.0), _f32(1.0))
        return float(np.maximum(lr * _warm(s, warmup_steps) * frac**2, min_lr))

    return sched


SCHEDULERS = {
    "warmuplr": warmup_lr,
    "constantlr": constant_lr,
    "NoamHoldAnnealing": noam_hold_annealing,
    "noamhold": noam_hold_annealing,
    "noam": noam_annealing,
    "cosine": cosine_annealing,
    "sqrt_constant": square_root_constant_lr,
    "sqrt_annealing": square_root_annealing,
    "square_annealing": square_annealing,
}


# ---------------------------------------------------------------- optimizer

Tensors = list[torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, which the JAX package keeps
MAX_CONSECUTIVE_ERRORS = 100  # the JAX package's apply_if_finite


def global_norm(tensors: Tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square, float32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


def all_finite(tensors: Tensors) -> torch.Tensor:
    """A device bool: every element of every tensor is finite (0 * x is 0
    for a finite x and NaN for an infinite or NaN one)."""
    return torch.stack(torch._foreach_norm(torch._foreach_mul(tensors, 0.0), 1)).sum() == 0


@dataclass
class AdamState:
    count: int  # also the schedule's step: optax's scale_by_schedule counts the same updates
    mu: Tensors
    nu: Tensors


@dataclass
class FiniteState:
    """optax.apply_if_finite's counters around the inner state."""
    notfinite_count: int
    last_finite: bool
    total_notfinite: int
    inner: AdamState


@dataclass
class MultiStepsState:
    mini_step: int
    gradient_step: int
    acc_grads: Tensors
    inner: FiniteState


@dataclass
class Optimizer:
    """The JAX package's optax chain; `init(params)` and
    `update(grads, state, params) -> (updates, state)` on lists of tensors
    in one fixed order (updates are added to the params by the caller,
    optax.apply_updates)."""

    schedule: Schedule
    weight_decay: float | None = None  # None: adam; a float: adamw
    grad_clip: float | None = 5.0  # None: no clip
    accum_grad: int = 1
    mu_dtype: torch.dtype | None = None
    skip_nonfinite: bool = True  # False: the bare chain, whose state is the AdamState

    def init(self, params: Tensors):
        adam = AdamState(0, [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params],
                         [torch.zeros_like(p) for p in params])
        if not self.skip_nonfinite:
            return adam
        state = FiniteState(0, True, 0, adam)
        if self.accum_grad > 1:
            return MultiStepsState(0, 0, [torch.zeros_like(p) for p in params], state)
        return state

    def update(self, grads: Tensors, state, params: Tensors):
        if not self.skip_nonfinite:
            return self._adam(self._clip(grads), state, params)
        if self.accum_grad > 1:
            return self._multi_steps(grads, state, params)
        return self._if_finite(grads, state, params)

    # optax.MultiSteps (use_grad_mean): every call runs the inner update on
    # the running mean; its result and state are kept on the k-th call only
    def _multi_steps(self, grads: Tensors, st: MultiStepsState, params: Tensors):
        k = self.accum_grad
        acc = [a + (g - a) / (st.mini_step + 1) for g, a in zip(grads, st.acc_grads)]
        updates, inner = self._if_finite(acc, st.inner, params)
        emit = st.mini_step == k - 1
        new = MultiStepsState((st.mini_step + 1) % k, st.gradient_step + emit, acc, st.inner)
        if emit:  # optax multiplies by (1 - emit) and emit, so a NaN survives both
            new.inner = inner
            new.acc_grads = torch._foreach_mul(acc, 0.0)
        else:
            updates = torch._foreach_mul(updates, 0.0)
        return updates, new

    def _if_finite(self, grads: Tensors, st: FiniteState, params: Tensors):
        finite = bool(all_finite(grads))
        notfinite = 0 if finite else st.notfinite_count + 1
        if finite or notfinite > MAX_CONSECUTIVE_ERRORS:
            updates, inner = self._adam(self._clip(grads), st.inner, params)
        else:
            updates, inner = [torch.zeros_like(g) for g in grads], st.inner
        return updates, FiniteState(notfinite, finite, st.total_notfinite + (not finite), inner)

    def _clip(self, grads: Tensors) -> Tensors:
        if self.grad_clip is None:
            return grads
        g_norm = global_norm(grads)
        if bool(g_norm < self.grad_clip):
            return grads
        clipped = torch._foreach_div(grads, g_norm)
        torch._foreach_mul_(clipped, self.grad_clip)
        return clipped

    def _adam(self, grads: Tensors, st: AdamState, params: Tensors):
        b1, b2 = B1, B2
        # the moments in float32. With a bf16 mu, b1 is rounded to bf16 (JAX converts the weakly
        # typed constant to mu's dtype: 0.9 becomes 0.8984375) and the jitted step keeps the
        # product in float32
        b1_mu = float(torch.tensor(b1, dtype=st.mu[0].dtype)) if st.mu else b1
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul([m.float() for m in st.mu], b1_mu))
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(st.nu, b2))
        count = st.count + 1
        bc1 = float(1 - np.power(_f32(b1), _f32(count)))
        bc2 = float(1 - np.power(_f32(b2), _f32(count)))
        # the temporaries are updated in place (one tree each at a time): the sweep sets the step's
        # peak memory at full width
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, den)
        del den
        if self.weight_decay is not None:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(st.count))
        if self.mu_dtype is not None:
            mu = [m.to(self.mu_dtype) for m in mu]
        return updates, AdamState(count, mu, nu)


def build_optimizer(
    optim: str = "adam",
    lr: float = 1e-5,
    scheduler: str = "constantlr",
    scheduler_conf: dict | None = None,
    grad_clip: float = 5.0,
    accum_grad: int = 1,
    weight_decay: float = 0.0,
    moments_dtype=None,
) -> Optimizer:
    """adam / adamw x a schedule, global-norm clip, the non-finite skip and,
    for accum_grad > 1, the legacy step-per-microbatch MultiSteps (prefer
    the in-step accumulation of train/trainer.make_*_train_step(accum=...):
    the same numbers with one optimizer sweep a step)."""
    sched = SCHEDULERS[scheduler](lr, **(scheduler_conf or {}))
    if optim not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {optim}")
    mu_dtype = getattr(torch, moments_dtype) if isinstance(moments_dtype, str) else moments_dtype
    return Optimizer(sched, weight_decay if optim == "adamw" else None, grad_clip, accum_grad, mu_dtype)


def plain_adam(lr: float, weight_decay: float | None = None, grad_clip: float | None = None) -> Optimizer:
    """optax.adam(lr) (weight_decay None) or optax.adamw(lr, weight_decay),
    after clip_by_global_norm(grad_clip) when grad_clip is given: optax's
    default b1, b2 and eps, a constant rate, no finite skip."""
    return Optimizer(constant_lr(lr), weight_decay, grad_clip, skip_nonfinite=False)
