"""The port's learning-rate schedules and optimizer
(fangyan_tts_torch/train/scheduler.py) against the JAX package's optax
ones (fangyan_tts_tpu/train/scheduler.py), on the CPU:

- each of the nine SCHEDULERS entries step for step over steps
  0 .. 2 * warmup + 10, within 1e-6 relative;
- build_optimizer for adam, adamw and bf16 first moments, the global-norm
  clip active and inactive, three steps on a small tree: each step's
  parameter change within 1e-3 * lr of optax's, the moments (bf16 ones
  too) within 1e-6 and the counters equal;
- a step with a NaN gradient leaves the parameters and moments unchanged
  and counts as optax counts (apply_if_finite's three counters), and the
  next finite step goes on from there;
- MultiSteps (accum_grad = 2) over four microsteps, with its counters."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fangyan_tts_torch.train import scheduler as ts
from fangyan_tts_tpu.train import scheduler as js

W = 10  # warmup steps of the schedules that take one
SCHEDULES = {
    "warmuplr": dict(warmup_steps=W),
    "constantlr": {},
    "NoamHoldAnnealing": dict(warmup_steps=W, hold_steps=5, decay_rate=0.5, min_lr=1e-5),
    "noamhold": dict(warmup_steps=W, hold_steps=8, decay_rate=0.7, min_lr=2e-4),
    "noam": dict(warmup_steps=W, d_model=896),
    "cosine": dict(total_steps=1000, warmup_steps=W, min_lr=1e-5),
    "sqrt_constant": dict(constant_steps=100),
    "sqrt_annealing": dict(warmup_steps=W, min_lr=1e-6, total_steps=25),
    "square_annealing": dict(warmup_steps=W, min_lr=1e-6, max_steps=25),
}


def test_every_scheduler_is_covered():
    assert sorted(SCHEDULES) == sorted(js.SCHEDULERS) == sorted(ts.SCHEDULERS)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    lr = 1e-3
    want_fn = js.SCHEDULERS[name](lr, **SCHEDULES[name])
    got_fn = ts.SCHEDULERS[name](lr, **SCHEDULES[name])
    for step in range(2 * W + 11):
        want, got = float(want_fn(jnp.asarray(step, jnp.int32))), got_fn(step)
        assert abs(got - want) <= 1e-6 * abs(want), (name, step, got, want)


def test_cosine_without_warmup_matches_optax():
    want_fn, got_fn = js.cosine_annealing(2e-3, total_steps=40), ts.cosine_annealing(2e-3, total_steps=40)
    for step in range(30):
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        assert abs(got_fn(step) - want) <= 1e-6 * want, step


SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 3, 2)}


def _params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _find(state, cls):
    """The first node of type `cls` in an optax state."""
    if isinstance(state, cls):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _find(s, cls)
            if found is not None:
                return found
    return None


def _run_both(kw: dict, grads_seq: list, lr: float):
    """Drive optax (the JAX build_optimizer) and the port's optimizer over
    the same gradients; yields (jax params, torch params, jax state, torch
    state) after each step."""
    tx = js.build_optimizer(lr=lr, **kw)
    opt = ts.build_optimizer(lr=lr, **kw)
    jp = {k: jnp.asarray(v) for k, v in _params(0).items()}
    tp = [torch.from_numpy(v) for v in _params(0).values()]
    jstate, tstate = tx.init(jp), opt.init(tp)
    update = jax.jit(tx.update)  # as the JAX train step runs it
    for g in grads_seq:
        upd, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = opt.update([torch.from_numpy(v) for v in g.values()], tstate, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        yield jp, tp, jstate, tstate


def _grads(seed: int, scale: float, n: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [{k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()} for _ in range(n)]


def _assert_moments(jadam, tadam, bf16: bool):
    for (k, jmu), tmu in zip(jadam.mu.items(), tadam.mu):
        assert tmu.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_allclose(tmu.float().numpy(), np.asarray(jmu, np.float32), rtol=1e-6, atol=1e-8, err_msg=k)
    for (k, jnu), tnu in zip(jadam.nu.items(), tadam.nu):
        assert tnu.dtype == torch.float32
        np.testing.assert_allclose(tnu.numpy(), np.asarray(jnu), rtol=1e-6, atol=1e-12, err_msg=k)
    assert tadam.count == int(jadam.count)


@pytest.mark.parametrize("optim, moments", [("adam", None), ("adamw", None), ("adam", "bfloat16")])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])  # global norm about 0.5 (clip off) and 50 (clip on, at 5)
def test_optimizer_matches_optax(optim, moments, grad_scale):
    lr = 1e-2
    kw = dict(optim=optim, scheduler="warmuplr", scheduler_conf={"warmup_steps": 4}, grad_clip=5.0,
              weight_decay=0.05, moments_dtype=moments)
    prev_j, prev_t = _params(0), [torch.from_numpy(v) for v in _params(0).values()]
    for jp, tp, jstate, tstate in _run_both(kw, _grads(1, grad_scale), lr):
        for (k, a), b, pa, pb in zip(jp.items(), tp, prev_j.values(), prev_t):
            dj, dt = np.asarray(a) - np.asarray(pa), (b - pb).numpy()
            assert np.abs(dt - dj).max() <= 1e-3 * lr, k
            assert np.abs(dj).max() > 1e-3 * lr  # the step moved this leaf
        prev_j, prev_t = {k: np.asarray(v) for k, v in jp.items()}, tp
        _assert_moments(_find(jstate, optax.ScaleByAdamState), tstate.inner, moments is not None)


def test_nonfinite_step_is_skipped_as_optax_counts():
    lr = 1e-2
    grads = _grads(2, 1.0, n=4)
    grads[1]["b"][2] = np.nan
    grads[2]["a"][0, 1] = np.inf
    kw = dict(optim="adam", scheduler="constantlr")
    seen = []
    for i, (jp, tp, jstate, tstate) in enumerate(_run_both(kw, grads, lr)):
        jf = _find(jstate, optax.ApplyIfFiniteState)
        assert (tstate.notfinite_count, tstate.last_finite, tstate.total_notfinite) == \
            (int(jf.notfinite_count), bool(jf.last_finite), int(jf.total_notfinite))
        _assert_moments(_find(jstate, optax.ScaleByAdamState), tstate.inner, False)
        for (k, a), b in zip(jp.items(), tp):
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-3 * lr, k
        seen.append([b.clone() for b in tp])
    assert (tstate.total_notfinite, tstate.inner.count) == (2, 2)
    for a, b in zip(seen[0], seen[2]):  # steps 2 and 3 changed nothing
        assert torch.equal(a, b)


def test_multisteps_matches_optax():
    lr = 1e-2
    kw = dict(optim="adam", scheduler="warmuplr", scheduler_conf={"warmup_steps": 3}, accum_grad=2)
    for i, (jp, tp, jstate, tstate) in enumerate(_run_both(kw, _grads(3, 3.0, n=4), lr)):
        ms = _find(jstate, optax.MultiStepsState)
        assert (tstate.mini_step, tstate.gradient_step) == (int(ms.mini_step), int(ms.gradient_step))
        for (k, a), b in zip(jp.items(), tp):
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-3 * lr, (i, k)
        for (k, a), b in zip(ms.acc_grads.items(), tstate.acc_grads):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7, err_msg=k)
        _assert_moments(_find(ms.inner_opt_state, optax.ScaleByAdamState), tstate.inner.inner, False)
    assert tstate.gradient_step == 2 and tstate.inner.inner.count == 2


def test_global_norm_matches_optax():
    g = _grads(4, 2.0, n=1)[0]
    want = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    assert float(ts.global_norm([torch.from_numpy(v) for v in g.values()])) == pytest.approx(want, rel=1e-6)
