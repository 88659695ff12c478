"""The port's DPO (fangyan_tts_torch/train/dpo.py) against the JAX package's
(fangyan_tts_tpu/train/dpo.py), float32 on the CPU, with the same weights
(models/from_jax) and batches:

- dpo_loss, sigmoid, label-smoothed and IPO: the loss and both rewards
  within 2e-4 relative;
- one make_dpo_train_step, from a frozen copy of the policy (dpo_loss =
  log 2, the rewards 0) and from a reference with weights of its own: the
  losses within 2e-4 relative, acc equal, the rewards within 2e-4 and
  dpo_acc equal (with a reference of its own: against a frozen copy both
  rewards are 0 and the JAX step's rounding decides dpo_acc), the
  gradients' global norm within 2e-4 relative, and each parameter's change
  within 1e-3 * lr of the JAX one where both packages' gradients agree to
  1e-3 of themselves (over half of every tensor;
  tests/test_torch_train_loop.py says why);
- a second step: the reference module bit-equal to its state before the
  steps, the policy moved, and dpo_loss off log 2 (the aliasing guard: a
  reference sharing the policy's tensors would follow each in-place step);
- a reference that shares the policy's parameters is refused."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fangyan_tts_torch.models.from_jax import llm_from_jax
from fangyan_tts_torch.train import dpo as tdpo
from fangyan_tts_torch.train import scheduler as tsched
from fangyan_tts_torch.train import trainer as ttrainer
from fangyan_tts_tpu.train import dpo as jdpo
from fangyan_tts_tpu.train import scheduler as jsched
from fangyan_tts_tpu.train import trainer as jtrainer
from test_torch_train_models import llm_batch, llm_models
from torch_port_util import both, capture_grads, to_jax

JC, TC = both()
LR = 5e-3
RTOL = 2e-4
REL_G = 1e-3


def _close(got, want, rtol=RTOL):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("kw", [dict(), dict(label_smoothing=0.1), dict(ipo=True), dict(beta=0.5)])
def test_dpo_loss_matches_jax(kw):
    rng = np.random.default_rng(0)
    logps = [(rng.standard_normal(6) * 3 - 20).astype(np.float32) for _ in range(4)]
    want = jdpo.dpo_loss(*(jnp.asarray(x) for x in logps), **kw)
    got = tdpo.dpo_loss(*(torch.from_numpy(x) for x in logps), **kw)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=0)


def dpo_batch(seed: int) -> dict:
    """Two chosen rows then two rejected ones, right-padded plans."""
    return llm_batch(seed, b=4, length=48)


@pytest.mark.parametrize("ref_seed", [None, 10])
def test_dpo_steps_match_jax(ref_seed):
    """ref_seed None: the reference is a frozen copy of the policy, so the
    rewards are 0 and dpo_loss log 2 (dpo_acc compares two zeros, which
    rounding noise in the JAX step's two forwards decides, and is not held);
    otherwise the reference has weights of its own and every metric is held."""
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=9)
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    if ref_seed is None:
        ref, ref_p = ttrainer.frozen_copy(tm), p
    else:
        _, ref_p, ref = llm_models(JC.llm, TC.llm, seed=ref_seed)
        ref.requires_grad_(False)
    ref0 = {k: v.clone() for k, v in ref.state_dict().items()}
    kw = dict(lr=LR, scheduler="constantlr")
    jtx = optax.chain(capture_grads(), jsched.build_optimizer(**kw))
    ttx = tsched.build_optimizer(**kw)
    jstep = jdpo.make_dpo_train_step(jm, to_jax(ref_p), jtx)
    tstep = tdpo.make_dpo_train_step(tm, ref, ttx)
    jstate, tstate = jtrainer.init_state(to_jax(p), jtx), ttrainer.init_state(tm, ttx)
    batch = dpo_batch(1)
    jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tstate, tm_ = tstep(tstate, batch)
    assert sorted(tm_) == sorted(jm_)
    for k in ("loss", "sft_loss", "dpo_loss"):
        _close(tm_[k], jm_[k])
    assert float(tm_["acc"]) == pytest.approx(float(jm_["acc"]), abs=1e-7)
    if ref_seed is None:
        assert float(tm_["dpo_loss"]) == pytest.approx(math.log(2.0), rel=1e-6)
        assert float(tm_["chosen_reward"]) == float(tm_["reject_reward"]) == 0.0
    else:
        for k in ("chosen_reward", "reject_reward"):
            _close(tm_[k], jm_[k])
        assert float(tm_["dpo_acc"]) == float(jm_["dpo_acc"])

    # the port's gradients of this step at p0, against the JAX step's own
    fresh = llm_models(JC.llm, TC.llm, seed=9)[2]
    args = [torch.from_numpy(batch[k]) for k in ("src", "ids", "lengths", "targets")]
    ce, _, logps = tdpo._seq_logps(fresh, *args)
    with torch.no_grad():
        _, _, ref_logps = tdpo._seq_logps(ref, *args)
    loss = tdpo.dpo_loss(logps[:2], logps[2:], ref_logps[:2], ref_logps[2:])[0] + ce
    tgrads = dict(zip(dict(fresh.named_parameters()), torch.autograd.grad(loss, list(fresh.parameters()))))
    jgrads = llm_from_jax(jax.device_get(jstate.opt_state[0]), TC.llm)
    _close(tsched.global_norm(list(tgrads.values())), tsched.global_norm(list(jgrads.values())))
    want = llm_from_jax(jax.device_get(jstate.params), TC.llm)
    for k, v in tm.named_parameters():
        skip = (tgrads[k] - jgrads[k]).abs() > REL_G * jgrads[k].abs()
        err = ((v.detach() - p0[k]) - (want[k] - p0[k])).abs()[~skip]
        assert skip.float().mean() < 0.5 and float(err.max()) <= 1e-3 * LR, (k, float(skip.float().mean()))

    # a second step: the reference stays where it was and the policy moves on
    tstate, tm2 = tstep(tstate, dpo_batch(2))
    assert tstate.step == 2
    assert all(torch.equal(v, ref0[k]) for k, v in ref.state_dict().items())
    assert any(not torch.equal(v, p0[k]) for k, v in tm.state_dict().items())
    assert all(not p.requires_grad for p in ref.parameters())
    if ref_seed is None:  # a reference that followed the policy would hold the preference loss at log 2
        assert abs(float(tm2["dpo_loss"]) - math.log(2.0)) > 1e-6


def test_shared_reference_is_refused():
    _, _, tm = llm_models(JC.llm, TC.llm, seed=9)
    tx = tsched.build_optimizer(lr=LR)
    with pytest.raises(ValueError, match="shares parameters"):
        tdpo.make_dpo_train_step(tm, tm, tx)
