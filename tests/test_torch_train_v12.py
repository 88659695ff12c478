"""The CosyVoice1/2 training forwards of the port against the JAX package's,
float32 on the CPU, with the same weights (models/from_jax) and inputs, as
tests/test_torch_train_models.py holds CosyVoice3's:

- `TransformerLM.forward` (v1: the IGNORE_ID prefix of 2 + text_len, the
  speech targets, eos; label smoothing 0 and 0.1) against the JAX module's
  __call__;
- `CausalMaskedDiffWithXvec.forward` (v2, streaming off and on) and
  `MaskedDiffWithXvec.forward` (v1, through InterpolateRegulator.forward)
  with the JAX package's own five draws (jax.random.split(key, 5) and the
  calls of fangyan_tts_tpu/models/flow_xvec.py) fed to the port, ragged
  rows;
- `Qwen2LMV2`'s loss, which both packages inherit from CosyVoice3LM, on v2
  plans (data/lm_plan.remap_plan_v2: the sos / task rows of llm_embedding).

Tolerances: loss within 2e-4 relative, acc equal; each gradient leaf
within 1e-4 * max |g_jax| + 1e-7."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fangyan_tts_torch.config as tcfg
import fangyan_tts_tpu.config as jcfg
from fangyan_tts_torch.models import flow_xvec as tfx
from fangyan_tts_torch.models import from_jax as fj
from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models import llm_v1 as tv1
from fangyan_tts_tpu.data.lm_plan import build_plan, pad_plans_right, remap_plan_v2
from fangyan_tts_tpu.models import flow_xvec as jfx
from fangyan_tts_tpu.models import llm as jllm
from fangyan_tts_tpu.models import llm_v1 as jv1
from test_torch_train_models import assert_grads, jax_draws
from torch_port_util import QWEN, np_params, to_jax

LOSS_RTOL = 2e-4
V1_LM = dict(text_token_size=60, speech_token_size=50, text_encoder_input_size=16, llm_input_size=32,
             llm_output_size=32, text_enc_blocks=1, llm_blocks=2, heads=2, ffn=24)
V2_FLOW = dict(vocab_size=50, input_size=32, decoder_channels=(16,), num_mid_blocks=1, n_blocks=1, num_heads=2,
               attention_head_dim=8, enc_heads=2, enc_ffn=24, enc_blocks=1, enc_up_blocks=1, static_chunk_size=4)
V1_FLOW = dict(vocab_size=50, input_size=32, decoder_channels=(16, 16), num_mid_blocks=1, n_blocks=1, num_heads=2,
               attention_head_dim=8, enc_heads=2, enc_ffn=24, enc_blocks=1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _grads(tm, loss) -> dict:
    return dict(zip(dict(tm.named_parameters()), torch.autograd.grad(loss, list(tm.parameters()))))


def _close(got, want):
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), (float(got), float(want))


def v1_lm_batch(seed: int):
    rng = np.random.default_rng(seed)
    text_len = np.asarray([7, 4, 5], np.int32)
    speech_len = np.asarray([9, 12, 6], np.int32)
    return dict(text=rng.integers(0, 60, (3, 8)).astype(np.int32), text_len=text_len,
                speech=rng.integers(0, 50, (3, 12)).astype(np.int32), speech_len=speech_len,
                emb=rng.standard_normal((3, 192)).astype(np.float32))


@pytest.mark.parametrize("lsm", [0.0, 0.1])
def test_v1_lm_loss_and_grads(lsm):
    kw = dict(V1_LM, lsm_weight=lsm)
    jm = jv1.TransformerLM(**kw)
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(jm, 0, t, jnp.asarray([8]), t, jnp.asarray([8]), jnp.zeros((1, 192)), gain=1.0)
    tm = tv1.TransformerLM(**kw)
    tm.load_state_dict(fj.llm_v1_from_jax(p, **kw), strict=True)
    b = v1_lm_batch(1)
    args = ("text", "text_len", "speech", "speech_len", "emb")

    def f(params):
        return jm.apply({"params": params}, *(jnp.asarray(b[k]) for k in args))

    (want, want_acc), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(to_jax(p))
    loss, acc = tm(*(_t(b[k]) for k in args))
    _close(loss, want)
    assert float(acc) == pytest.approx(float(want_acc), abs=1e-7)
    assert_grads(_grads(tm, loss), fj.llm_v1_from_jax(jax.device_get(jg), **kw))


def flow_batch(seed: int, token_len=(8, 6, 5)):
    rng = np.random.default_rng(seed)
    b, lt = len(token_len), max(token_len)
    feat_len = np.asarray(token_len, np.int32) * 2
    feat = (rng.standard_normal((b, 2 * lt, 80)) * (np.arange(2 * lt)[None, :, None] < feat_len[:, None, None]))
    return dict(token=rng.integers(0, 50, (b, lt)).astype(np.int32), token_len=np.asarray(token_len, np.int32),
                feat=feat.astype(np.float32), feat_len=feat_len, emb=rng.standard_normal((b, 192)).astype(np.float32))


FLOW_ARGS = ("token", "token_len", "feat", "feat_len", "emb")


def _flow_check(jm, tm, p, from_jax, kw, batch, key, **call_kw):
    draws = jax_draws(key, batch["feat"].shape[0], batch["feat"].shape)
    assert draws["use_cond"].any() and not draws["use_cond"].all() and (draws["cfg"] > 0.2).any()

    def f(params):
        return jm.apply({"params": params}, *(jnp.asarray(batch[k]) for k in FLOW_ARGS), key, **call_kw)[0]

    want, jg = jax.jit(jax.value_and_grad(f))(to_jax(p))
    loss, aux = tm(*(_t(batch[k]) for k in FLOW_ARGS), draws, **call_kw)
    assert aux == {}
    _close(loss, want)
    assert_grads(_grads(tm, loss), from_jax(jax.device_get(jg), **kw))


def _flow_params(jm, seed):
    t = jnp.zeros((1, 8), jnp.int32)
    return np_params(jm, seed, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]), jnp.zeros((1, 192)),
                     jnp.zeros((2,), jnp.uint32), gain=0.7)


@pytest.mark.parametrize("streaming", [False, True])
def test_v2_flow_loss_and_grads(streaming):
    jm = jfx.CausalMaskedDiffWithXvec(**V2_FLOW)
    p = _flow_params(jm, 2)
    tm = tfx.CausalMaskedDiffWithXvec(**V2_FLOW)
    tm.load_state_dict(fj.flow_v2_from_jax(p, **V2_FLOW), strict=True)
    _flow_check(jm, tm, p, fj.flow_v2_from_jax, V2_FLOW, flow_batch(3), jax.random.PRNGKey(5), streaming=streaming)


def test_v1_flow_loss_and_grads():
    jm = jfx.MaskedDiffWithXvec(**V1_FLOW)
    p = _flow_params(jm, 4)
    tm = tfx.MaskedDiffWithXvec(**V1_FLOW)
    tm.load_state_dict(fj.flow_v1_from_jax(p, **V1_FLOW), strict=True)
    batch = flow_batch(6)
    batch["feat"] = np.concatenate([batch["feat"], np.zeros((3, 3, 80), np.float32)], axis=1)  # mel past 2 a token
    _flow_check(jm, tm, p, fj.flow_v1_from_jax, V1_FLOW, batch, jax.random.PRNGKey(5))


def _v2_llm_cfg(mod):
    return mod.LLMConfig(speech_token_size=50, extra_tokens=3, llm_input_size=64, llm_output_size=64,
                         qwen=mod.QwenConfig(**QWEN))


@pytest.mark.parametrize("lsm", [0.0, 0.1])
def test_qwen2lm_v2_loss_and_grads(lsm):
    jc, tc = (replace(_v2_llm_cfg(m), lsm_weight=lsm) for m in (jcfg, tcfg))
    jm = jllm.Qwen2LMV2(jc, dtype=jnp.float32)
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(jm, 7, t, t, jnp.asarray([8]), t, gain=0.5)
    tm = tllm.Qwen2LMV2(tc, dtype=torch.float32)
    tm.load_state_dict(fj.llm_v2_from_jax(p, tc), strict=True)
    rng = np.random.default_rng(8)
    plans = [remap_plan_v2(jc, build_plan(jc, rng.integers(0, 300, n).tolist(), rng.integers(0, 50, m).tolist(),
                                          bistream=False)) for n, m in ((5, 12), (3, 9), (6, 14))]
    batch = {k: np.asarray(v) for k, v in pad_plans_right(plans, 32).items()}
    assert (batch["src"] == 2).any()  # the sos / task rows of llm_embedding
    keys = ("src", "ids", "lengths", "targets")

    def f(params):
        return jm.apply({"params": params}, *(jnp.asarray(batch[k]) for k in keys))

    (want, want_acc), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(to_jax(p))
    loss, acc = tm(*(_t(batch[k]) for k in keys))
    _close(loss, want)
    assert float(acc) == pytest.approx(float(want_acc), abs=1e-7)
    assert_grads(_grads(tm, loss), fj.llm_v2_from_jax(jax.device_get(jg), tc))
