"""fangyan_tts_torch.models.{dit,flow} against the JAX package with the same
weights (models/from_jax.flow_from_jax), float32: the fixed CFM noise is
equal; the DiT velocity and the offline mel from the same tokens, prompt
mel and x-vector agree within 1e-3, also with the DiT's block kernels in
weight-only int8 (JAX trees quantized by quantize_dit_params on one side,
the port's state by quantize_dit_state on the other)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.models import flow as tflow
from fangyan_tts_torch.models.dit import precompute_mods
from fangyan_tts_torch.models.from_jax import flow_from_jax
from fangyan_tts_torch.ops.quant import quantize_dit_state
from fangyan_tts_tpu.models import flow as jflow
from fangyan_tts_tpu.models.dit import DiT
from fangyan_tts_tpu.ops.masks import chunk_attn_mask
from fangyan_tts_tpu.ops.quant import quantize_dit_params
from torch_port_util import both, np_params, to_jax

JC, TC = both()


def _flow(seed=0, int8=False):
    jm = jflow.CausalMaskedDiffWithDiT(JC.flow)
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(jm, seed, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]),
                  jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    sd = flow_from_jax(p, TC.flow)
    if int8:
        p, sd = quantize_dit_params(p), quantize_dit_state(sd)
        jm = jflow.CausalMaskedDiffWithDiT(replace(JC.flow, dit=replace(JC.flow.dit, quant_int8=True)))
    tm = tflow.CausalMaskedDiffWithDiT(replace(TC.flow, dit=replace(TC.flow.dit, quant_int8=int8)))
    tm.load_state_dict(sd, strict=True)
    return jm, to_jax(p), tm.eval()


def test_fixed_noise_equal():
    np.testing.assert_array_equal(tflow.fixed_cfm_noise(), jflow.fixed_cfm_noise())
    np.testing.assert_array_equal(tflow.cosine_t_span(10), jflow.cosine_t_span(10))


@pytest.mark.parametrize("chunk", [0, 10])
def test_dit_velocity(chunk):
    """One estimator call with ragged mel_len (CFG-style batch of 2)."""
    jm, jp, tm = _flow(1)
    rng = np.random.default_rng(2)
    b, l = 2, 36
    x, mu, cond = (rng.standard_normal((b, l, 80)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((b, 80)).astype(np.float32)
    t = np.asarray([0.3, 0.3], np.float32)
    mel_len = np.asarray([36, 22], np.int32)
    # the JAX side computes the AdaLN modulation in-block, the port ahead
    # of time (precompute_mods)
    want = np.asarray(DiT(JC.flow.dit).apply({"params": jp["estimator"]}, *(jnp.asarray(a) for a in (x, mu, t, spks, cond)),
                                             chunk_attn_mask(jnp.asarray(mel_len), l, chunk)))
    with torch.no_grad():
        mods = precompute_mods(tm.estimator, torch.from_numpy(t)[None], torch.float32)
        got = tm.estimator(*(torch.from_numpy(a) for a in (x, mu, t, spks, cond)), torch.from_numpy(mel_len),
                           chunk, mods[0]).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1, :22], want[1, :22], rtol=0, atol=1e-3)


@pytest.mark.parametrize("n_prompt", [0, 6])
def test_offline_mel(n_prompt):
    _check_offline_mel(n_prompt, int8=False)


@pytest.mark.parametrize("n_prompt", [0, 6])
def test_offline_mel_int8(n_prompt):
    _check_offline_mel(n_prompt, int8=True)


def _check_offline_mel(n_prompt: int, int8: bool):
    jm, jp, tm = _flow(0, int8)
    rng = np.random.default_rng(n_prompt)
    n_tok = 20 + n_prompt
    token = np.zeros((1, 32), np.int32)
    token[0, :n_tok] = rng.integers(0, 50, n_tok)
    token_len = np.asarray([n_tok], np.int32)
    pf = (rng.standard_normal((1, 2 * n_prompt, 80)) * 0.5).astype(np.float32)
    pf_len = np.asarray([2 * n_prompt], np.int32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    want = np.asarray(jflow.flow_inference(jm, jp, *(jnp.asarray(a) for a in (token, token_len, pf, pf_len, emb))))
    with torch.no_grad():
        mu, spks, conds, mel_len = tm.prepare_inference(*(torch.from_numpy(a) for a in (token, token_len, pf, pf_len, emb)))
        z = torch.from_numpy(tflow.fixed_cfm_noise()[:, : mu.shape[1]])
        got = tflow.cfm_solve(TC.flow, tm.estimator, z, mu, spks, conds, mel_len).numpy()
    assert got.shape == want.shape == (1, 64, 80)
    n = 2 * n_tok  # frames inside mel_len
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=0, atol=1e-3)
    assert np.abs(want[:, :n]).max() > 0.1  # the solve moved the noise
