"""fangyan_tts_torch ops against the JAX package's: masks (exact), convs and
STFT (<= 1e-5, float32), sampling (same ids where neither side draws), and
the port's copies of config.py and data/lm_plan.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch CPU thread per worker)
from fangyan_tts_torch import config as tcfg
from fangyan_tts_torch.data import lm_plan as tplan
from fangyan_tts_torch.ops import convs as tconv
from fangyan_tts_torch.ops import masks as tmask
from fangyan_tts_torch.ops import sampling as tsamp
from fangyan_tts_torch.ops import stft as tstft
from fangyan_tts_tpu import config as jcfg
from fangyan_tts_tpu.data import lm_plan as jplan
from fangyan_tts_tpu.ops import convs as jconv
from fangyan_tts_tpu.ops import masks as jmask
from fangyan_tts_tpu.ops import sampling as jsamp
from fangyan_tts_tpu.ops import stft as jstft


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("chunk", [0, 10, 7])
def test_masks_exact(chunk):
    lens = np.asarray([25, 9, 0], np.int32)
    np.testing.assert_array_equal(tmask.make_pad_mask(_t(lens), 25).numpy(), np.asarray(jmask.make_pad_mask(jnp.asarray(lens), 25)))
    got = tmask.chunk_attn_mask(_t(lens), 25, chunk)
    want = np.asarray(jmask.chunk_attn_mask(jnp.asarray(lens), 25, chunk))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmask.mask_to_bias(got).numpy(), np.asarray(jmask.mask_to_bias(jnp.asarray(want))))


@pytest.mark.parametrize("stride,pad,dil,groups", [(1, (2, 0), 1, 1), (3, (2, 0), 1, 1), (1, (0, 3), 2, 1), (1, 2, 1, 4)])
def test_conv1d(stride, pad, dil, groups):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 23, 8)).astype(np.float32)
    k = rng.standard_normal((5, 8 // groups, 12)).astype(np.float32)  # JAX (K, Cin/g, Cout)
    b = rng.standard_normal(12).astype(np.float32)
    want = jconv.conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride, padding=pad, dilation=dil, groups=groups)
    got = tconv.conv1d(_t(x), _t(k.transpose(2, 1, 0).copy()), _t(b), stride=stride, padding=pad, dilation=dil, groups=groups)
    _close(got, want)


@pytest.mark.parametrize("side,k,dil", [("left", 3, 1), ("left", 7, 3), ("right", 4, 1), ("right", 5, 2)])
def test_causal_conv(side, k, dil):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 19, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    jf = jconv.causal_conv1d_left if side == "left" else jconv.causal_conv1d_right
    tf = tconv.causal_conv1d_left if side == "left" else tconv.causal_conv1d_right
    want = jf(jnp.asarray(x), jnp.asarray(w), None, dilation=dil)
    got = tf(_t(x), _t(w.transpose(2, 1, 0).copy()), None, dilation=dil)
    assert got.shape == want.shape
    _close(got, want)


def test_resampling():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3)).astype(np.float32)
    _close(tconv.upsample_nearest(_t(x), 4), jconv.upsample_nearest(jnp.asarray(x), 4), 0)
    y = rng.standard_normal((2, 60, 3)).astype(np.float32)
    _close(tconv.downsample_linear(_t(y), 6), jconv.downsample_linear(jnp.asarray(y), 6))


@pytest.mark.parametrize("stride,pad", [(8, 4), (5, 3), (3, 2)])
def test_conv_transpose1d(stride, pad):
    """The port's (Cin, Cout, K) kernel is the axis reversal of the JAX
    (K, Cout, Cin) one (models/from_jax.py)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    k = rng.standard_normal((2 * stride, 4, 6)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride, padding=pad)
    got = tconv.conv_transpose1d(_t(x), _t(k.transpose(2, 1, 0).copy()), _t(b), stride=stride, padding=pad)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("n_fft,hop,center", [(16, 4, True), (64, 16, False)])
def test_stft_istft(n_fft, hop, center):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 400)).astype(np.float32)
    win = jstft.hann_window(n_fft)
    np.testing.assert_array_equal(tstft.hann_window(n_fft), win)
    jr, ji = jstft.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(win), center=center)
    tr, ti = tstft.stft(_t(x), n_fft, hop, _t(win), center=center)
    _close(tr, jr)
    _close(ti, ji)
    want = jstft.istft(jr, ji, n_fft, hop, jnp.asarray(win))
    got = tstft.istft(tr, ti, n_fft, hop, _t(win))
    _close(got, want)


def test_sampling_greedy_matches():
    """top_k=1 and tau_r > 1: the draw is the argmax on both sides, and the
    stop-id mask applies before it."""
    rng = np.random.default_rng(5)
    logp = np.log(rng.dirichlet(np.ones(40), size=3)).astype(np.float32)
    recent = rng.integers(0, 40, (3, 10)).astype(np.int32)
    valid = recent >= 0
    allowed = np.ones((3, 40), bool)
    allowed[:, 30:] = False
    g = torch.Generator().manual_seed(0)
    got = tsamp.ras_sample(_t(logp), _t(recent), _t(valid), _t(allowed), g, top_k=1, tau_r=1.1).numpy()
    import jax

    for r in range(3):
        want = jsamp.ras_sample(jax.random.PRNGKey(r), jnp.asarray(logp[r]), jnp.asarray(recent[r]), jnp.asarray(valid[r]),
                                jnp.asarray(allowed[r]), top_k=1, tau_r=1.1)
        assert int(want) == got[r] == int(np.argmax(np.where(allowed[r], logp[r], -np.inf)))


def test_sampling_draws_inside_nucleus():
    """The port's own draws: only ids in the top-p ∧ top-k nucleus, never a
    masked id; RAS falls back to the full (allowed) distribution."""
    rng = np.random.default_rng(6)
    probs = rng.dirichlet(np.ones(50) * 0.3, size=64).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    got = tsamp.nucleus_pick(_t(probs), g, top_p=0.8, top_k=5).numpy()
    for r in range(64):
        order = np.argsort(-probs[r], kind="stable")[:5]
        cum_excl = np.cumsum(probs[r][order]) - probs[r][order]
        assert got[r] in set(order[cum_excl < 0.8].tolist())
    logp = _t(np.log(probs))
    allowed = torch.ones((64, 50), dtype=torch.bool)
    allowed[:, 40:] = False
    recent = torch.from_numpy(np.tile(got[:, None], (1, 10)).astype(np.int32))  # every candidate repeats
    ids = tsamp.ras_sample(logp, recent, recent >= 0, allowed, g, top_p=0.8, top_k=5).numpy()
    assert (ids < 40).all()


def test_config_and_lm_plan_copies():
    for name in ("QwenConfig", "LLMConfig", "DiTConfig", "FlowConfig", "HiFTConfig", "MelConfig", "CosyVoiceConfig"):
        j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
        assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
        assert jcfg.config_to_json(j) == tcfg.config_to_json(t)
    jc, tc = jcfg.LLMConfig(), tcfg.LLMConfig()
    for bistream in (False, True):
        text, speech = list(range(3, 20)), list(range(100, 160))
        a, b = jplan.build_plan(jc, text, speech, [7, 8], bistream), tplan.build_plan(tc, text, speech, [7, 8], bistream)
        for f in ("src", "ids", "targets"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    pa = jplan.pad_plans_left([jplan.build_prompt_plan(jc, [1, 2, 3], [9, 9])], 16)
    pb = tplan.pad_plans_left([tplan.build_prompt_plan(tc, [1, 2, 3], [9, 9])], 16)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
