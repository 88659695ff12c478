"""The streaming pieces of fangyan_tts_torch's ops and vocoder against the
JAX package, float32 on the CPU: the streaming masks and the lookahead
convolution with context are bit-equal; the vocoder's streaming windows
(`stream_window`, `finalize_window`, `rad_delta`) agree within 1e-4 (f0
and phase) and 1e-3 (wav); and `infer/stream.VocStream` equals vocoding
the whole mel at once within the port, and agrees with the JAX package's
VocStream chunk by chunk.

On unvoiced frames, where no phase enters, the stream equals whole-mel
vocoding within 1e-5. On voiced frames both round the source phase in
float32, the whole mel over the whole utterance and the stream within each
window and in its carry (mod 1); neither is exact. A float64 whole-mel
vocoding is the witness: the port's stream and the JAX package's are about
5e-5 from it, and the float32 whole mel about 2e-5, so the stream is held
within 1e-4 of the float64 reference (as the JAX package's stream is) and
within 2e-4 of the float32 whole mel."""

import copy
import types
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer import stream as tstream
from fangyan_tts_torch.models import hift as thift
from fangyan_tts_torch.models.from_jax import hift_from_jax
from fangyan_tts_torch.ops import convs as tconv
from fangyan_tts_torch.ops import masks as tmask
from fangyan_tts_tpu.infer import stream as jstream
from fangyan_tts_tpu.models import hift as jhift
from fangyan_tts_tpu.ops import convs as jconv
from fangyan_tts_tpu.ops import masks as jmask
from torch_port_util import both, np_params, to_jax

JC, TC = (replace(c, hift=replace(c.hift, stream_noise_seconds=10)) for c in both())
GAIN = 0.5  # vocoder weights: out of the +-0.99 clip and the 1e2 magnitude cap


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("lens, q_valid, lq, cap, chunk", [
    ([0, 30], [20, 7], 20, 64, 10),  # a prefill and a short (finalize) row
    ([150, 100], [50, 50], 50, 256, 50),  # a hop each, on the chunk grid
    ([5, 0], [13, 0], 16, 32, 7),  # off the grid, and a row with no valid frame
])
def test_stream_masks_exact(lens, q_valid, lq, cap, chunk):
    lens, q_valid = np.asarray(lens, np.int32), np.asarray(q_valid, np.int32)
    want = np.asarray(jmask.chunk_kv_bias(jnp.asarray(lens), jnp.asarray(q_valid), lq, cap, chunk))
    np.testing.assert_array_equal(tmask.chunk_kv_bias(_t(lens), _t(q_valid), lq, cap, chunk).numpy(), want)
    want_c, want_n = jmask.chunk_split_bias(jnp.asarray(lens), jnp.asarray(q_valid), lq, cap, chunk)
    got_c, got_n = tmask.chunk_split_bias(_t(lens), _t(q_valid), lq, cap, chunk)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(tmask.causal_mask(lq).numpy(), np.asarray(jmask.causal_mask(lq)))


@pytest.mark.parametrize("k, dil, n_ctx", [(4, 1, 3), (5, 1, 4), (4, 1, 1), (5, 2, 2)])
def test_causal_conv_right_context_exact(k, dil, n_ctx):
    """Small integer data: every sum is exact in float32, so both packages
    must give the same bits whatever their summation order."""
    rng = np.random.default_rng(k + dil + n_ctx)
    x = rng.integers(-3, 4, (2, 11, 6)).astype(np.float32)
    ctx = rng.integers(-3, 4, (2, n_ctx, 6)).astype(np.float32)
    w = rng.integers(-2, 3, (k, 6, 5)).astype(np.float32)  # JAX (K, Cin, Cout)
    b = rng.integers(-2, 3, 5).astype(np.float32)
    want = np.asarray(jconv.causal_conv1d_right(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=dil,
                                                context=jnp.asarray(ctx)))
    got = tconv.causal_conv1d_right(_t(x), _t(w.transpose(2, 1, 0).copy()), _t(b), dilation=dil, context=_t(ctx))
    assert got.shape == want.shape == (2, 11, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def _hift(f0_bias):
    jm = jhift.CausalHiFT(JC.hift)
    p = np_params(jm, 0, jnp.zeros((1, 16, 80)), gain=GAIN)
    p["f0_predictor"]["classifier"]["bias"] = np.asarray([f0_bias], np.float32)
    tm = thift.CausalHiFT(TC.hift)
    tm.load_state_dict(hift_from_jax(p, TC.hift), strict=True)
    return jm, to_jax(p), tm.eval()


def _mel(n, seed=1):
    return (np.random.default_rng(seed).standard_normal((1, n, 80)) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def voiced():
    return _hift(150.0)


def test_stream_window_and_rad_delta(voiced):
    jm, jp, tm = voiced
    mel, carry = _mel(108), np.random.default_rng(2).random((1, 9)).astype(np.float32)
    _, uniform = thift.nsf_buffers(9)
    buf = uniform[:, : 24000 * 10]
    off = 7 * 480
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(mel), jnp.asarray(carry), jnp.asarray(off, jnp.int32),
                               jnp.asarray(buf), method=jhift.CausalHiFT.stream_window))
    with torch.no_grad():
        got = tm.stream_window(_t(mel), _t(carry), off, _t(buf)).numpy()
    assert got.shape == want.shape == (1, 100 * 480)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.abs(want).max() > 1e-2
    for n_left in (0, 8):
        ctx = mel[:, : 53 + n_left]
        want = np.asarray(jm.apply({"params": jp}, jnp.asarray(ctx), n_left=n_left, method=jhift.CausalHiFT.rad_delta))
        with torch.no_grad():
            got = tm.rad_delta(_t(ctx), n_left).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_valid", [40, 128])
def test_finalize_window(voiced, n_valid):
    jm, jp, tm = voiced
    mel, carry = _mel(128, seed=3), np.random.default_rng(4).random((1, 9)).astype(np.float32)
    buf = thift.nsf_buffers(9)[1][:, : 24000 * 10]
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(mel), jnp.asarray(n_valid, jnp.int32), jnp.asarray(carry),
                               jnp.asarray(9600, jnp.int32), jnp.asarray(buf), method=jhift.CausalHiFT.finalize_window))
    with torch.no_grad():
        got = tm.finalize_window(_t(mel), n_valid, _t(carry), 9600, _t(buf)).numpy()
    np.testing.assert_allclose(got[:, : n_valid * 480], want[:, : n_valid * 480], rtol=0, atol=1e-3)


def _voc_stream(push, finalize, mel, total):
    chunks = [push(mel[:, 50 * k : 50 * (k + 1)]) for k in range(total // 50)]
    f_pad = np.zeros((1, tstream.F_CAP, 80), np.float32)
    f_pad[:, : total % 50] = mel[:, total // 50 * 50 :]
    return chunks + [finalize(f_pad, total % 50)]


@pytest.mark.parametrize("f0_bias, atol, atol64", [(0.0, 1e-5, 1e-5), (150.0, 2e-4, 1e-4)])
def test_voc_stream(f0_bias, atol, atol64):
    """Five pushes of 50 frames (young1, young2, first, two steady) and a
    33-frame finalize: the chunks on the emission grid, the stream equal to
    the whole mel vocoded at once (with zeros after it, as the finalize
    window has) in float32 within `atol` and in float64 within `atol64`,
    and each chunk within 1e-3 of the JAX package's."""
    jm, jp, tm = _hift(f0_bias)
    total = 283
    mel = _mel(total)
    host = types.SimpleNamespace(cfg=TC, hift=tm, dtype=torch.float32, device=torch.device("cpu"), _nsf_noise_dev=None)
    vs = tstream.VocStream(host)
    got = _voc_stream(lambda m: np.asarray(vs.push_dev(_t(m))), lambda f, n: vs.finalize(_t(f), n), mel, total)
    assert [len(c) // 480 for c in got] == [42, 50, 8, 50, 50, 83]
    padded = _t(np.pad(mel, ((0, 0), (0, 64), (0, 0))))
    with torch.no_grad():
        whole = tm(padded)[0][0, : total * 480].numpy()
        # forward() runs the f0 predictor and the source on a float32 copy; the
        # float64 reference runs the same three stages in float64
        tm64, mel64 = copy.deepcopy(tm).double(), padded.double()
        whole64 = tm64.decode(mel64, tm64.m_source(tm64.f0_predictor(mel64)))[0, : total * 480].numpy()
    np.testing.assert_allclose(np.concatenate(got), whole, rtol=0, atol=atol)
    np.testing.assert_allclose(np.concatenate(got), whole64, rtol=0, atol=atol64)
    assert np.abs(whole).max() > 1e-2

    jhost = types.SimpleNamespace(cfg=JC, hift=jm, hift_params=jp, dtype=jnp.float32)
    jvs = jstream.VocStream(jhost)
    want = _voc_stream(lambda m: jvs.push(jnp.asarray(m)), lambda f, n: jvs.finalize(jnp.asarray(f), n), mel, total)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.concatenate(want), whole64, rtol=0, atol=atol64)
    np.testing.assert_allclose(vs.carry.numpy(), np.asarray(jvs.carry), rtol=0, atol=1e-4)
