"""fangyan_tts_torch.models.hift against the JAX CausalHiFT with the same
weights (models/from_jax.hift_from_jax), float32: the NSF noise buffers are
equal, f0 within 1e-4 and the wav within 1e-3. The f0 classifier's bias is
set high enough that frames are voiced, so the harmonic source is driven."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.models import hift as thift
from fangyan_tts_torch.models.from_jax import hift_from_jax
from fangyan_tts_tpu.models import hift as jhift
from torch_port_util import both, np_params, to_jax

JC, TC = both()
GAIN = 0.5  # weight scale: the vocoder stays out of its +-0.99 clip and its 1e2 magnitude cap


def _hift(seed, f0_bias):
    jm = jhift.CausalHiFT(JC.hift)
    p = np_params(jm, seed, jnp.zeros((1, 16, 80)), gain=GAIN)
    p["f0_predictor"]["classifier"]["bias"] = np.asarray([f0_bias], np.float32)
    tm = thift.CausalHiFT(TC.hift)
    tm.load_state_dict(hift_from_jax(p, TC.hift), strict=True)
    return jm, to_jax(p), tm.eval()


def test_nsf_buffers_equal():
    small = (9, 4800)
    want = jhift.nsf_buffers.__wrapped__(*small)
    got = thift.nsf_buffers(*small)
    assert len(got) == 2
    for a, b in zip(got, want[:2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("f0_bias", [0.0, 180.0])
def test_f0_and_wav(f0_bias):
    jm, jp, tm = _hift(0, f0_bias)
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((1, 24, 80)) * 0.5).astype(np.float32)
    f0_j = np.asarray(jm.apply({"params": jp}, jnp.asarray(mel), method=lambda m, x: m.f0_predictor(x)))
    wav_j, src_j = jm.apply({"params": jp}, jnp.asarray(mel))
    with torch.no_grad():
        f0_t = tm.f0_predictor(torch.from_numpy(mel)).numpy()
        wav_t, src_t = tm(torch.from_numpy(mel))
    np.testing.assert_allclose(f0_t, f0_j, rtol=0, atol=1e-4)
    if f0_bias:
        assert (f0_j > JC.hift.nsf_voiced_threshold).mean() > 0.5
    np.testing.assert_allclose(src_t.numpy(), np.asarray(src_j), rtol=0, atol=1e-4)
    assert wav_t.shape == wav_j.shape == (1, 24 * 480)
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), rtol=0, atol=1e-3)
    assert np.abs(np.asarray(wav_j)).max() > 1e-2
