"""The CosyVoice1/2 building blocks of fangyan_tts_torch against the JAX
package with the same weights (models/from_jax.py), float32 on the CPU:
- the conformer stacks (a macaron + convolution ConformerEncoder, its
  streaming forward_chunk against its own full chunk-masked forward and
  against the JAX forward_chunk, the UpsampleConformerEncoder with and
  without the chunk mask) within 1e-4;
- the U-Net ConditionalDecoder, causal with and without the streaming
  chunk mask and non-causal with a stride-2 level, within 1e-4;
- InterpolateRegulator (the v1 inference split and the training path);
- F0Predictor within 1e-4 and the non-causal HiFT at 22.05 kHz (sinegen1)
  and 24 kHz (sinegen2), with a source cache and the noise buffer at an
  offset: source within 1e-4, wav within 1e-3;
- upsample_linear, fade_in_out, espnet_rel_pos_table, rel_shift;
- nsf_gauss_noise / nsf_gauss_buffer bit-equal.
Weights are N(0, gain^2 / fan_in) from numpy (tests/torch_port_util.py)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.config import HiFTConfig as THiFTConfig
from fangyan_tts_torch.models import conformer as tconf
from fangyan_tts_torch.models import from_jax as fj
from fangyan_tts_torch.models import hift as thift
from fangyan_tts_torch.models import unet_decoder as tunet
from fangyan_tts_torch.models.flow_xvec import InterpolateRegulator as TReg
from fangyan_tts_torch.ops import convs as tconvs
from fangyan_tts_torch.utils import common as tcommon
from fangyan_tts_tpu.config import HiFTConfig as JHiFTConfig
from fangyan_tts_tpu.models import conformer as jconf
from fangyan_tts_tpu.models import hift as jhift
from fangyan_tts_tpu.models import unet_decoder as junet
from fangyan_tts_tpu.models.flow_xvec import InterpolateRegulator as JReg
from fangyan_tts_tpu.ops import convs as jconvs
from fangyan_tts_tpu.utils import common as jcommon
from torch_port_util import np_params, to_jax

ATOL = 1e-4
V1_HIFT = dict(sampling_rate=22050, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
               source_resblock_kernel_sizes=(7, 11), source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
               base_channels=32, f0_cond_channels=16)
V2_HIFT = dict(base_channels=32, f0_cond_channels=16)


def _load(tm, params):
    tm.load_state_dict(fj.convert(params, tm), strict=True)
    return tm.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- conformer


@pytest.fixture(scope="module")
def conformer():
    kw = dict(dim=32, heads=4, ffn_hidden=48, num_blocks=2, macaron=True, use_cnn=True, cnn_kernel=5,
              cnn_causal=True)
    jm = jconf.ConformerEncoder(**kw)
    x = jnp.zeros((1, 12, 24))
    p = np_params(jm, 3, x, jnp.asarray([12]), gain=0.7)
    tm = _load(tconf.ConformerEncoder(input_dim=24, **kw), p)
    return jm, to_jax(p), tm


@pytest.mark.parametrize("streaming", [False, True])
def test_conformer_encoder(conformer, streaming):
    jm, jp, tm = conformer
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((2, 12, 24)) * 0.5).astype(np.float32)
    lens = np.asarray([12, 9], np.int32)
    want, _ = jm.apply({"params": jp}, jnp.asarray(xs), jnp.asarray(lens), streaming=streaming, static_chunk_size=4)
    with torch.no_grad():
        got, _ = tm(_t(xs), _t(lens), streaming=streaming, static_chunk_size=4)
    valid = np.arange(12)[None, :] < lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=0, atol=ATOL)


def test_conformer_forward_chunk(conformer):
    """Chunk by chunk over a cache as long as the sequence: equal to the
    JAX forward_chunk, and to the port's own full forward under the
    chunk-causal mask (the causal convolution carries its cache)."""
    jm, jp, tm = conformer
    rng = np.random.default_rng(1)
    t_total, chunk = 12, 4
    xs = (rng.standard_normal((1, t_total, 24)) * 0.5).astype(np.float32)
    with torch.no_grad():
        full, _ = tm(_t(xs), torch.tensor([t_total]), streaming=True, static_chunk_size=chunk)
        tk, tv, tc = tm.init_chunk_state(1, t_total)
        jk, jv, jc = jm.init_chunk_state(1, t_total)
        outs = []
        for n_valid in range(0, t_total, chunk):
            ys, tk, tv, tc = tm.forward_chunk(_t(xs[:, n_valid: n_valid + chunk]), tk, tv, tc, n_valid)
            jys, jk, jv, jc = jm.apply({"params": jp}, jnp.asarray(xs[:, n_valid: n_valid + chunk]), jk, jv, jc,
                                       jnp.asarray(n_valid, jnp.int32), method=jconf.ConformerEncoder.forward_chunk)
            np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=0, atol=ATOL)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
            outs.append(ys.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("streaming", [False, True])
def test_upsample_conformer_encoder(streaming):
    kw = dict(dim=32, heads=4, ffn_hidden=48, num_blocks=2, num_up_blocks=1, static_chunk_size=4)
    jm = jconf.UpsampleConformerEncoder(**kw)
    p = np_params(jm, 4, jnp.zeros((1, 10, 32)), jnp.asarray([10]), gain=0.7)
    tm = _load(tconf.UpsampleConformerEncoder(**kw), p)
    rng = np.random.default_rng(2)
    xs = (rng.standard_normal((2, 10, 32)) * 0.5).astype(np.float32)
    lens = np.asarray([10, 7], np.int32)
    xs[1, 7:] = 0.0
    want, wl = jm.apply({"params": to_jax(p)}, jnp.asarray(xs), jnp.asarray(lens), streaming=streaming)
    with torch.no_grad():
        got, gl = tm(_t(xs), _t(lens), streaming=streaming)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    valid = np.arange(20)[None, :] < 2 * lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=0, atol=ATOL)


def test_rel_pos_table_and_shift():
    np.testing.assert_array_equal(tconf.espnet_rel_pos_table(7, 16), jconf.espnet_rel_pos_table(7, 16))
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(tconf.rel_shift(_t(x)).numpy(), np.asarray(jconf.rel_shift(jnp.asarray(x))))


# ---------------------------------------------------------------- U-Net


@pytest.mark.parametrize("causal,streaming,channels", [(True, False, (16,)), (True, True, (16,)),
                                                       (False, False, (16, 16))])
def test_conditional_decoder(causal, streaming, channels):
    kw = dict(in_channels=320, out_channels=80, channels=channels, n_blocks=1, num_mid_blocks=2, num_heads=2,
              attention_head_dim=8, causal=causal, static_chunk_size=6)
    jm = junet.ConditionalDecoder(**kw)
    b, t = 2, 17
    z = jnp.zeros((1, t, 80))
    p = np_params(jm, 5, z, z, jnp.zeros((1,)), jnp.zeros((1, 80)), z, jnp.asarray([t]), gain=0.7)
    tm = _load(tunet.ConditionalDecoder(**kw), p)
    rng = np.random.default_rng(6)
    x, mu, cond = (rng.standard_normal((b, t, 80)).astype(np.float32) for _ in range(3))
    tt = np.asarray([0.3, 0.8], np.float32)
    spks = rng.standard_normal((b, 80)).astype(np.float32)
    lens = np.asarray([t, 12], np.int32)
    want = jm.apply({"params": to_jax(p)}, *map(jnp.asarray, (x, mu, tt, spks, cond, lens)), streaming=streaming)
    with torch.no_grad():
        got = tm(*map(_t, (x, mu, tt, spks, cond, lens)), streaming=streaming)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert np.abs(np.asarray(want)).max() > 1e-2


# ---------------------------------------------------------------- regulator


@pytest.mark.parametrize("tok2,mel2", [(30, 51), (55, 95)])
def test_interpolate_regulator_inference(tok2, mel2):
    jm = JReg(16)
    p = np_params(jm, 7, jnp.zeros((1, 8, 16)), 12, gain=0.7)
    tm = _load(TReg(16), p)
    rng = np.random.default_rng(8)
    tok1, mel1, out_len = 9, 15, 128
    h = rng.standard_normal((1, 70, 16)).astype(np.float32)
    want = jm.apply({"params": to_jax(p)}, jnp.asarray(h), tok1, jnp.asarray(tok2), mel1, jnp.asarray(mel2), out_len,
                    method=JReg.inference)
    with torch.no_grad():
        got = tm.inference(_t(h), tok1, tok2, mel1, mel2, out_len)
        train_t = tm(_t(h[:, :20]), 33)
    train_j = jm.apply({"params": to_jax(p)}, jnp.asarray(h[:, :20]), 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(train_t.numpy(), np.asarray(train_j), rtol=0, atol=ATOL)


# ---------------------------------------------------------------- HiFT


@pytest.fixture(scope="module", params=["v1", "v2"])
def nc_hift(request):
    kw = V1_HIFT if request.param == "v1" else V2_HIFT
    jcfg, tcfg = JHiFTConfig(**kw), THiFTConfig(**kw)
    jm = jhift.HiFT(jcfg)
    p = np_params(jm, 9, jnp.zeros((1, 16, 80)), gain=0.5)
    p["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)
    tm = thift.HiFT(tcfg)
    tm.load_state_dict(fj.hift_nc_from_jax(p, tcfg), strict=True)
    return jm, to_jax(p), tm.eval(), tcfg


def test_f0_predictor(nc_hift):
    jm, jp, tm, _ = nc_hift
    mel = (np.random.default_rng(10).standard_normal((1, 20, 80)) * 0.5).astype(np.float32)
    want = jm.apply({"params": jp}, jnp.asarray(mel), method=lambda m, x: m.f0_predictor(x))
    with torch.no_grad():
        got = tm.f0_predictor(_t(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert (np.asarray(want) > 10.0).mean() > 0.5  # voiced: the harmonic source is driven


def test_hift_wav(nc_hift):
    """A streaming-style call: a source cache and the noise buffer at an
    offset, as tts_v12's vocoder calls it."""
    jm, jp, tm, cfg = nc_hift
    rng = np.random.default_rng(11)
    mel = (rng.standard_normal((1, 20, 80)) * 0.5).astype(np.float32)
    hop = cfg.total_upsample
    cache = (rng.standard_normal((1, 3 * hop, 1)) * 0.1).astype(np.float32)
    buf = jhift.nsf_gauss_buffer(cfg.nb_harmonics + 1, 60 * hop)
    off = 7 * hop
    wav_j, src_j = jm.apply({"params": jp}, jnp.asarray(mel), jnp.asarray(cache), noise_offset=jnp.asarray(off),
                            noise_buf=jnp.asarray(buf))
    with torch.no_grad():
        wav_t, src_t = tm(_t(mel), _t(cache), noise_offset=off, noise_buf=_t(buf))
        wav_plain, _ = tm(_t(mel))  # the fixed rng(1) noise
    wav_plain_j, _ = jm.apply({"params": jp}, jnp.asarray(mel))
    np.testing.assert_allclose(src_t.numpy(), np.asarray(src_j), rtol=0, atol=1e-4)
    assert wav_t.shape == wav_j.shape == (1, 20 * hop)
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(wav_plain.numpy(), np.asarray(wav_plain_j), rtol=0, atol=1e-3)
    assert np.abs(np.asarray(wav_j)).max() > 1e-2


def test_nsf_gauss_bit_equal():
    np.testing.assert_array_equal(thift.nsf_gauss_noise(1000, 9), jhift.nsf_gauss_noise(1000, 9))
    np.testing.assert_array_equal(thift.nsf_gauss_buffer.__wrapped__(9, 4800), jhift.nsf_gauss_buffer.__wrapped__(9, 4800))
    np.testing.assert_array_equal(thift.nsf_gauss_buffer.__wrapped__(9, 4800)[:, :1000], thift.nsf_gauss_noise(1000, 9))


# ---------------------------------------------------------------- small helpers


@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_linear(scale):
    x = np.random.default_rng(12).standard_normal((2, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(tconvs.upsample_linear(_t(x), scale).numpy(),
                               np.asarray(jconvs.upsample_linear(jnp.asarray(x), scale)), rtol=0, atol=1e-6)
    ref = torch.nn.functional.interpolate(_t(x).transpose(1, 2), scale_factor=scale, mode="linear").transpose(1, 2)
    np.testing.assert_allclose(tconvs.upsample_linear(_t(x), scale).numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_fade_in_out():
    rng = np.random.default_rng(13)
    a, b = rng.standard_normal((3, 40)), rng.standard_normal((3, 40))
    w = np.hamming(20)
    np.testing.assert_array_equal(tcommon.fade_in_out(a, b, w), jcommon.fade_in_out(a, b, w))
