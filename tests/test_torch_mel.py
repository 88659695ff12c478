"""The port's mel frontends, filterbanks, windows and audio I/O against the
JAX package's: matcha_mel, whisper_logmel and kaldi_fbank within 1e-4 on the
same audio (lengths that are and are not a multiple of the hop, and a
zero-padded bucket, whose whisper floor comes from the whole padded row);
the filterbanks, the povey window and resample_poly equal to numpy
precision; a wav written by either package reads the same in both."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_port_util  # noqa: F401  (one torch CPU thread per worker)
from fangyan_tts_torch.data import audio as taudio
from fangyan_tts_torch.ops import mel as tmel
from fangyan_tts_torch.ops import stft as tstft
from fangyan_tts_tpu.data import audio as jaudio
from fangyan_tts_tpu.ops import mel as jmel
from fangyan_tts_tpu.ops import stft as jstft

MEL_ATOL = 1e-4


def _kaldi_fbank_f64(y: np.ndarray) -> np.ndarray:
    """kaldi_fbank in float64 numpy (np.fft), the arbiter described above."""
    y = y.astype(np.float64)
    n_frames = 1 + (y.shape[1] - 400) // 160
    fr = np.stack([y[:, i * 160 : i * 160 + 400] for i in range(n_frames)], 1)
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[..., :1], fr[..., :-1]], -1)
    fr = np.pad(fr * jstft.povey_window(400).astype(np.float64), ((0, 0), (0, 0), (0, 112)))
    power = np.abs(np.fft.rfft(fr, axis=-1)) ** 2
    mel = np.einsum("mk,bfk->bfm", jmel.mel_filterbank_kaldi(16000, 512, 80).astype(np.float64), power[..., :-1])
    return np.log(np.maximum(mel, np.finfo(np.float32).eps))


def _assert_mel_close(got, want, ref64=None):
    """Within MEL_ATOL of the JAX value; with a float64 reference, an element
    outside it must be within MEL_ATOL of the reference and at least as
    close to it as the JAX value."""
    far = np.abs(got - want) > MEL_ATOL
    if ref64 is None or not far.any():
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)
        return
    assert far.mean() < 1e-3, f"{far.sum()} of {far.size} bins differ by more than {MEL_ATOL}"
    err_port, err_jax = np.abs(got - ref64)[far], np.abs(want - ref64)[far]
    assert (err_port <= MEL_ATOL).all() and (err_port <= err_jax).all(), (err_port, err_jax)


def _audio(n: int, seed: int, pad_to: int | None = None) -> np.ndarray:
    """Two rows of band-limited noise plus a tone, at a speech-like level;
    with pad_to, zero-padded to that length (a prompt bucket)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.1 * rng.standard_normal((2, n)) + 0.3 * np.sin(2 * np.pi * 220.0 * t)[None]
    x = x.astype(np.float32)
    if pad_to is not None:
        x = np.pad(x, ((0, 0), (0, pad_to - n)))
    return x


def _both(jfn, tfn, x, **kw):
    want = np.asarray(jfn(jnp.asarray(x), **kw))
    got = tfn(torch.from_numpy(x), **kw).numpy()
    return got, want


@pytest.mark.parametrize("n, pad_to", [(4800, None), (5000, None), (7919, None), (6000, 16000)])
def test_matcha_mel(n, pad_to):
    x = _audio(n, 1, pad_to)
    got, want = _both(jmel.matcha_mel, tmel.matcha_mel, x)
    assert got.shape == want.shape == (2, 80, x.shape[1] // 480)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


@pytest.mark.parametrize("n, pad_to", [(3200, None), (3201, None), (5555, None), (9000, 48000)])
def test_whisper_logmel(n, pad_to):
    x = _audio(n, 2, pad_to)
    got, want = _both(jmel.whisper_logmel, tmel.whisper_logmel, x)
    assert got.shape == want.shape == (2, 128, x.shape[1] // 160)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)
    if pad_to is not None:  # the padded tail sits on the row's floor, max - 8 (max - 2 after (x + 4) / 4)
        np.testing.assert_allclose(got[:, :, -1], np.broadcast_to(want.max(axis=(1, 2))[:, None] - 2.0, (2, 128)),
                                   atol=MEL_ATOL)


@pytest.mark.parametrize("n, pad_to", [(4000, None), (4321, None), (7000, 16000)])
def test_kaldi_fbank(n, pad_to):
    x = _audio(n, 3, pad_to)
    ref64 = _kaldi_fbank_f64(x)
    got, want = _both(jmel.kaldi_fbank, tmel.kaldi_fbank, x)
    assert got.shape == want.shape == ref64.shape == (2, (x.shape[1] - 400) // 160 + 1, 80)
    _assert_mel_close(got, want, ref64)
    got, want = _both(jmel.kaldi_fbank, tmel.kaldi_fbank, x, subtract_mean=True)
    _assert_mel_close(got, want, ref64 - ref64.mean(axis=1, keepdims=True))


@pytest.mark.parametrize("args", [(24000, 1920, 80), (16000, 400, 128), (22050, 1024, 80, 0.0, 8000.0)])
def test_slaney_filterbank_equal(args):
    np.testing.assert_array_equal(tmel.mel_filterbank_slaney(*args), jmel.mel_filterbank_slaney(*args))


@pytest.mark.parametrize("args", [(16000, 512, 80), (16000, 512, 80, 20.0, -400.0), (8000, 256, 40)])
def test_kaldi_filterbank_equal(args):
    np.testing.assert_array_equal(tmel.mel_filterbank_kaldi(*args), jmel.mel_filterbank_kaldi(*args))


@pytest.mark.parametrize("n", [400, 25])
def test_povey_window_and_magnitude(n):
    np.testing.assert_array_equal(tstft.povey_window(n), jstft.povey_window(n))
    rng = np.random.default_rng(n)
    re, im = rng.standard_normal((2, 3, n)).astype(np.float32)
    got = tstft.magnitude(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    np.testing.assert_allclose(got, np.asarray(jstft.magnitude(jnp.asarray(re), jnp.asarray(im))), rtol=1e-6)


@pytest.mark.parametrize("orig, target", [(24000, 16000), (16000, 24000), (22050, 16000), (16000, 16000)])
def test_resample_poly_equal(orig, target):
    x = _audio(orig // 2 + 7, 4)[0]
    got, want = taudio.resample_poly(x, orig, target), jaudio.resample_poly(x, orig, target)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudio._resample_filter(3, 2), jaudio._resample_filter(3, 2))


def test_wav_round_trip(tmp_path):
    x = np.clip(_audio(12345, 5)[0], -1, 1)
    for writer, name in ((taudio.write_wav, "port.wav"), (jaudio.write_wav, "jax.wav")):
        writer(tmp_path / name, x, 24000)
        (a, sr_a), (b, sr_b) = taudio.read_wav(tmp_path / name), jaudio.read_wav(tmp_path / name)
        assert sr_a == sr_b == 24000 and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, x, atol=2 / 32768)  # written x 32767, read / 32768
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    (a, _), (b, _) = (m.load_audio(tmp_path / "port.wav", target_sr=16000) for m in (taudio, jaudio))
    np.testing.assert_array_equal(a, b)
