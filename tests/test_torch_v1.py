"""The CosyVoice1 family of fangyan_tts_torch against the JAX package with
the same weights (models/from_jax.py), float32 on the CPU:
- TransformerLM teacher-forced logits rel <= 2e-4 with equal argmax;
- v1_generate_cached tokens equal to the JAX package's and to the port's
  own prefix-recompute v1_generate (greedy: top_k 1 on both sides);
- the v1 flow mel over two chunks with the z / mu cache, within 1e-3;
- CosyVoiceV1TTS offline (LLM and vc routes) and streamed (growing hops,
  the 34-frame mel fades, the z / mu cache, the HiFT source / speech
  cache): the same chunks, each within 1e-3.
The v1 flow draws its CFM noise from a PRNG key in the JAX package and a
torch.Generator in the port; here both take the same numpy noise for each
flow call (`_noise`), and both samplers are greedy."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fangyan_tts_torch.config as tcfg
import fangyan_tts_tpu.config as jcfg
from fangyan_tts_torch.infer.tts_v12 import CosyVoiceV1TTS as TorchTTS
from fangyan_tts_torch.models import from_jax as fj
from fangyan_tts_torch.models import llm_v1 as tv1
from fangyan_tts_torch.models import llm_v1_decode as tv1d
from fangyan_tts_tpu.infer import tts_v12 as jt
from fangyan_tts_tpu.models import llm_v1 as jv1
from fangyan_tts_tpu.models import llm_v1_decode as jv1d
from fangyan_tts_tpu.models.flow_xvec import MaskedDiffWithXvec
from fangyan_tts_tpu.models.hift import HiFT
from fangyan_tts_tpu.ops.sampling import ras_sample
from torch_port_util import GREEDY, np_params, to_jax

LLM_KW = dict(text_token_size=60, speech_token_size=50, text_encoder_input_size=16, llm_input_size=32,
              llm_output_size=32, text_enc_blocks=1, llm_blocks=2, heads=2, ffn=24)
FLOW_KW = dict(vocab_size=50, input_size=32, decoder_channels=(16, 16), num_mid_blocks=1, n_blocks=1, num_heads=2,
               attention_head_dim=8, enc_heads=2, enc_ffn=24, enc_blocks=1, n_timesteps=2)
HIFT_KW = dict(sampling_rate=22050, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
               source_resblock_kernel_sizes=(7, 11), source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
               base_channels=32, f0_cond_channels=16)
WAV_ATOL = 1e-3
TEXT = np.asarray([7, 31, 2, 55, 18, 40], np.int32)


def _noise(out_len: int) -> np.ndarray:
    """The CFM noise both sides take for a flow call of out_len frames."""
    return np.random.default_rng(out_len).standard_normal((1, out_len, 80)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The JAX and port TTS with the same weights; both samplers greedy and
    both flows on _noise for the module's tests."""
    t = jnp.zeros((1, 8), jnp.int32)
    llm = jv1.TransformerLM(**LLM_KW)
    llm_p = np_params(llm, 0, t, jnp.asarray([8]), t, jnp.asarray([8]), jnp.zeros((1, 192)), gain=1.0)
    flow = MaskedDiffWithXvec(**FLOW_KW)
    flow_p = np_params(flow, 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]), jnp.zeros((1, 192)),
                       jnp.zeros((2,), jnp.uint32), gain=0.7)
    jh, th = jcfg.HiFTConfig(**HIFT_KW), tcfg.HiFTConfig(**HIFT_KW)
    hift_p = np_params(HiFT(jh), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift_p["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced
    orig_flow = jt.xvec_flow_inference_v1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv1d, "ras_sample", partial(ras_sample, **GREEDY))
        mp.setattr(jv1, "ras_sample", partial(ras_sample, **GREEDY))
        mp.setattr(jt, "xvec_flow_inference_v1",
                   lambda *a, **kw: orig_flow(*a, noise=jnp.asarray(_noise(kw["out_len"])), **kw))
        for k, v in GREEDY.items():
            mp.setitem(tv1.V1_SAMPLING, k, v)
        jtts = jt.CosyVoiceV1TTS(llm, to_jax(llm_p), flow, to_jax(flow_p), jh, to_jax(hift_p))
        ttts = TorchTTS(LLM_KW, fj.llm_v1_from_jax(llm_p, **LLM_KW), FLOW_KW, fj.flow_v1_from_jax(flow_p, **FLOW_KW),
                        th, fj.hift_nc_from_jax(hift_p, th), device="cpu")
        ttts._flow_noise = lambda out_len: torch.from_numpy(_noise(out_len))
        yield jtts, ttts


def _prompt(n_tok: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    n_mel = int(n_tok / 50 * 22050 / 256)
    return (rng.integers(0, 50, n_tok).astype(np.int32), (rng.standard_normal((n_mel, 80)) * 0.5).astype(np.float32),
            rng.standard_normal(192).astype(np.float32))


def test_transformer_lm_logits(pair):
    jtts, ttts = pair
    rng = np.random.default_rng(4)
    text = rng.integers(0, 60, (2, 9)).astype(np.int32)
    speech = rng.integers(0, 50, (2, 12)).astype(np.int32)
    tlen, slen = np.asarray([9, 6], np.int32), np.asarray([12, 7], np.int32)
    emb = rng.standard_normal((2, 192)).astype(np.float32)
    bound = jtts.llm.bind({"params": jtts.llm_params})
    te = bound.encode_text(jnp.asarray(text), jnp.asarray(tlen))
    lm_in, lm_len = bound.build_lm_input(te, jnp.asarray(tlen), jnp.asarray(speech), jnp.asarray(slen),
                                         jnp.asarray(emb))
    h, _ = bound.llm(lm_in, lm_len, streaming=True, static_chunk_size=1)
    want = np.asarray(bound.llm_decoder(h))
    with torch.no_grad():
        got = ttts.llm.logits(*map(torch.from_numpy, (text, tlen, speech, slen, emb))).numpy()
    assert got.shape == want.shape == (2, 2 + 9 + 1 + 12, 51)
    for b in range(2):
        n = 3 + tlen[b] + slen[b]
        g, w = got[b, :n], want[b, :n]
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("n_prompt", [0, 11])
def test_v1_generate_cached(pair, n_prompt):
    jtts, ttts = pair
    ptok, _, emb = _prompt(n_prompt)
    full = np.concatenate([TEXT[:2], TEXT])
    want = np.concatenate(list(jv1d.v1_generate_cached(jtts.llm, jtts.llm_params, full, emb, ptok,
                                                       prompt_text_len=2)))
    got = np.concatenate(list(tv1d.v1_generate_cached(ttts.llm, full, emb, ptok, prompt_text_len=2)))
    recompute = tv1.v1_generate(ttts.llm, full, emb, ptok, prompt_text_len=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(recompute, got)
    assert 2 * len(TEXT) <= len(want) <= 20 * len(TEXT)


def test_v1_flow_two_chunks(pair):
    """Two chunks through the z / mu cache, as a stream runs them."""
    jtts, ttts = pair
    ptok, pfeat, emb = _prompt(10)
    tokens = np.random.default_rng(5).integers(0, 50, 180).astype(np.int32)
    sessions = ({}, {})
    for chunk in (tokens[:120], tokens[100:]):
        want = jtts.token2mel(chunk, ptok, pfeat, emb, sessions[0], finalize=False)
        got = ttts.token2mel(chunk, ptok, pfeat, emb, sessions[1])
        assert got.shape == want.shape == (int(len(chunk) / 50 * 22050 / 256), 80)
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)
        np.testing.assert_allclose(sessions[1]["flow"].numpy(), np.asarray(sessions[0]["flow"]), rtol=0,
                                   atol=WAV_ATOL)


@pytest.mark.parametrize("route", ["llm", "vc"])
def test_v1_tts_offline(pair, route):
    jtts, ttts = pair
    ptok, pfeat, emb = _prompt(10)
    kw = dict(flow_embedding=emb, llm_embedding=emb, flow_prompt_speech_token=ptok, prompt_speech_feat=pfeat)
    if route == "llm":
        kw.update(text=TEXT, prompt_text=TEXT[:2], llm_prompt_speech_token=ptok)
    else:
        kw.update(source_speech_token=np.random.default_rng(6).integers(0, 50, 90).astype(np.int32))
    (want,), (got,) = list(jtts.tts(**kw)), list(ttts.tts(**kw))
    assert got["tts_speech"].shape == want["tts_speech"].shape
    assert len(want["tts_speech"]) > 10 * 256
    np.testing.assert_allclose(got["tts_speech"], want["tts_speech"], rtol=0, atol=WAV_ATOL)
    assert np.abs(want["tts_speech"]).max() > 1e-2


def test_v1_tts_stream(pair):
    """260 source tokens: two 120-token chunks (100-token hops, a 20-token
    overlap), then the final one; every join faded."""
    jtts, ttts = pair
    ptok, pfeat, emb = _prompt(10)
    kw = dict(flow_embedding=emb, flow_prompt_speech_token=ptok, prompt_speech_feat=pfeat, stream=True,
              source_speech_token=np.random.default_rng(7).integers(0, 50, 260).astype(np.int32))
    want = [c["tts_speech"] for c in jtts.tts(**kw)]
    got = [c["tts_speech"] for c in ttts.tts(**kw)]
    assert [len(g) for g in got] == [len(w) for w in want]
    assert len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)
