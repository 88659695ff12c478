"""The CosyVoice2 family of fangyan_tts_torch against the JAX package with
the same weights (models/from_jax.py), float32 models on the CPU, greedy
sampling (top_k 1; tests/torch_port_util.py):
- Qwen2LMV2: prefill and teacher-forced decode logits (float32 cache) rel
  <= 2e-4 with equal argmax; remap_plan_v2 plans equal;
- the v2 flow mel, offline and a streaming hop, within 1e-3;
- CosyVoice2TTS.tts(stream=False): greedy tokens equal, wav within 1e-3;
- tts(stream=True): the same chunk count and lengths as the JAX stream,
  each chunk within 1e-3 (25-token hops, a prompt that is not a whole hop);
- a bistream text generator with the v2 ids: tokens equal;
- the v2 LLMScheduler route: each row equal to its solo decode and to the
  JAX package's, with no silent-run suppression;
- on CUDA, any dtype but bf16 refused.
Both packages decode with a bfloat16 KV cache, so a greedy step whose top
two logits are closer than about 2e-2 may fall either way; the texts and
weights here meet no such near-tie."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fangyan_tts_torch.config as tcfg
import fangyan_tts_tpu.config as jcfg
from fangyan_tts_torch.data import lm_plan as tplan
from fangyan_tts_torch.infer import bistream as tbi
from fangyan_tts_torch.infer.tts_v12 import CosyVoice2TTS as TorchTTS
from fangyan_tts_torch.models import from_jax as fj
from fangyan_tts_torch.models import qwen2 as tq
from fangyan_tts_tpu.data import lm_plan as jplan
from fangyan_tts_tpu.infer import bistream as jbi
from fangyan_tts_tpu.infer.tts_v12 import CosyVoice2TTS as JaxTTS
from fangyan_tts_tpu.models import qwen2 as jq
from fangyan_tts_tpu.models.flow_xvec import CausalMaskedDiffWithXvec
from fangyan_tts_tpu.models.hift import HiFT
from fangyan_tts_tpu.models.llm import Qwen2LMV2
from torch_port_util import GREEDY, QWEN, np_params, to_jax

FLOW_KW = dict(vocab_size=50, input_size=32, decoder_channels=(16,), num_mid_blocks=1, n_blocks=1, num_heads=2,
               attention_head_dim=8, enc_heads=2, enc_ffn=24, enc_blocks=1, enc_up_blocks=1, n_timesteps=2)
HIFT_KW = dict(base_channels=32, f0_cond_channels=16)
WAV_ATOL = 1e-3
TEXT = np.asarray([17, 3, 250, 41, 9, 120], np.int32)
PROMPT_TEXT = np.asarray([5, 77, 201], np.int32)


def _llm_cfg(mod):
    return replace(mod.LLMConfig(speech_token_size=50, extra_tokens=3, llm_input_size=64, llm_output_size=64,
                                 qwen=mod.QwenConfig(**QWEN)), **GREEDY)


JLLM, TLLM = _llm_cfg(jcfg), _llm_cfg(tcfg)


@pytest.fixture(scope="module")
def pair():
    t = jnp.zeros((1, 8), jnp.int32)
    llm_p = np_params(Qwen2LMV2(JLLM), 0, t, t, jnp.asarray([8]), t, gain=1.0)
    flow = CausalMaskedDiffWithXvec(**FLOW_KW)
    flow_p = np_params(flow, 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]), jnp.zeros((1, 192)),
                       jnp.zeros((2,), jnp.uint32), gain=0.7)
    jh, th = jcfg.HiFTConfig(**HIFT_KW), tcfg.HiFTConfig(**HIFT_KW)
    hift_p = np_params(HiFT(jh), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift_p["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced
    jtts = JaxTTS(JLLM, to_jax(llm_p), flow, to_jax(flow_p), jh, to_jax(hift_p), dtype=jnp.float32)
    ttts = TorchTTS(TLLM, fj.llm_v2_from_jax(llm_p, TLLM), FLOW_KW, fj.flow_v2_from_jax(flow_p, **FLOW_KW), th,
                    fj.hift_nc_from_jax(hift_p, th), dtype=torch.float32, device="cpu")
    return jtts, ttts


def _prompt(n_tok: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, n_tok).astype(np.int32), (rng.standard_normal((2 * n_tok, 80)) * 0.5).astype(np.float32),
            rng.standard_normal(192).astype(np.float32))


# ---------------------------------------------------------------- LM


def test_remap_plan_v2_equal():
    rng = np.random.default_rng(4)
    for n_text, n_speech in ((7, 0), (12, 9)):
        text, speech = rng.integers(0, 300, n_text).tolist(), rng.integers(0, 50, n_speech).tolist()
        want = jplan.remap_plan_v2(JLLM, jplan.build_prompt_plan(JLLM, text, speech))
        got = tplan.remap_plan_v2(TLLM, tplan.build_prompt_plan(TLLM, text, speech))
        for k in ("src", "ids", "targets"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert (got.src == 2).sum() == 2  # sos and task in the 2-row table


def test_qwen2lmv2_logits(pair):
    jtts, ttts = pair
    jm, jp, tm = jtts.llm, jtts.llm_params, ttts.llm
    plans = [jplan.remap_plan_v2(JLLM, jplan.build_prompt_plan(JLLM, list(range(3, 3 + n)), list(range(m))))
             for n, m in ((9, 4), (5, 0))]
    tp, cache_len = 16, 24
    batch = jplan.pad_plans_left(plans, length=tp)
    src, ids, lens = (batch[k] for k in ("src", "ids", "lengths"))
    bound = jm.bind({"params": jp})
    cache = jq.init_cache(JLLM.qwen, 2, cache_len, dtype=jnp.float32)
    h, cache = bound.prefill_leftpad(jnp.asarray(src), jnp.asarray(ids), jnp.asarray(lens), cache)
    jl = [np.asarray(bound.llm_decoder(h))]
    tcache = tq.init_cache(TLLM.qwen, 2, cache_len, dtype=torch.float32)
    with torch.no_grad():
        tl = [tm.decode_logits(tm.prefill_leftpad(*map(torch.from_numpy, (src, ids, lens)), tcache)).numpy()]
        start = (tp - lens).astype(np.int32)
        for i, tok in enumerate((7, 21, 49)):
            tok_b = np.asarray([tok, (tok * 3) % 50], np.int32)
            pos = (lens + i)[:, None].astype(np.int32)
            lg, cache = bound.decode_step(jnp.asarray(tok_b), jnp.asarray(pos), jnp.asarray(start), tp + i + 1, cache)
            jl.append(np.asarray(lg))
            tl.append(tm.decode_step(*map(torch.from_numpy, (tok_b, pos, start)), tp + i + 1, tcache).numpy())
    for got, want in zip(tl, jl):
        assert got.shape == want.shape == (2, 53)
        assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------- flow


@pytest.mark.parametrize("finalize", [True, False])
def test_v2_flow_mel(pair, finalize):
    jtts, ttts = pair
    ptok, pfeat, emb = _prompt(7)
    tokens = np.random.default_rng(5).integers(0, 50, 53).astype(np.int32)
    kw = dict(token_offset=25 if not finalize else 0, streaming=not finalize, finalize=finalize)
    want = jtts.token2mel(tokens, ptok, pfeat, emb, **kw)
    got = ttts.token2mel(tokens, ptok, pfeat, emb, **kw)
    assert got.shape == want.shape == ((53 - 25 - 3) * 2 if not finalize else 106, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)


# ---------------------------------------------------------------- tts


def test_v2_tts_offline(pair):
    jtts, ttts = pair
    ptok, pfeat, emb = _prompt(9)
    want_tok = jtts.generate_tokens(TEXT, PROMPT_TEXT, ptok)
    got_tok = ttts.generate_tokens(TEXT, PROMPT_TEXT, ptok)
    np.testing.assert_array_equal(got_tok, want_tok)
    assert len(want_tok) >= 2 * len(TEXT)
    kw = dict(text=TEXT, flow_embedding=emb, prompt_text=PROMPT_TEXT, llm_prompt_speech_token=ptok,
              flow_prompt_speech_token=ptok, prompt_speech_feat=pfeat)
    (want,), (got,) = list(jtts.tts(**kw)), list(ttts.tts(**kw))
    assert got["tts_speech"].shape == want["tts_speech"].shape == (len(want_tok) * 2 * 480,)
    np.testing.assert_allclose(got["tts_speech"], want["tts_speech"], rtol=0, atol=WAV_ATOL)
    assert np.abs(want["tts_speech"]).max() > 1e-2


@pytest.mark.parametrize("route", ["llm", "vc"])
def test_v2_tts_stream(pair, route):
    jtts, ttts = pair
    ptok, pfeat, emb = _prompt(9)
    kw = dict(flow_embedding=emb, flow_prompt_speech_token=ptok, prompt_speech_feat=pfeat, stream=True)
    if route == "llm":
        kw.update(text=TEXT, prompt_text=PROMPT_TEXT, llm_prompt_speech_token=ptok)
    else:
        kw.update(source_speech_token=np.random.default_rng(6).integers(0, 50, 83).astype(np.int32))
    want = [c["tts_speech"] for c in jtts.tts(**kw)]
    got = [c["tts_speech"] for c in ttts.tts(**kw)]
    assert [len(g) for g in got] == [len(w) for w in want]
    assert len(want) >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)


def test_v2_bistream_tokens(pair):
    jtts, ttts = pair
    ptok = _prompt(3, seed=16)[0]

    def chunks():
        yield TEXT[:4]
        yield TEXT[4:]
        yield np.asarray([66, 8, 131, 2], np.int32)

    want = list(jbi.inference_bistream(jtts.llm, jtts.llm_params, chunks(), PROMPT_TEXT, ptok, max_tokens=80))
    got = list(tbi.inference_bistream(ttts.llm, chunks(), PROMPT_TEXT, ptok, max_tokens=80))
    assert got == want
    assert len(want) > 10 and all(t < 50 for t in want)


def test_v2_llm_scheduler_rows(pair):
    """Three concurrent decodes through a width-4 v2 LLMScheduler: each row
    equals the port's solo streaming decode and the JAX package's, with no
    silent-run suppression (the v3 silent ids are ordinary tokens here)."""
    jtts, ttts = pair
    texts = [TEXT, np.asarray([9, 9, 31, 4, 250], np.int32), np.asarray([100, 22, 31], np.int32)]
    solo = [np.concatenate(list(ttts._stream_tokens(t, PROMPT_TEXT, np.zeros(0, np.int32)))) for t in texts]
    jsolo = [np.concatenate(list(jtts._stream_tokens(t, PROMPT_TEXT, np.zeros(0, np.int32)))) for t in texts]
    ttts.enable_batched_llm(4)
    try:
        sched = ttts.llm_scheduler
        assert sched.silent_tokens == ()
        hs = [sched.open(t, PROMPT_TEXT) for t in texts]
        rows = [np.concatenate(list(sched.stream(h))) for h in hs]
    finally:
        ttts.llm_scheduler = None
    for r, s, j in zip(rows, solo, jsolo):
        np.testing.assert_array_equal(r, s)
        np.testing.assert_array_equal(r, j)
    assert sched.stats["rows"] > sched.stats["steps"]  # rows shared chunks


def test_v2_cuda_refuses_other_dtypes(monkeypatch):
    """On CUDA the v2 family runs bf16 only (its decode runs the
    decode-attention kernel, which takes bf16): any other dtype raises
    before a model is built."""
    from fangyan_tts_torch.infer import tts_v12

    monkeypatch.setattr(tts_v12, "resolve_device", lambda d: torch.device("cuda"))
    th = tcfg.HiFTConfig(**HIFT_KW)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="bfloat16"):
            TorchTTS(TLLM, {}, FLOW_KW, {}, th, {}, dtype=dtype)
