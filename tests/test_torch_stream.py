"""Streaming synthesis, `CosyVoice3TTS.tts(stream=True)`, and the bistream
text route of fangyan_tts_torch against the JAX package, float32 on the
CPU, with the same weights (models/from_jax.py), greedy sampling and a DiT
whose static chunk is the streaming hop:

- the resumable decode (`decode_prefill` + `decode_chunk`) gives the JAX
  package's tokens and the port's own `generate_speech_tokens` tokens;
- tts(stream=True) on the vc route (no LLM) and on the LLM route: the same
  chunk count and chunk lengths as the JAX package's, each chunk within
  1e-3, across the window boundary (`stream_window_tokens` 50);
- the speculative first hop and the token prefetch thread change no bit
  of the audio; a rejected speculation replays to the same stream;
- bistream tokens equal the JAX package's, and tts with a text generator
  (stream False and True) agrees with the JAX package's.

Both packages run a decode step in the bfloat16 of their KV cache
whatever the model dtype, and round in different places: after one step
their logits differ by a few 1e-2 at LLM gain 2, so a greedy step whose two
best allowed logits are closer than that may fall either way
(tests/test_torch_api.py). With float32 caches the two decodes agree to
float32 rounding, and their tokens are equal on requests where the bf16
decodes part (test_decode_float32_cache, seeds 5 and 7). The bf16 requests
(`_requests`) were chosen as ones whose decodes meet no such tie: seed 1,
the first, for the plain request, and seed 12 for the prompted one, whose
seeds 5-7 part. The port's streamed tokens are held to its own offline
tokens on every request, where no tie can fall differently."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer import bistream as tbi
from fangyan_tts_torch.infer.stream import Token2WavSession
from fangyan_tts_torch.infer.tts import CosyVoice3TTS as TorchTTS
from fangyan_tts_torch.infer.tts import _TokenPrefetcher, stream_buckets
from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models import qwen2 as tq
from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
from fangyan_tts_torch.utils import profiling
from fangyan_tts_tpu.data.lm_plan import pad_plans_left
from fangyan_tts_tpu.infer import bistream as jbi
from fangyan_tts_tpu.infer.tts import CosyVoice3TTS as JaxTTS
from fangyan_tts_tpu.models import llm as jllm
from fangyan_tts_tpu.models import qwen2 as jq
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from torch_port_util import both, np_params, to_jax

JC, TC = (replace(c, flow=replace(c.flow, dit=replace(c.flow.dit, static_chunk_size=50)),
                  hift=replace(c.hift, stream_noise_seconds=10)) for c in both())
LLM_GAIN = 2.0
_jax_init_cache, _torch_init_cache = jq.init_cache, tq.init_cache
WINDOW = 50
ATOL = 1e-3


def _prompted(seed: int) -> tuple:
    """A prompted LLM request: text, prompt text, LLM prompt speech, min and
    max token/text ratios."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 300, 3).astype(np.int32), rng.integers(0, 300, 3).astype(np.int32),
            rng.integers(0, 50, 5).astype(np.int32), 10, 20)


def _requests() -> dict:
    """The LLM requests (see the module docstring for their seeds)."""
    rng = np.random.default_rng(1)
    plain = (rng.integers(0, 300, 3).astype(np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32), 20, 20)
    return {"plain": plain, "prompted": _prompted(12)}


@pytest.fixture(scope="module")
def pair():
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(jllm.CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=LLM_GAIN)
    flow = np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                     jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced frames
    jtts = JaxTTS(JC, to_jax(llm), to_jax(flow), to_jax(hift), dtype=jnp.float32)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        tts.stream_window_tokens = WINDOW
    return jtts, ttts


def _chunks(tts, **req) -> list[np.ndarray]:
    return [np.asarray(c["tts_speech"]) for c in tts.tts(stream=True, **req)]


def _same_stream(got: list, want: list, atol: float = ATOL) -> None:
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    assert max(np.abs(w).max() for w in want if len(w)) > 1e-2


def _decode_both(pair, req, jax_prefill=jllm.decode_prefill, logit_atol=None):
    """decode_prefill + decode_chunk (chunks of 16 steps, -1 where nothing
    was emitted) in both packages; with logit_atol, the next-token logits
    are held together after the prefill and every chunk. Returns the
    port's chunks, the JAX package's, and the buckets."""
    jtts, ttts = pair
    text, ptext, pspeech, lo, hi = req
    plan, tp, cache_len, min_len, max_len = stream_buckets(TC.llm, text, ptext, pspeech, lo, hi)
    b = pad_plans_left([plan], length=tp)
    js = jax_prefill(jtts.llm, jtts.llm_params, *(jnp.asarray(b[k]) for k in ("src", "ids", "lengths")),
                     jnp.asarray([min_len]), jnp.asarray([max_len]), jax.random.PRNGKey(0), cache_len=cache_len)
    ts = tllm.decode_prefill(ttts.llm, *(torch.from_numpy(b[k]) for k in ("src", "ids", "lengths")),
                             torch.tensor([min_len]), torch.tensor([max_len]), cache_len)
    want, got = [], []
    while True:
        if logit_atol is not None:
            np.testing.assert_allclose(ts.logits.float().numpy(), np.asarray(js.logits, np.float32), rtol=0,
                                       atol=logit_atol)
        if bool(ts.done.all()):
            break
        js, jc = jllm.decode_chunk(jtts.llm, jtts.llm_params, js, 16, tp)
        ts, tc = tllm.decode_chunk(ttts.llm, ts, 16, tp, ttts.generator)
        want.append(np.asarray(jc)[0])
        got.append(tc[0].numpy())
        assert bool(np.asarray(js.done).all()) == bool(ts.done.all()) and int(js.i) == ts.i
    return np.concatenate(got), np.concatenate(want), ts, (b, tp, cache_len, min_len, max_len)


@pytest.mark.parametrize("name", ["plain", "prompted"])
def test_decode_chunk_tokens(pair, name):
    """decode_prefill + decode_chunk: the JAX package's tokens, and the
    port's generate_speech_tokens."""
    _, ttts = pair
    got, want, ts, (b, tp, cache_len, min_len, max_len) = _decode_both(pair, _requests()[name])
    assert (tp, cache_len) == (64, 512)
    np.testing.assert_array_equal(got, want)
    tokens = got[got >= 0]
    assert len(tokens) >= min_len and ts.counts.item() == len(tokens)
    with torch.inference_mode():
        res = tllm.generate_speech_tokens(ttts.llm, *(torch.from_numpy(b[k]) for k in ("src", "ids", "lengths")),
                                          torch.tensor([min_len]), torch.tensor([max_len]), None,
                                          max_new_tokens=max(-(-max_len // 64) * 64, 64), cache_len=cache_len)
    np.testing.assert_array_equal(res.tokens[0, : int(res.num_tokens[0])].numpy(), tokens)


@pytest.mark.parametrize("seed", [5, 7])
def test_decode_float32_cache(pair, monkeypatch, seed):
    """Prompted requests whose bf16 decodes part between the packages: with
    float32 KV caches on both sides the decode runs in float32, the logits
    agree within 1e-4 after every chunk and the tokens are equal. (The JAX
    prefill runs unjitted, so that no bf16 trace of it is reused.)"""
    monkeypatch.setattr(jq, "init_cache", lambda cfg, b, n, dtype=None: _jax_init_cache(cfg, b, n, dtype=jnp.float32))
    monkeypatch.setattr(tq, "init_cache", lambda cfg, b, n, dtype=None, device=None:
                        _torch_init_cache(cfg, b, n, dtype=torch.float32, device=device))
    got, want, _, _ = _decode_both(pair, _prompted(seed), jax_prefill=jllm.decode_prefill.__wrapped__, logit_atol=1e-4)
    assert (got >= 0).sum() >= 20
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_prompt, n_tokens", [(0, 130), (7, 124)])
def test_tts_stream_vc(pair, n_prompt, n_tokens):
    """The vc route (source speech tokens, no LLM): young KV hops, window
    hops and a window finalize."""
    jtts, ttts = pair
    rng = np.random.default_rng(n_prompt)
    req = dict(source_speech_token=rng.integers(0, 50, n_tokens).astype(np.int32),
               flow_prompt_speech_token=rng.integers(0, 50, n_prompt).astype(np.int32),
               prompt_speech_feat=(rng.standard_normal((2 * n_prompt, 80)) * 0.5).astype(np.float32),
               flow_embedding=rng.standard_normal(192).astype(np.float32))
    got = _chunks(ttts, **req)
    _same_stream(got, _chunks(jtts, **req))
    assert sum(len(g) for g in got) == n_tokens * 2 * 480


def test_vocode_streaming_step(pair):
    """vocode(mel, finalize=False): a streaming step on the mel as it is,
    its last frames the lookahead, against the JAX package's."""
    jtts, ttts = pair
    mel = (np.random.default_rng(6).standard_normal((53, 80)) * 0.5).astype(np.float32)
    want = np.asarray(jtts.vocode(mel, finalize=False))
    got = ttts.vocode(mel, finalize=False)
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) >= 40 * 480
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 1e-2


def _llm_request(name: str) -> dict:
    text, ptext, pspeech, lo, hi = _requests()[name]
    rng = np.random.default_rng(5)
    n_prompt = 7 if name == "prompted" else 0
    return dict(text=text, prompt_text=ptext, llm_prompt_speech_token=pspeech,
                flow_prompt_speech_token=rng.integers(0, 50, n_prompt).astype(np.int32),
                prompt_speech_feat=(rng.standard_normal((2 * n_prompt, 80)) * 0.5).astype(np.float32),
                flow_embedding=rng.standard_normal(192).astype(np.float32),
                min_token_text_ratio=lo, max_token_text_ratio=hi)


@pytest.mark.parametrize("name", ["plain", "prompted"])
def test_tts_stream_llm(pair, name):
    """The LLM route: the streamed tokens are the port's offline tokens and
    the JAX package's; the chunks agree with the JAX package's."""
    jtts, ttts = pair
    req = _llm_request(name)
    args = (req["text"], req["prompt_text"], req["llm_prompt_speech_token"], req["min_token_text_ratio"],
            req["max_token_text_ratio"])
    streamed = np.concatenate(list(ttts._stream_tokens(*args[:3], min_token_text_ratio=args[3],
                                                       max_token_text_ratio=args[4])))
    np.testing.assert_array_equal(streamed, ttts.generate_tokens(*args))
    np.testing.assert_array_equal(streamed, jtts.generate_tokens(*args))
    got = _chunks(ttts, **req)
    _same_stream(got, _chunks(jtts, **req))
    assert sum(len(g) for g in got) == len(streamed) * 2 * 480


def test_speculation_and_prefetch_change_nothing(pair, monkeypatch):
    """The plain request (its first hop fits in the first decode chunk, so it
    is speculated, and the speculation holds): speculation off, prefetch off
    and both off give the same bits; the tracer's stream.* spans, recorded
    inside `recording()`, hold the per-hop budget."""
    _, ttts = pair
    req = _llm_request("plain")
    commits = []
    commit = Token2WavSession.commit_first
    monkeypatch.setattr(Token2WavSession, "commit_first", lambda self, toks: commits.append(1) or commit(self, toks))
    profiling.reset()
    try:
        with profiling.recording():
            ref = _chunks(ttts, **req)
        names = [s["name"] for s in profiling.spans() if s["name"].startswith("stream.")]
    finally:
        profiling.reset()
    assert commits == [1]
    assert len(ref) >= 3 and set(names) == {"stream.decode_wait", "stream.t2w_dispatch", "stream.fetch",
                                            "stream.finalize"}
    assert names.count("stream.fetch") == len(ref) and names.count("stream.finalize") == 1
    for spec_off, prefetch_off in ((True, False), (False, True), (True, True)):
        ttts.stream_no_speculation, ttts.stream_no_prefetch = spec_off, prefetch_off
        try:
            got = _chunks(ttts, **req)
        finally:
            ttts.stream_no_speculation = ttts.stream_no_prefetch = False
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_session_speculation_commit_and_reset(pair):
    """Token2WavSession: speculate_first + commit_first equals plain pushes;
    a speculation on tokens that suppression then changes, followed by
    reset(), equals a fresh session."""
    _, ttts = pair
    rng = np.random.default_rng(2)
    emb = rng.standard_normal(192).astype(np.float32)
    pf = np.zeros((0, 80), np.float32)
    tokens = rng.integers(0, 50, 64).astype(np.int32)

    def plain(toks):
        s = Token2WavSession(ttts, np.zeros(0, np.int32), pf, emb)
        out = s.push(toks[:32]) + s.push(toks[32:])
        return out + [s.finish()]

    s = Token2WavSession(ttts, np.zeros(0, np.int32), pf, emb)
    assert s.first_hop_tokens == 28
    spec = s.speculate_first(torch.from_numpy(tokens[:32]))
    assert spec is not None
    got = [np.asarray(spec)] + [a.numpy() for a in s.commit_first(tokens[:32])] + s.push(tokens[32:]) + [s.finish()]
    ref = plain(tokens)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

    changed = tokens.copy()
    changed[5] = (changed[5] + 1) % 50  # what suppression would hand over instead
    s = Token2WavSession(ttts, np.zeros(0, np.int32), pf, emb)
    assert s.speculate_first(torch.from_numpy(tokens[:32])) is not None
    s.reset()
    got = s.push(changed[:32]) + s.push(changed[32:]) + [s.finish()]
    ref = plain(changed)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    short = Token2WavSession(ttts, np.zeros(0, np.int32), pf, emb)
    assert short.speculate_first(torch.from_numpy(tokens[:20])) is None  # too few tokens for hop 1


def test_prefetcher_relays_errors_and_closes():
    def failing():
        yield np.arange(3)
        raise ValueError("decode failed")

    pf = _TokenPrefetcher(failing())
    assert list(next(pf)) == [0, 1, 2]
    with pytest.raises(ValueError, match="decode failed"):
        next(pf)
    pf.close()

    closed = []

    def endless():
        try:
            while True:
                yield np.zeros(1)
        finally:
            closed.append(torch.is_inference_mode_enabled())

    pf = _TokenPrefetcher(endless())
    next(pf)
    pf.release()
    next(pf)
    pf.close()
    assert not pf._thread.is_alive() and closed == [True]  # closed on the worker, in inference mode


def _text_chunks():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 300, 5).astype(np.int32) for _ in range(3)]


def test_bistream_tokens(pair):
    """The 5:15 protocol with prompt text and prompt speech: the JAX
    package's tokens, fill tokens included where they end a block."""
    jtts, ttts = pair
    ptext, pspeech = np.asarray([3, 4], np.int32), np.arange(7, 25, dtype=np.int32)
    want = list(jbi.inference_bistream(jtts.llm, jtts.llm_params, iter(_text_chunks()), prompt_text=ptext,
                                       prompt_speech=pspeech, key=jax.random.PRNGKey(0), cache_len=512,
                                       max_tokens=60))
    got = list(tbi.inference_bistream(ttts.llm, iter(_text_chunks()), ptext, pspeech, generator=ttts.generator,
                                      cache_len=512, max_tokens=60))
    assert len(want) >= 20
    assert got == want


@pytest.mark.parametrize("stream", [False, True])
def test_tts_text_generator(pair, stream):
    """tts with a text generator (bistream), offline and streaming: the JAX
    package's audio."""
    jtts, ttts = pair
    rng = np.random.default_rng(4)
    req = dict(flow_embedding=rng.standard_normal(192).astype(np.float32), stream=stream)
    want = [np.asarray(c["tts_speech"]) for c in jtts.tts(text=iter(_text_chunks()), **req)]
    got = [c["tts_speech"] for c in ttts.tts(text=iter(_text_chunks()), **req)]
    _same_stream(got, want)
    assert sum(len(w) for w in want) >= 50 * 480
