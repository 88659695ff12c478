"""The two-process token2wav split of fangyan_tts_torch against the JAX
package's, on the CPU, over real HTTP on 127.0.0.1: each package's
token2wav + ASR server (`serve`, port 0, the echo ASR) and its
`RemoteToken2Wav` client, on TTS objects with the same float32 weights
(models/from_jax.py) and a DiT whose static chunk is the streaming hop
(tests/test_torch_stream.py's setup, at a window of 50 tokens so that the
stream crosses it):

- a RemoteToken2Wav stream of 130 tokens in pushes of 40 (the case of
  tests/test_disaggregated.py::test_remote_token2wav_stream): the port's
  chunks have the JAX package's lengths and lie within 1e-3 of them, and
  equal the port's in-process Token2WavSession on the same pushes;
- /score and /token2wav: the same hyp and reward, WAVs within 1e-3;
- `tts_stream_remote`: the port's local decode streamed to its server gives
  the audio of the port's own tts(stream=True).
"""

import io
import json
import urllib.request
import wave
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer.stream import Token2WavSession
from fangyan_tts_torch.infer.tts import CosyVoice3TTS as TorchTTS
from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
from fangyan_tts_torch.runtime import disaggregated as tdis
from fangyan_tts_torch.runtime import token2wav_asr_server as tsrv
from fangyan_tts_tpu.infer.tts import CosyVoice3TTS as JaxTTS
from fangyan_tts_tpu.models import llm as jllm
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from fangyan_tts_tpu.runtime import disaggregated as jdis
from fangyan_tts_tpu.runtime import token2wav_asr_server as jsrv
from torch_port_util import both, np_params, to_jax

JC, TC = (replace(c, flow=replace(c.flow, dit=replace(c.flow.dit, static_chunk_size=50)),
                  hift=replace(c.hift, stream_noise_seconds=10)) for c in both())
ATOL = 1e-3
N_TOK, PUSH = 130, 40


@pytest.fixture(scope="module")
def servers():
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(jllm.CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=2.0)
    flow = np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                     jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced frames
    jtts = JaxTTS(JC, to_jax(llm), to_jax(flow), to_jax(hift), dtype=jnp.float32)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        tts.stream_window_tokens = 50
    echo = lambda wav, sr: ""  # noqa: E731
    jh = jsrv.serve(jtts, asr_fn=echo, port=0)
    th = tsrv.serve(ttts, asr_fn=tsrv.make_asr_fn("echo"), port=0, host="127.0.0.1")
    try:
        yield {"jax": (jtts, f"http://127.0.0.1:{jh.server_address[1]}"),
               "port": (ttts, f"http://127.0.0.1:{th.server_address[1]}")}
    finally:
        for h in (jh, th):
            h.shutdown()
            h.server_close()


def _request():
    rng = np.random.default_rng(1)
    return (rng.integers(0, 50, size=N_TOK).astype(np.int32), np.zeros(0, np.int32), np.zeros((0, 80), np.float32),
            rng.standard_normal(192).astype(np.float32))


def test_remote_stream(servers):
    tokens, ptok, pfeat, emb = _request()
    pushes = lambda: (tokens[i : i + PUSH] for i in range(0, N_TOK, PUSH))  # noqa: E731
    want = list(jdis.RemoteToken2Wav(servers["jax"][1]).stream(pushes(), ptok, pfeat, emb))
    got = list(tdis.RemoteToken2Wav(servers["port"][1]).stream(pushes(), ptok, pfeat, emb))
    assert [len(g) for g in got] == [len(w) for w in want] and len(got) >= 3
    assert sum(len(g) for g in got) == N_TOK * 2 * 480
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert max(np.abs(w).max() for w in want if len(w)) > 1e-2
    # the server's session is the port's in-process one
    sess = Token2WavSession(servers["port"][0], ptok, pfeat, emb)
    with torch.inference_mode():
        solo = [c for p in pushes() for c in sess.push(p)] + [sess.finish()]
    assert [len(s) for s in solo] == [len(g) for g in got]
    for s, g in zip(solo, got):
        np.testing.assert_allclose(g, s, rtol=0, atol=1e-6)


def _post(url: str, payload: dict) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _pcm(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data), "rb") as w:
        assert w.getframerate() == 24000
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0


def test_score_and_token2wav(servers):
    tokens, _, _, emb = _request()
    payload = {"tokens": tokens[:60].tolist(), "embedding": emb.tolist(), "text": "你好世界"}
    want = json.loads(_post(servers["jax"][1] + "/score", payload))
    got = json.loads(_post(servers["port"][1] + "/score", payload))
    assert got == want == {"text": "", "reward": -1.0}
    wj = _pcm(_post(servers["jax"][1] + "/token2wav", payload))
    wt = _pcm(_post(servers["port"][1] + "/token2wav", payload))
    assert wt.shape == wj.shape == (60 * 2 * 480,)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=ATOL)
    with pytest.raises(urllib.error.HTTPError):
        _post(servers["port"][1] + "/nope", {})


def test_tts_stream_remote(servers):
    """The local decode streamed to the port's server against the port's
    own tts(stream=True) on the same request (one generator seed)."""
    ttts, url = servers["port"]
    rng = np.random.default_rng(1)
    text = rng.integers(0, 300, 3).astype(np.int32)
    ttts.generator.manual_seed(3)
    got = [c["tts_speech"] for c in tdis.tts_stream_remote(ttts, tdis.RemoteToken2Wav(url), text)]
    ttts.generator.manual_seed(3)
    want = [np.asarray(c["tts_speech"]) for c in ttts.tts(text=text, stream=True)]
    assert sum(len(g) for g in got) == sum(len(w) for w in want) >= 4 * 960
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=1e-6)
