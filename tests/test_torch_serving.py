"""The serving runtimes of fangyan_tts_torch (runtime/), float32 on the CPU
with tiny models, as tests/test_serving.py and tests/test_disaggregated.py
hold the JAX package's:

- the stdlib HTTP server: its endpoints (inference_instruct raises, as in
  the JAX package, and answers 400), well-formed int16 PCM, 404 and 400;
  two concurrent streams over real sockets with both batching schedulers
  attached, which share batched steps and give the solo streams' samples;
  a request that fails before its first audio answers 500, one that fails
  while streaming is cut short at the client;
- a gRPC round trip (where grpc is installed);
- the dataset runners streaming_inference (equal and exponential chunk
  schedules) and offline_inference (batch_synthesize through the API, and
  a row with its own prompt through inference_zero_shot) on a tiny model
  directory that the test writes;
- DisaggregatedTTS in one process: the solo stream's audio.
"""

import http.client
import json
import threading
import urllib.error
import urllib.request
from dataclasses import replace

import numpy as np
import pytest
import torch

import fangyan_tts_torch.api as tapi
import fangyan_tts_torch.config as tcfg
from fangyan_tts_torch.infer import frontend as tfe
from fangyan_tts_torch.infer.tts import CosyVoice3TTS
from fangyan_tts_torch.models.campplus import CAMPPlus
from fangyan_tts_torch.models.from_jax import to_jax_tree
from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3
from fangyan_tts_torch.runtime import http_server
from fangyan_tts_torch.runtime.http_client import stream_request
from fangyan_tts_torch.tokenizer import ByteFallbackTokenizer
from fangyan_tts_torch.train.checkpoint import save_params
from torch_port_util import campplus_kwargs, configs, s3_kwargs

CFG = replace(configs(tcfg), flow=replace(configs(tcfg).flow, dit=replace(configs(tcfg).flow.dit, static_chunk_size=50)))
CAMP = dict(feat_dim=80, embedding_size=192, growth_rate=4, bn_size=4, init_channels=16, block_layers=(2, 2, 2))
S3 = dict(n_mels=128, n_state=32, n_head=4, n_layer=2, kernel_size=7)
VC = np.random.default_rng(3).integers(0, 50, 160).astype(np.int32)  # the dataset runner's tokens
RATIO = 10  # speech tokens a text id (greedy decode, min = max)


class TinyModel:
    """The API surface the servers call, on a tiny port model (greedy): sft
    decodes the text's byte ids, streamed when the server asks (as a
    batching server does)."""

    sample_rate = 24000
    inference_instruct = tapi.CosyVoice3.inference_instruct  # the real v3 method: it raises

    def __init__(self):
        self.tts = CosyVoice3TTS.random_init(CFG, dtype=torch.float32, device="cpu", seed=5)
        self.tts.stream_window_tokens = 50
        self.tokenizer = ByteFallbackTokenizer()
        self.fail_after = None  # chunks before a RuntimeError, to test failures

    def inference_sft(self, tts_text, spk_id, stream=False, **kw):
        gen = self.tts.tts(**self.request(tts_text), stream=stream)
        for i, out in enumerate(gen):
            if self.fail_after is not None and i >= self.fail_after:
                raise RuntimeError("kernel launch failed")
            yield out

    def request(self, tts_text: str) -> dict:
        return dict(text=np.asarray(self.tokenizer.encode(tts_text)[:12], np.int32),
                    flow_embedding=np.zeros(192, np.float32), min_token_text_ratio=RATIO, max_token_text_ratio=RATIO)

    def inference_zero_shot(self, tts_text, prompt_text, prompt_wav, **kw):
        yield from self.inference_sft(tts_text, "", **kw)

    def inference_cross_lingual(self, tts_text, prompt_wav, **kw):
        yield from self.inference_sft(tts_text, "", **kw)

    def inference_instruct2(self, tts_text, instruct_text, prompt_wav, **kw):
        yield from self.inference_sft(tts_text, "", **kw)


@pytest.fixture(scope="module")
def tiny_model():
    return TinyModel()


@pytest.fixture
def server(tiny_model):
    srv = http_server.serve(tiny_model, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _status(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _pcm_bytes(model, text: str) -> int:
    """The PCM bytes of an sft answer: RATIO tokens a text id, 2 mel frames
    a token, 480 samples a frame, 2 bytes a sample."""
    return len(model.tokenizer.encode(text)[:12]) * RATIO * 2 * 480 * 2


def test_http_server_endpoints(server, tiny_model):
    with urllib.request.urlopen(f"{server}/inference_sft?tts_text=hello&spk_id=x", timeout=120) as resp:
        assert resp.headers["Transfer-Encoding"] == "chunked"
        pcm = resp.read()
    assert len(pcm) == _pcm_bytes(tiny_model, "hello")
    assert np.abs(np.frombuffer(pcm, dtype="<i2")).max() > 0
    pcm2 = b"".join(stream_request(f"{server}/inference_zero_shot", {"tts_text": "hello", "prompt_text": "p"},
                                   {"prompt_wav": b"RIFF\r\n"}))
    assert pcm2 == pcm  # the multipart client, a binary file field ending in CRLF
    with urllib.request.urlopen(f"{server}/health", timeout=10) as resp:
        assert json.loads(resp.read()) == {"status": "ok"}
    assert _status(f"{server}/nope") == 404
    assert _status(f"{server}/inference_sft?spk_id=x") == 400  # no tts_text
    assert _status(f"{server}/inference_instruct?tts_text=hi&spk_id=x&instruct_text=y") == 400


def test_http_failures_reach_the_client(server, tiny_model):
    """A failure before the first audio answers 500; one while streaming
    cuts the response short (no terminating chunk)."""
    tiny_model.fail_after = 0
    try:
        assert _status(f"{server}/inference_sft?tts_text=hello&spk_id=x") == 500
        tiny_model.tts.enable_batched_streaming(2)  # a batching server streams: fail after the first chunk
        tiny_model.fail_after = 1
        with pytest.raises(http.client.IncompleteRead):
            b"".join(stream_request(f"{server}/inference_sft", {"tts_text": "hello world", "spk_id": "s"}))
    finally:
        tiny_model.fail_after = None
        tiny_model.tts.stream_scheduler = None


def test_http_concurrent_batched_streams(server, tiny_model):
    """Two concurrent streaming requests over real sockets with both
    schedulers attached (the handler consumes the generators outside the
    model lock): complete streams of the solo samples, and batched steps
    that advanced both sessions (rows > steps)."""
    tts, text = tiny_model.tts, "hello world"
    solo = np.concatenate([c["tts_speech"] for c in tts.tts(**tiny_model.request(text), stream=True)])
    want = http_server.pcm16(solo)
    tts.enable_batched_streaming(2)
    tts.enable_batched_llm(2)
    try:
        fetch = lambda i: b"".join(stream_request(f"{server}/inference_sft", {"tts_text": text, "spk_id": f"s{i}"}))
        assert np.abs(np.frombuffer(fetch(0), "<i2").astype(int) - np.frombuffer(want, "<i2")).max() <= 1
        sched, lsched = tts.stream_scheduler, tts.llm_scheduler
        steps0, rows0 = sched.stats["steps"], sched.stats["rows"]
        lsteps0, lrows0 = lsched.stats["steps"], lsched.stats["rows"]
        got = [None, None]
        ts = [threading.Thread(target=lambda i=i: got.__setitem__(i, fetch(i))) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        for g in got:
            assert g is not None and len(g) == len(want) == _pcm_bytes(tiny_model, text)
            assert np.abs(np.frombuffer(g, "<i2").astype(int) - np.frombuffer(want, "<i2")).max() <= 1
        assert sched.stats["rows"] - rows0 > sched.stats["steps"] - steps0 > 0, sched.stats
        assert lsched.stats["rows"] - lrows0 > lsched.stats["steps"] - lsteps0 > 0, lsched.stats
    finally:
        tts.stream_scheduler = tts.llm_scheduler = None


def test_grpc_roundtrip(tiny_model):
    pytest.importorskip("grpc")
    from fangyan_tts_torch.runtime.grpc_client import inference_stream, make_request
    from fangyan_tts_torch.runtime.grpc_server import serve

    srv, port = serve(tiny_model, port=0, host="127.0.0.1", max_conc=2)
    try:
        pcm = b"".join(inference_stream(f"127.0.0.1:{port}", make_request("sft", "hello grpc", spk_id="x"),
                                        timeout=120))
        assert len(pcm) == _pcm_bytes(tiny_model, "hello grpc") and np.abs(np.frombuffer(pcm, "<i2")).max() > 0
        import grpc

        with pytest.raises(grpc.RpcError) as err:
            list(inference_stream(f"127.0.0.1:{port}", make_request("instruct", "hi", spk_id="x", instruct_text="y")))
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        srv.stop(None)


def _frontend_state(module, gen) -> dict:
    """Weights N(0, 1/fan_in) (the modules leave some tensors uninitialised),
    BatchNorm variances U(0.5, 1.5), scales and norm weights 1, means and
    biases 0."""
    out = {}
    for k, v in module.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        if v.dim() >= 2:
            out[k] = torch.randn(v.shape, generator=gen) / float(np.prod(v.shape[1:])) ** 0.5
        elif leaf == "var":
            out[k] = torch.rand(v.shape, generator=gen) + 0.5
        else:
            out[k] = torch.ones(v.shape) if leaf in ("scale", "weight") else torch.zeros(v.shape)
    return out


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, tiny_model):
    """A tiny model directory written by the port: config.json, the three
    msgpack checkpoints, tiny CAM++ and S3 checkpoints, a 2 s prompt wav."""
    from fangyan_tts_torch.data.audio import write_wav

    d = tmp_path_factory.mktemp("serving_model")
    tts = tiny_model.tts
    (d / "config.json").write_text(tcfg.config_to_json(tts.cfg))
    for name, m in (("llm", tts.llm), ("flow", tts.flow), ("hift", tts.hift)):
        save_params(d / f"{name}.msgpack", to_jax_tree(m.state_dict(), m))
    gen = torch.Generator().manual_seed(0)
    for name, m in (("campplus", CAMPPlus(**campplus_kwargs(CAMP)[1])), ("s3tokenizer", S3TokenizerV3(**s3_kwargs(S3)))):
        save_params(d / f"{name}.msgpack", to_jax_tree(_frontend_state(m, gen), m))
    t = np.arange(2 * 24000) / 24000.0
    write_wav(d / "prompt.wav", (0.3 * np.sin(2 * np.pi * 180.0 * t)).astype(np.float32), 24000)
    return d


@pytest.fixture
def tiny_frontend(monkeypatch):
    _, ckw = campplus_kwargs(CAMP)
    monkeypatch.setattr(tapi, "make_campplus_fn", lambda p, device=None: tfe.make_campplus_fn(p, device, torch.float32,
                                                                                              **ckw))
    monkeypatch.setattr(tapi, "make_s3_fn", lambda p, device=None: tfe.make_s3_fn(p, device, torch.float32,
                                                                                  **s3_kwargs(S3)))


def test_streaming_inference(model_dir, tmp_path, tiny_model, tiny_frontend):
    """Two rows (one with a prompt); the equal and exponential schedules
    give the same wavs, the vc stream's samples."""
    from fangyan_tts_torch.data.audio import read_wav
    from fangyan_tts_torch.runtime.streaming_inference import chunk_schedule, main

    assert chunk_schedule(130, "equal") == [25] * 5 + [5]
    assert chunk_schedule(130, "exponential") == [25, 50, 55]
    rng = np.random.default_rng(2)
    ptok = rng.integers(0, 50, 7).astype(np.int32)
    np.save(tmp_path / "pf.npy", (rng.standard_normal((14, 80)) * 0.5).astype(np.float32))
    np.save(tmp_path / "emb.npy", rng.standard_normal(192).astype(np.float32))
    rows = [dict(id="a", tokens=VC[:130].tolist()),
            dict(id="b", tokens=VC[:90].tolist(), prompt_token=ptok.tolist(), prompt_feat=str(tmp_path / "pf.npy"),
                 embedding=str(tmp_path / "emb.npy"))]
    (tmp_path / "d.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    wavs = {}
    for strategy in ("equal", "exponential"):
        out = tmp_path / strategy
        main(["--model-dir", str(model_dir), "--dataset", str(tmp_path / "d.jsonl"), "--output-dir", str(out),
              "--strategy", strategy, "--no-fp16", "--device", "cpu"])
        metrics = json.loads((out / "metrics.json").read_text())
        assert len(metrics["per_utt"]) == 2 and metrics["aggregate_rtf"] > 0
        wavs[strategy] = {r["id"]: read_wav(out / f"{r['id']}.wav")[0] for r in rows}
    for r in rows:
        np.testing.assert_array_equal(wavs["equal"][r["id"]], wavs["exponential"][r["id"]])
    want = np.concatenate([c["tts_speech"] for c in tiny_model.tts.tts(
        source_speech_token=VC[:130], flow_embedding=np.zeros(192, np.float32), stream=True)])
    assert len(wavs["equal"]["a"]) == len(want) == 130 * 2 * 480
    np.testing.assert_allclose(wavs["equal"]["a"], want, rtol=0, atol=2 / 32768)  # 16-bit wav


def test_offline_inference(model_dir, tmp_path, tiny_frontend):
    """Two rows sharing a prompt batch through batch_synthesize (int8 LLM,
    the runner's default), a third with its own prompt through
    inference_zero_shot; a kaldi-style directory reads the same rows."""
    from fangyan_tts_torch.data.audio import read_wav
    from fangyan_tts_torch.runtime.offline_inference import load_dataset, main

    wav = str(model_dir / "prompt.wav")
    rows = [dict(id="u1", text="你好。", prompt_text="提示。", prompt_wav=wav),
            dict(id="u2", text="今天天气不错。", prompt_text="提示。", prompt_wav=wav),
            dict(id="u3", text="再见。", prompt_text="另一个。", prompt_wav=wav)]
    (tmp_path / "eval.jsonl").write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in rows))
    out = tmp_path / "out"
    main(["--model-dir", str(model_dir), "--dataset", str(tmp_path / "eval.jsonl"), "--output-dir", str(out),
          "--batch-size", "2", "--no-fp16", "--device", "cpu"])
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["aggregate"]["n_utts"] == 3 and metrics["aggregate"]["total_audio_s"] > 0
    for r in rows:
        wav_r = read_wav(out / f"{r['id']}.wav")[0]
        assert len(wav_r) >= 9 * 2 * 480 and np.isfinite(wav_r).all() and np.abs(wav_r).max() > 0
    kaldi = tmp_path / "kaldi"
    kaldi.mkdir()
    (kaldi / "wav.scp").write_text(f"k1 {wav}\nk2 {wav}\n")
    (kaldi / "text").write_text("k1 你好。\nk2 再见。\n")
    assert load_dataset(str(kaldi)) == [dict(id="k1", text="你好。", prompt_wav=wav, prompt_text=""),
                                        dict(id="k2", text="再见。", prompt_wav=wav, prompt_text="")]


def test_disaggregated_in_process(tiny_model):
    """The decode on its own thread, token2wav on the caller's: the solo
    stream's samples (greedy tokens)."""
    from fangyan_tts_torch.runtime.disaggregated import DisaggregatedTTS

    tts = tiny_model.tts
    text = np.random.default_rng(0).integers(0, 300, 6).astype(np.int32)
    req = dict(min_token_text_ratio=10, max_token_text_ratio=10)
    d = DisaggregatedTTS(tts)
    assert d.llm_side is tts and d.wav_side is tts  # one device: both stages on it
    got = [c["tts_speech"] for c in d.tts_stream(text=text, **req)]
    want = [c["tts_speech"] for c in tts.tts(text=text, stream=True, **req)]
    assert [len(g) for g in got] == [len(w) for w in want] and sum(len(w) for w in want) == 60 * 2 * 480
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=1e-6)
    d2 = DisaggregatedTTS(tts, llm_device="cpu", wav_device=torch.device("cpu"))
    assert d2.llm_device == d2.wav_device == torch.device("cpu")
