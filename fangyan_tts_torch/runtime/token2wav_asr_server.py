"""token2wav + ASR reward server for GRPO training (the port's copy of
fangyan_tts_tpu/runtime/token2wav_asr_server.py, after the reference's
examples/grpo/cosyvoice2/token2wav_asr_server.py): (a) speech-token ->
waveform synthesis through the flow+vocoder stack and (b) ASR transcription,
used by cli.grpo_train --reward_url to score rollouts with -CER.

A stdlib ThreadingHTTPServer (the pattern of runtime/http_server.py):

- POST /token2wav   JSON {"tokens": [...], "prompt_token": [...],
                    "prompt_feat": [[...]], "embedding": [...]} -> WAV bytes
- POST /asr         audio/wav bytes -> {"text": "..."}
- POST /score       JSON {"tokens": [...], "text": "...", ...prompt fields}
                    -> {"text": hyp, "reward": -CER}
- POST /stream/start, /stream/push, /stream/finish: streaming token2wav
  sessions (infer/stream.Token2WavSession, the flash kernel on the card)
  for the two-process split (runtime/disaggregated.RemoteToken2Wav).

The ASR backend is pluggable: --asr funasr uses FunASR's paraformer when
installed; --asr whisper a local transformers Whisper checkpoint; --asr echo
transcribes nothing; tests inject a python callable via serve(model,
asr_fn=...). The model runs on CUDA unless --device cpu is given.

Run: python -m fangyan_tts_torch.runtime.token2wav_asr_server \
       --model_dir <dir> --port 50002 --asr funasr
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import wave as wave_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_model = None
_asr_fn = None
_lock = threading.Lock()


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _read_wav(data: bytes) -> tuple[np.ndarray, int]:
    with wave_mod.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0
    return pcm, sr


def make_asr_fn(backend: str):
    """ASR backends, dependency-gated like the reference's dataset CLIs."""
    if backend == "funasr":
        try:
            from funasr import AutoModel as FunASRModel  # type: ignore
        except ImportError as e:
            raise RuntimeError("funasr is not installed; use --asr echo or whisper") from e
        m = FunASRModel(model="paraformer-zh")

        def fn(wav: np.ndarray, sr: int) -> str:
            res = m.generate(input=wav, fs=sr)
            return res[0]["text"] if res else ""

        return fn
    if backend == "whisper":
        try:
            import torch
            from transformers import WhisperForConditionalGeneration, WhisperProcessor  # type: ignore
        except ImportError as e:
            raise RuntimeError("transformers Whisper unavailable") from e
        proc = WhisperProcessor.from_pretrained("openai/whisper-small")
        m = WhisperForConditionalGeneration.from_pretrained("openai/whisper-small").eval()

        def fn(wav: np.ndarray, sr: int) -> str:
            if sr != 16000:
                from ..data.audio import resample_poly

                wav = resample_poly(wav, sr, 16000)
            feats = proc(wav, sampling_rate=16000, return_tensors="pt").input_features
            with torch.no_grad():
                ids = m.generate(feats)
            return proc.batch_decode(ids, skip_special_tokens=True)[0]

        return fn
    if backend == "echo":
        # test/bring-up backend: transcribes nothing (reward = -CER(text, ""))
        return lambda wav, sr: ""
    raise ValueError(f"unknown ASR backend {backend}")


def _token2wav(payload: dict) -> np.ndarray:
    tokens = np.asarray(payload["tokens"], np.int32)
    prompt_token = np.asarray(payload.get("prompt_token", []), np.int32)
    prompt_feat = np.asarray(payload.get("prompt_feat", np.zeros((0, 80))), np.float32).reshape(-1, 80)
    embedding = np.asarray(payload.get("embedding", np.zeros(192)), np.float32).reshape(-1)
    with _lock, torch.inference_mode():
        mel = _model.token2mel(tokens, prompt_token, prompt_feat, embedding, device_out=True)
        return np.asarray(_model.vocode(mel, finalize=True))


_sessions: dict = {}
_session_seq = [0]


def _stream_route(path: str, payload: dict) -> dict:
    """Streaming token2wav sessions for two-process disaggregated serving
    (runtime/disaggregated.py RemoteToken2Wav): the LLM process pushes token
    chunks, this process runs the windowed flow+vocoder (infer/stream.py)."""
    from ..infer.stream import Token2WavSession

    with _lock, torch.inference_mode():
        if path == "/stream/start":
            _session_seq[0] += 1
            sid = str(_session_seq[0])
            _sessions[sid] = Token2WavSession(
                _model,
                np.asarray(payload.get("prompt_token", []), np.int32),
                np.asarray(payload.get("prompt_feat", np.zeros((0, 80))), np.float32).reshape(-1, 80),
                np.asarray(payload.get("embedding", np.zeros(192)), np.float32).reshape(-1),
            )
            return {"session": sid}
        sess = _sessions[payload["session"]]
        if path == "/stream/push":
            chunks = sess.push(np.asarray(payload["tokens"], np.int32))
            return {"chunks": [c.tolist() for c in chunks]}
        if path == "/stream/finish":
            tail = sess.finish()
            del _sessions[payload["session"]]
            return {"chunk": tail.tolist()}
        raise ValueError(f"unknown stream route {path}")


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        try:
            if self.path == "/token2wav":
                audio = _token2wav(json.loads(data))
                self._send(200, _wav_bytes(audio, 24000), "audio/wav")
            elif self.path == "/asr":
                wav, sr = _read_wav(data)
                self._send(200, json.dumps({"text": _asr_fn(wav, sr)}, ensure_ascii=False).encode())
            elif self.path.startswith("/stream/"):
                self._send(200, json.dumps(_stream_route(self.path, json.loads(data))).encode())
            elif self.path == "/score":
                from ..train.grpo import cer

                payload = json.loads(data)
                audio = _token2wav(payload)
                hyp = _asr_fn(audio, 24000)
                reward = -cer(payload.get("text", ""), hyp)
                self._send(200, json.dumps({"text": hyp, "reward": reward}, ensure_ascii=False).encode())
            else:
                self._send(404, b'{"error": "unknown route"}')
        except (KeyError, ValueError, RuntimeError, AttributeError) as e:
            self._send(400, json.dumps({"error": str(e)}).encode())


def serve(model, asr_fn, port: int = 50002, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the server (returns it; call .shutdown() and .server_close() to
    stop). `model` is a CosyVoice3TTS with token2mel/vocode; port 0 takes a
    free port (httpd.server_address[1])."""
    global _model, _asr_fn
    _model = model
    _asr_fn = asr_fn
    httpd = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--port", type=int, default=50002)
    ap.add_argument("--asr", default="funasr", choices=["funasr", "whisper", "echo"])
    ap.add_argument("--fp16", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    args = ap.parse_args(argv)

    from ..api import CosyVoice3

    model = CosyVoice3(args.model_dir, fp16=args.fp16, load_frontend_models=False, device=args.device).model
    serve(model, make_asr_fn(args.asr), args.port)
    print(f"token2wav+ASR server on :{args.port} (asr={args.asr})")
    threading.Event().wait()


if __name__ == "__main__":
    main()
