"""Streaming HTTP TTS server (fangyan_tts_tpu/runtime/http_server.py; the
reference's runtime/python/fastapi/server.py): the endpoints
/inference_{sft,zero_shot,cross_lingual,instruct,instruct2} take form
fields (tts_text, spk_id, prompt_text, instruct_text) and a prompt_wav file
upload, as multipart form data, a query string, JSON or a urlencoded body,
and answer with raw int16 PCM in chunked transfer encoding; /health answers
{"status": "ok"}. A stdlib ThreadingHTTPServer: one thread a connection.

With the batching schedulers attached (`--batched_streams N`:
CosyVoice3TTS.enable_batched_streaming and enable_batched_llm), requests are
served concurrently and streamed (tts(stream=True)), so that concurrent
requests share the continuous-batched decode and the batched token2wav. The
JAX package's server passes no stream argument, so there the schedulers see
no request. Without schedulers the requests are served one at a time,
offline, as the reference server does.

A request that fails before its first audio gets 400 (a bad request) or 500
(anything else, logged with its traceback); one that fails while streaming
has its connection closed before the terminating chunk, so the client sees
an incomplete response. Nothing is retried or served in another way.

Run: python -m fangyan_tts_torch.runtime.http_server --port 50000 --model_dir <dir> [--batched_streams 4]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

# errors of the request itself (a missing field, an unported mode, a bad prompt)
CLIENT_ERRORS = (KeyError, ValueError, AssertionError, NotImplementedError, AttributeError)


def batching(model) -> bool:
    """Whether the model's pipeline has a batching scheduler attached: then
    requests run concurrently (the schedulers lock inside) and streamed.
    Serializing them would leave the schedulers nothing to batch."""
    pipe = getattr(model, "model", None) or getattr(model, "tts", None) or model
    return getattr(pipe, "stream_scheduler", None) is not None or getattr(pipe, "llm_scheduler", None) is not None


def parse_multipart(body: bytes, content_type: str) -> dict:
    """A minimal multipart/form-data parser: {name: content bytes}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    out: dict[str, bytes] = {}
    for part in body.split(b"--" + m.group(1).encode()):
        # strip the delimiter's CRLFs only: a wav payload may end in 0x0d / 0x0a bytes
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part.startswith(b"--") or b"\r\n\r\n" not in part:
            continue
        header, _, content = part.partition(b"\r\n\r\n")
        nm = re.search(rb'name="([^"]+)"', header)
        if nm:
            out[nm.group(1).decode()] = content
    return out


def pcm16(audio) -> bytes:
    """float audio in [-1, 1] -> little-endian int16 PCM bytes."""
    return (np.clip(np.asarray(audio, np.float32), -1, 1) * (2**15)).astype("<i2").tobytes()


class TTSHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _fields(self) -> dict:
        fields: dict = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length:
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if "multipart/form-data" in ctype:
                for k, v in parse_multipart(body, ctype).items():
                    fields[k] = v if k == "prompt_wav" else v.decode("utf-8", "replace")
            elif "application/json" in ctype:
                fields.update(json.loads(body))
            elif "application/x-www-form-urlencoded" in ctype:
                fields.update({k: v[0] for k, v in parse_qs(body.decode()).items()})
        return fields

    def _prompt_file(self, fields: dict) -> str:
        data = fields.get("prompt_wav", b"")
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            tmp.write(data if isinstance(data, bytes) else data.encode())
        self._tmp_paths.append(tmp.name)
        return tmp.name

    def _request(self, route: str, f: dict):
        """The API call of a route (a lazy generator of {"tts_speech"}), or
        None for an unknown route."""
        model, kw = self.server.model, {"stream": True} if batching(self.server.model) else {}
        if route == "/inference_sft":
            return model.inference_sft(f["tts_text"], f["spk_id"], **kw)
        if route == "/inference_zero_shot":
            return model.inference_zero_shot(f["tts_text"], f.get("prompt_text", ""), self._prompt_file(f), **kw)
        if route == "/inference_cross_lingual":
            return model.inference_cross_lingual(f["tts_text"], self._prompt_file(f), **kw)
        if route == "/inference_instruct":
            return model.inference_instruct(f["tts_text"], f["spk_id"], f["instruct_text"], **kw)
        if route == "/inference_instruct2":
            return model.inference_instruct2(f["tts_text"], f["instruct_text"], self._prompt_file(f), **kw)
        return None

    def _stream(self, gen) -> None:
        """The first chunk is made before the response starts, so that a
        request that fails at once gets an error status."""
        try:
            first = next(gen, None)
        except CLIENT_ERRORS as e:
            self.send_error(400, f"{type(e).__name__}: {e}")
            return
        except Exception:
            self.send_error(500, "synthesis failed")
            raise
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for out in () if first is None else itertools.chain([first], gen):
                pcm = pcm16(out["tts_speech"])
                self.wfile.write(f"{len(pcm):X}\r\n".encode() + pcm + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except BaseException:
            self.close_connection = True  # no terminating chunk: the client sees the response cut
            raise

    def _handle(self) -> None:
        route = urlparse(self.path).path
        if route == "/health":
            body = b'{"status": "ok"}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._tmp_paths: list[str] = []
        try:
            f = self._fields()
            try:
                gen = self._request(route, f)
            except CLIENT_ERRORS as e:
                self.send_error(400, f"{type(e).__name__}: {e}")
                return
            if gen is None:
                self.send_error(404, f"unknown route {route}")
            elif batching(self.server.model):
                self._stream(gen)
            else:
                with self.server.model_lock:
                    self._stream(gen)
        finally:
            for p in self._tmp_paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    do_GET = _handle
    do_POST = _handle

    def log_message(self, fmt, *args):  # quiet
        pass


def serve(model, host: str = "0.0.0.0", port: int = 50000) -> ThreadingHTTPServer:
    """A server for `model` (the API object: inference_* generators), not
    yet serving: call serve_forever() (port 0 picks a free port, see
    server_address)."""
    server = ThreadingHTTPServer((host, port), TTSHandler)
    server.daemon_threads = True
    server.model = model
    server.model_lock = threading.Lock()
    return server


def load_model(model_dir: str, quant_int8: bool = False, batched_streams: int = 0):
    """AutoModel(model_dir) (on CUDA) with the batching schedulers of width
    batched_streams attached when it is not 0."""
    from ..api import AutoModel

    model = AutoModel(model_dir=model_dir, quant_int8=quant_int8)
    if batched_streams:
        model.model.enable_batched_streaming(batched_streams)
        model.model.enable_batched_llm(batched_streams)
    return model


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--quant_int8", action="store_true", help="weight-only int8 LLM decode (ops/quant.py)")
    parser.add_argument("--warmup_prompt_lens", type=int, nargs="*", default=None,
                        help="run a silent stream of each prompt token length first (warmup_streaming)")
    parser.add_argument("--batched_streams", type=int, default=0,
                        help="serve concurrent requests streamed through the LLM and token2wav schedulers of "
                             "this width")
    args = parser.parse_args(argv)

    model = load_model(args.model_dir, args.quant_int8, args.batched_streams)
    for plen in args.warmup_prompt_lens or []:
        print(f"warmup: a silent stream with a {plen}-token prompt ...")
        model.model.warmup_streaming(plen)
    server = serve(model, port=args.port)
    print(f"serving on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
