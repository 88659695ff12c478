"""HTTP TTS client (fangyan_tts_tpu/runtime/http_client.py; the reference's
runtime/python/fastapi/client.py): posts a multipart form, streams the int16
PCM chunks, writes a wav.

Run: python -m fangyan_tts_torch.runtime.http_client --mode zero_shot --tts_text ... --prompt_wav p.wav
"""

from __future__ import annotations

import argparse
import uuid
from pathlib import Path

import numpy as np


def build_multipart(fields: dict[str, str], files: dict[str, bytes]) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n".encode()
             for k, v in fields.items()]
    for k, data in files.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"; filename=\"{k}.wav\"\r\n"
                     f"Content-Type: audio/wav\r\n\r\n".encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def stream_request(url: str, fields: dict, files: dict | None = None, timeout: float = 600.0):
    """Yields the PCM bytes of a streaming endpoint as they arrive. An error
    status raises urllib.error.HTTPError; a response cut short raises
    http.client.IncompleteRead."""
    import urllib.request

    body, ctype = build_multipart(fields, files or {})
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        while True:
            chunk = resp.read(16384)
            if not chunk:
                return
            yield chunk


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=50000)
    p.add_argument("--mode", default="sft", choices=["sft", "zero_shot", "cross_lingual", "instruct", "instruct2"])
    p.add_argument("--tts_text", required=True)
    p.add_argument("--spk_id", default="")
    p.add_argument("--prompt_text", default="")
    p.add_argument("--prompt_wav", default=None)
    p.add_argument("--instruct_text", default="")
    p.add_argument("--tts_wav", default="demo.wav")
    args = p.parse_args(argv)

    fields = {"tts_text": args.tts_text}
    if args.mode in ("sft", "instruct"):
        fields["spk_id"] = args.spk_id
    if args.mode == "zero_shot":
        fields["prompt_text"] = args.prompt_text
    if args.mode in ("instruct", "instruct2"):
        fields["instruct_text"] = args.instruct_text
    files = {"prompt_wav": Path(args.prompt_wav).read_bytes()} if args.prompt_wav else {}
    pcm = b"".join(stream_request(f"http://{args.host}:{args.port}/inference_{args.mode}", fields, files))
    audio = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
    from ..data.audio import write_wav

    write_wav(args.tts_wav, audio, 24000)
    print(f"wrote {args.tts_wav} ({len(audio) / 24000:.2f}s)")


if __name__ == "__main__":
    main()
