"""gRPC TTS client (fangyan_tts_tpu/runtime/grpc_client.py; the reference's
runtime/python/grpc/client.py). grpc and protobuf are imported when a call
is made.

Run: python -m fangyan_tts_torch.runtime.grpc_client --host localhost:50000 --mode sft --tts_text ...
"""

from __future__ import annotations

import argparse

import numpy as np

from .grpc_server import RPC_PATH, proto


def inference_stream(host: str, request, timeout: float = 300.0):
    """Yields the int16 PCM chunks of one request (a cosyvoice_pb2.Request)."""
    import grpc

    pb = proto()
    with grpc.insecure_channel(host) as channel:
        rpc = channel.unary_stream(RPC_PATH, request_serializer=pb.Request.SerializeToString,
                                   response_deserializer=pb.Response.FromString)
        for resp in rpc(request, timeout=timeout):
            yield resp.tts_audio


def make_request(mode: str, tts_text: str, spk_id: str = "", prompt_text: str = "", prompt_audio: bytes = b"",
                 instruct_text: str = ""):
    """A cosyvoice_pb2.Request of one of the four payloads."""
    req = proto().Request()
    if mode == "sft":
        req.sft_request.spk_id = spk_id
        req.sft_request.tts_text = tts_text
    elif mode == "zero_shot":
        req.zero_shot_request.tts_text = tts_text
        req.zero_shot_request.prompt_text = prompt_text
        req.zero_shot_request.prompt_audio = prompt_audio
    elif mode == "cross_lingual":
        req.cross_lingual_request.tts_text = tts_text
        req.cross_lingual_request.prompt_audio = prompt_audio
    else:
        req.instruct_request.tts_text = tts_text
        req.instruct_request.spk_id = spk_id
        req.instruct_request.instruct_text = instruct_text
    return req


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost:50000")
    parser.add_argument("--mode", choices=["sft", "zero_shot", "cross_lingual", "instruct"], default="sft")
    parser.add_argument("--tts_text", required=True)
    parser.add_argument("--spk_id", default="")
    parser.add_argument("--prompt_text", default="")
    parser.add_argument("--prompt_wav", default=None)
    parser.add_argument("--instruct_text", default="")
    parser.add_argument("--output", default="out.wav")
    args = parser.parse_args(argv)

    audio = b""
    if args.prompt_wav:
        with open(args.prompt_wav, "rb") as f:
            audio = f.read()
    req = make_request(args.mode, args.tts_text, args.spk_id, args.prompt_text, audio, args.instruct_text)
    pcm = np.frombuffer(b"".join(inference_stream(args.host, req)), dtype="<i2").astype(np.float32) / 32768.0
    from ..data.audio import write_wav

    write_wav(args.output, pcm, 24000)
    print(f"wrote {args.output} ({len(pcm) / 24000:.2f}s)")


if __name__ == "__main__":
    main()
