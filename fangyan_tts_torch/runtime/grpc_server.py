"""gRPC streaming TTS server (fangyan_tts_tpu/runtime/grpc_server.py; the
reference's runtime/python/grpc/server.py), wire-compatible with the
reference's cosyvoice.proto (proto/ here, field for field): one
server-streaming RPC /cosyvoice.CosyVoice/Inference answering int16 PCM
chunks in Response.tts_audio. The service is registered through grpc's
generic handler API on the protoc-generated message classes.

grpc and protobuf are imported when a server is made, not when this module
is imported (a CUDA host may have neither). With the batching schedulers
attached, requests are streamed, as in runtime/http_server.py.

Run: python -m fangyan_tts_torch.runtime.grpc_server --port 50000 --model_dir <dir> [--batched_streams 4]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import tempfile
from concurrent import futures
from pathlib import Path

from .http_server import batching, load_model, pcm16

RPC_PATH = "/cosyvoice.CosyVoice/Inference"


def proto():
    """The generated cosyvoice_pb2 module (imports protobuf), loaded once."""
    name = __package__ + ".proto.cosyvoice_pb2"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, Path(__file__).parent / "proto" / "cosyvoice_pb2.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


def make_servicer(model):
    """The generic RPC handler serving `model` (the API object)."""
    import grpc

    pb = proto()

    def inference(request, context):
        which = request.WhichOneof("RequestPayload")
        kw = {"stream": True} if batching(model) else {}
        tmp = []

        def prompt(data: bytes) -> str:
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(data)
            tmp.append(f.name)
            return f.name

        try:
            if which == "sft_request":
                r = request.sft_request
                gen = model.inference_sft(r.tts_text, r.spk_id, **kw)
            elif which == "zero_shot_request":
                r = request.zero_shot_request
                gen = model.inference_zero_shot(r.tts_text, r.prompt_text, prompt(r.prompt_audio), **kw)
            elif which == "cross_lingual_request":
                r = request.cross_lingual_request
                gen = model.inference_cross_lingual(r.tts_text, prompt(r.prompt_audio), **kw)
            elif which == "instruct_request" and request.instruct_request.spk_id:
                r = request.instruct_request
                gen = model.inference_instruct(r.tts_text, r.spk_id, r.instruct_text, **kw)
            elif which == "instruct_request":
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, "instruct_request requires spk_id")
            else:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"unknown payload {which}")
            for out in gen:
                yield pb.Response(tts_audio=pcm16(out["tts_speech"]))
        except NotImplementedError as e:  # an unported mode, at call or at iteration
            context.abort(grpc.StatusCode.UNIMPLEMENTED, str(e))
        finally:
            for p in tmp:
                os.unlink(p)

    handler = grpc.unary_stream_rpc_method_handler(inference, request_deserializer=pb.Request.FromString,
                                                   response_serializer=pb.Response.SerializeToString)
    return grpc.method_handlers_generic_handler("cosyvoice.CosyVoice", {"Inference": handler})


def serve(model, port: int = 50000, max_conc: int = 4, host: str = "0.0.0.0"):
    """A started grpc server for `model`; returns (server, bound port)
    (port 0 picks a free one)."""
    import grpc

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_conc), maximum_concurrent_rpcs=max_conc)
    server.add_generic_rpc_handlers((make_servicer(model),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--max_conc", type=int, default=4)
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--quant_int8", action="store_true", help="weight-only int8 LLM decode (ops/quant.py)")
    parser.add_argument("--batched_streams", type=int, default=0,
                        help="serve concurrent requests streamed through the LLM and token2wav schedulers of "
                             "this width")
    args = parser.parse_args(argv)

    server, port = serve(load_model(args.model_dir, args.quant_int8, args.batched_streams), args.port, args.max_conc)
    print(f"grpc serving on :{port}")
    server.wait_for_termination()


if __name__ == "__main__":
    main()
