"""Stage 2: speech-token extraction (tools/extract_speech_token.py
equivalent, the flags of fangyan_tts_tpu/cli/extract_speech_token.py plus
--device).

python -m fangyan_tts_torch.cli.extract_speech_token --dir <kaldi-dir> \
    [--checkpoint s3tokenizer_v3.msgpack] [--batch-size 32] [--device cuda|cpu]

--onnx_path takes speech_tokenizer_v3.onnx (models/convert.s3_params_from_onnx)
or a pre-converted .msgpack. The tokenizer's width, depth, mel count and
FSMN kernel are read from the weights (20 heads, as the JAX CLI). It runs
in bf16 (weights of two or more dimensions and the input mel), on CUDA
unless --device cpu.
"""

from __future__ import annotations

import argparse
import time

import torch


def s3_hyper(params: dict) -> dict:
    """S3TokenizerV3's dim / layers / n_mels / fsmn_kernel from a JAX-layout
    tree (the hyperparameters s3_params_from_torch derives)."""
    _, n_mels, dim = params["conv1_kernel"].shape  # (3, n_mels, dim)
    layers = sum(1 for k in params if k.startswith("blocks_"))
    return {"dim": int(dim), "layers": layers, "n_mels": int(n_mels),
            "fsmn_kernel": int(params["blocks_0"]["fsmn_kernel"].shape[0])}


def s3_params(checkpoint: str | None, onnx_path: str | None) -> tuple[dict, dict]:
    """(the JAX-layout S3 tree, S3TokenizerV3's kwargs) from --checkpoint /
    --onnx_path, else random full-size weights (with a warning, as the JAX CLI)."""
    from ..train.checkpoint import load_params

    ckpt = checkpoint or (onnx_path if onnx_path and onnx_path.endswith(".msgpack") else None)
    if ckpt:
        params = load_params(ckpt)
        return params, s3_hyper(params)
    if onnx_path and onnx_path.endswith(".onnx"):
        from ..models.convert import s3_params_from_onnx

        return s3_params_from_onnx(onnx_path)
    print("⚠️ no converted S3 checkpoint given — using random init (tokens are placeholders)")
    from ..infer.tts import _random_state
    from ..models.from_jax import to_jax_tree
    from ..models.s3tokenizer import S3TokenizerV3

    sd = _random_state(S3TokenizerV3, torch.float32, torch.Generator().manual_seed(0), torch.device("cpu"))
    with torch.device("meta"):
        skel = S3TokenizerV3()
    params = to_jax_tree(sd, skel)
    return params, s3_hyper(params)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", type=str, required=True)
    parser.add_argument("--onnx_path", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--num_thread", type=int, default=8)  # compat, unused
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..data.extract import extract_speech_tokens
    from ..infer.frontend import make_s3_fn
    from ..ops.device import resolve_device

    dev = resolve_device(args.device)
    params, hyper = s3_params(args.checkpoint, args.onnx_path)
    s3 = make_s3_fn(params, dev, torch.bfloat16, **hyper)

    t0 = time.time()
    utt2tok = extract_speech_tokens(args.dir, s3, batch_size=args.batch_size, device=dev)
    dt = time.time() - t0
    print(f"✅ extracted {len(utt2tok)} token sequences in {dt:.1f}s ({len(utt2tok) / max(dt, 1e-9):.1f} utt/s)")


if __name__ == "__main__":
    main()
