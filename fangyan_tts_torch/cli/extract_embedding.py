"""Stage 1: speaker-embedding extraction (tools/extract_embedding.py
equivalent, the flags of fangyan_tts_tpu/cli/extract_embedding.py plus
--device).

python -m fangyan_tts_torch.cli.extract_embedding --dir <kaldi-dir> \
    [--checkpoint campplus.msgpack] [--batch-size 64] [--device cuda|cpu]

--onnx_path accepts the reference's campplus.onnx directly (weights are
converted on the fly by models/convert.campplus_params_from_onnx) or a
pre-converted .msgpack. Extraction runs the port's CAM++ (full size),
batched, in bf16 (weights of two or more dimensions and the input; the
BatchNorm statistics stay float32), on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import time

import torch


def campplus_params(checkpoint: str | None, onnx_path: str | None) -> dict:
    """The JAX-layout CAM++ tree from --checkpoint / --onnx_path, else random
    weights (with a warning, as the JAX CLI)."""
    from ..train.checkpoint import load_params

    ckpt = checkpoint or (onnx_path if onnx_path and onnx_path.endswith(".msgpack") else None)
    if ckpt:
        return load_params(ckpt)
    if onnx_path and onnx_path.endswith(".onnx"):
        from ..models.convert import campplus_params_from_onnx

        return campplus_params_from_onnx(onnx_path)
    print("⚠️ no converted CAM++ checkpoint given — using random init (embeddings are placeholders)")
    from ..infer.tts import _random_state
    from ..models.campplus import CAMPPlus
    from ..models.from_jax import to_jax_tree

    sd = _random_state(CAMPPlus, torch.float32, torch.Generator().manual_seed(0), torch.device("cpu"))
    with torch.device("meta"):
        skel = CAMPPlus()
    return to_jax_tree(sd, skel)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", type=str, required=True)
    parser.add_argument("--onnx_path", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--num_thread", type=int, default=8)  # compat, unused
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..data.extract import extract_embeddings
    from ..infer.frontend import make_campplus_fn
    from ..ops.device import resolve_device

    dev = resolve_device(args.device)
    camp = make_campplus_fn(campplus_params(args.checkpoint, args.onnx_path), dev, torch.bfloat16)

    t0 = time.time()
    utt2emb = extract_embeddings(args.dir, lambda fbank, frame_len: camp(fbank), batch_size=args.batch_size,
                                 device=dev)
    dt = time.time() - t0
    print(f"✅ extracted {len(utt2emb)} embeddings in {dt:.1f}s ({len(utt2emb) / max(dt, 1e-9):.1f} utt/s)")


if __name__ == "__main__":
    main()
