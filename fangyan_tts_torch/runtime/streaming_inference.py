"""Streaming token2wav over a dataset of speech tokens, with first-chunk and
RTF figures (fangyan_tts_tpu/runtime/streaming_inference.py; the
reference's runtime/triton_trtllm/streaming_inference.py).

Each row's tokens are fed to a Token2WavSession (infer/stream.py: 25-token
hops, the constant-cost window) in chunks of a schedule: "equal" (25 tokens
a chunk, the hop) or "exponential" (25, 50, 100, ...). The session runs on
its own hop grid, so the schedule changes only when tokens arrive.

Input: --dataset JSONL rows {"id", "tokens": [...], optional
"prompt_token": [...], "prompt_feat" (.npy path), "embedding" (.npy path)}.
Output: <output-dir>/<id>.wav and metrics.json.

Run: python -m fangyan_tts_torch.runtime.streaming_inference \\
       --model-dir <dir> --dataset tokens.jsonl --output-dir wavs
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def chunk_schedule(n: int, strategy: str, base: int = 25) -> list[int]:
    """Chunk sizes that cover n tokens: `base` each ("equal"), or base,
    2 base, 4 base, ... ("exponential"); the last chunk is cut to fit."""
    if strategy == "equal":
        sizes = [base] * (n // base + 1)
    else:
        sizes, c = [], base
        while sum(sizes) < n:
            sizes.append(c)
            c *= 2
    out, acc = [], 0
    for s in sizes:
        s = min(s, n - acc)
        if s <= 0:
            break
        out.append(s)
        acc += s
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--output-dir", default="generated_wavs")
    ap.add_argument("--strategy", default="equal", choices=["equal", "exponential"])
    ap.add_argument("--no-fp16", dest="fp16", action="store_false", default=True)
    ap.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)

    from ..api import AutoModel
    from ..data.audio import write_wav
    from ..infer.stream import Token2WavSession

    model = AutoModel(args.model_dir, fp16=args.fp16, device=args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = [json.loads(line) for line in Path(args.dataset).read_text().splitlines() if line.strip()]
    if args.limit:
        rows = rows[: args.limit]

    stats = []
    for row in rows:
        tokens = np.asarray(row["tokens"], np.int32)
        ptok = np.asarray(row.get("prompt_token", []), np.int32)
        pfeat = np.load(row["prompt_feat"]) if row.get("prompt_feat") else np.zeros((0, 80), np.float32)
        emb = np.load(row["embedding"]) if row.get("embedding") else np.zeros(192, np.float32)
        sess = Token2WavSession(model.model, ptok, pfeat, emb)
        chunks, t0 = [], time.perf_counter()
        first, pos = None, 0
        for size in chunk_schedule(len(tokens), args.strategy):
            for audio in sess.push(tokens[pos : pos + size]):
                first = time.perf_counter() - t0 if first is None else first
                chunks.append(audio)
            pos += size
        chunks.append(sess.finish())
        wall = time.perf_counter() - t0
        audio = np.concatenate(chunks)
        write_wav(out / f"{row['id']}.wav", audio, model.sample_rate)
        dur = len(audio) / model.sample_rate
        stats.append({"id": row["id"], "duration_s": dur, "wall_s": wall, "rtf": wall / max(dur, 1e-6),
                      "first_chunk_ms": None if first is None else first * 1e3})
    agg_rtf = sum(s["wall_s"] for s in stats) / max(sum(s["duration_s"] for s in stats), 1e-6)
    (out / "metrics.json").write_text(json.dumps({"aggregate_rtf": agg_rtf, "per_utt": stats}, indent=1))
    print(json.dumps({"aggregate_rtf": agg_rtf, "n": len(stats)}))


if __name__ == "__main__":
    main()
