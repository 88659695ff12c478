"""Serving benchmark client (fangyan_tts_tpu/runtime/bench_client.py; the
reference's runtime/triton_trtllm/client_grpc.py): concurrency sweeps over a
fixed utterance set against the HTTP server, with first-chunk,
second-chunk and total latency percentiles, per-request RTF and the
aggregate RTF (wall clock / total audio), and the reference README's table:
  Mode | Concurrency | Avg Latency (ms) | P50 Latency (ms) | RTF

python -m fangyan_tts_torch.runtime.bench_client --host localhost --port 50000 \
    --mode sft --sweep 1,2,4 --num_requests 20 [--text_file eval.txt]
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .http_client import stream_request

# default eval set: varying lengths like the seed_tts-style sets the
# reference benches with (client_grpc.py --huggingface-dataset)
DEFAULT_TEXTS = [
    "收到好友从远方寄来的生日礼物，那份意外的惊喜让我心中充满了快乐。",
    "今天天气真不错。",
    "八百标兵奔北坡，炮兵并排北边跑。",
    "人工智能正在改变我们的生活方式，从语音助手到自动驾驶，技术的进步让未来充满了无限可能。",
    "他说话的声音很低，但每个字都清晰可闻。",
    "春眠不觉晓，处处闻啼鸟。夜来风雨声，花落知多少。",
    "这个周末我们打算去郊外爬山，顺便野餐，希望不要下雨。",
    "科学家们经过多年的研究，终于在深海中发现了一种全新的发光生物。",
    "请把窗户关上，外面风太大了。",
    "无论前方的道路多么崎岖，我们都要坚定地走下去，因为坚持就是胜利。",
]


def one_request(url: str, fields: dict, files: dict, sample_rate: int) -> dict:
    t0 = time.time()
    first = second = None
    total_bytes = 0
    for chunk in stream_request(url, fields, files):
        now = time.time() - t0
        if first is None:
            first = now
        elif second is None:
            second = now
        total_bytes += len(chunk)
    total = time.time() - t0
    audio_seconds = total_bytes / 2 / sample_rate
    return {
        "first_chunk_ms": (first if first is not None else total) * 1000,
        "second_chunk_ms": (second if second is not None else total) * 1000,
        "total_ms": total * 1000,
        "audio_seconds": audio_seconds,
        "rtf": total / max(audio_seconds, 1e-9),
    }


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def summarize(xs: list[float]) -> dict:
    return {"avg": float(np.mean(xs)), "p50": pct(xs, 50), "p90": pct(xs, 90), "p99": pct(xs, 99)}


def run_level(url: str, requests: list[tuple[dict, dict]], concurrency: int, sample_rate: int) -> dict:
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        results = list(ex.map(lambda rq: one_request(url, rq[0], rq[1], sample_rate), requests))
    wall = time.time() - t0
    total_audio = sum(r["audio_seconds"] for r in results)
    return {
        "concurrency": concurrency,
        "num_requests": len(requests),
        "first_chunk_ms": summarize([r["first_chunk_ms"] for r in results]),
        "second_chunk_ms": summarize([r["second_chunk_ms"] for r in results]),
        "total_ms": summarize([r["total_ms"] for r in results]),
        "rtf": summarize([r["rtf"] for r in results]),
        "aggregate_rtf": wall / max(total_audio, 1e-9),
        "audio_seconds_total": total_audio,
        "wall_seconds": wall,
    }


def markdown_table(mode_label: str, levels: list[dict]) -> str:
    """The README.md:95-101 table layout."""
    lines = [
        "| Mode | Concurrency | Avg Latency (ms) | P50 Latency (ms) | P90 Latency (ms) | P99 Latency (ms) | RTF |",
        "|---|---|---|---|---|---|---|",
    ]
    for lv in levels:
        fc = lv["first_chunk_ms"]
        lines.append(
            f"| {mode_label} | {lv['concurrency']} | {fc['avg']:.2f} | {fc['p50']:.2f} "
            f"| {fc['p90']:.2f} | {fc['p99']:.2f} | {lv['aggregate_rtf']:.4f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=50000)
    p.add_argument("--mode", default="sft", help="sft|zero_shot|cross_lingual|instruct|instruct2")
    p.add_argument("--tts_text", default="", help="single text (overrides --text_file)")
    p.add_argument("--text_file", default="", help="one utterance per line (fixed eval set)")
    p.add_argument("--spk_id", default="")
    p.add_argument("--instruct_text", default="")
    p.add_argument("--prompt_text", default="")
    p.add_argument("--prompt_wav", default=None)
    p.add_argument("--num_requests", type=int, default=20)
    p.add_argument("--concurrency", type=int, default=0, help="single level (ignored if --sweep)")
    p.add_argument("--sweep", default="", help="comma list of concurrency levels, e.g. 1,2,4")
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--out", default="", help="write the JSON report here")
    args = p.parse_args(argv)

    url = f"http://{args.host}:{args.port}/inference_{args.mode}"
    if args.tts_text:
        texts = [args.tts_text]
    elif args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
    else:
        texts = DEFAULT_TEXTS
    base_fields = {}
    for k in ("spk_id", "instruct_text", "prompt_text"):
        v = getattr(args, k)
        if v:
            base_fields[k] = v
    files = {}
    if args.prompt_wav:
        with open(args.prompt_wav, "rb") as f:
            files["prompt_wav"] = f.read()

    requests = [({**base_fields, "tts_text": texts[i % len(texts)]}, files) for i in range(args.num_requests)]
    levels = [int(c) for c in args.sweep.split(",") if c] or [max(args.concurrency, 1)]

    report = {"mode": args.mode, "levels": []}
    for c in levels:
        lv = run_level(url, requests, c, args.sample_rate)
        report["levels"].append(lv)
        print(json.dumps(lv, indent=2))
    print()
    print(markdown_table(f"Streaming {args.mode}", report["levels"]))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, ensure_ascii=False)


if __name__ == "__main__":
    main()
