"""Offline batched inference over an evaluation set, with RTF figures
(fangyan_tts_tpu/runtime/offline_inference.py; the reference's
runtime/triton_trtllm/offline_inference.py).

Rows that share a prompt (wav and text) run through
CosyVoice3TTS.batch_synthesize in batches of --batch-size after the API's
frontend (the int8 LLM by default, as the dataset runner serves it); a row
with a prompt of its own runs through inference_zero_shot.

Input: --dataset JSONL rows {"id", "text", "prompt_text", "prompt_wav"} or a
kaldi-style directory (wav.scp and text). Output: <output-dir>/<id>.wav and
metrics.json (each utterance and the aggregate RTF).

Run: python -m fangyan_tts_torch.runtime.offline_inference \\
       --model-dir <dir> --dataset eval.jsonl --output-dir wavs --batch-size 16
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


def load_dataset(path: str) -> list[dict]:
    """JSONL rows, or a kaldi-style directory's wav.scp and text (the wav is
    the row's prompt, its prompt text empty)."""
    p = Path(path)
    if p.is_dir():
        read = lambda name: dict(line.split(maxsplit=1) for line in (p / name).read_text().splitlines() if line.strip())
        wavs, texts = read("wav.scp"), read("text")
        return [{"id": k, "text": texts.get(k, ""), "prompt_wav": v, "prompt_text": ""} for k, v in wavs.items()]
    return [json.loads(line) for line in p.read_text().splitlines() if line.strip()]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--dataset", required=True, help="JSONL rows or a kaldi-style directory")
    ap.add_argument("--output-dir", default="generated_wavs")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--no-fp16", dest="fp16", action="store_false", default=True)
    ap.add_argument("--no-int8-llm", dest="int8_llm", action="store_false", default=True)
    ap.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)

    from ..api import AutoModel
    from ..data.audio import write_wav

    model = AutoModel(args.model_dir, fp16=args.fp16, quant_int8=args.int8_llm, device=args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = load_dataset(args.dataset)
    if args.limit:
        rows = rows[: args.limit]
    sr = model.sample_rate
    groups: dict = defaultdict(list)
    for row in rows:
        groups[(row.get("prompt_wav", ""), row.get("prompt_text", ""))].append(row)

    metrics, total_audio, t_start = [], 0.0, time.perf_counter()

    def done(row, audio, wall):
        nonlocal total_audio
        dur = len(audio) / sr
        total_audio += dur
        write_wav(out / f"{row['id']}.wav", audio, sr)
        metrics.append({"id": row["id"], "duration_s": dur, "wall_s": wall})

    for (pwav, ptext), grp in groups.items():
        if len(grp) == 1:
            row = grp[0]
            t0 = time.perf_counter()
            audio = np.concatenate([np.asarray(c["tts_speech"]).reshape(-1) for c in model.inference_zero_shot(
                row["text"], row.get("prompt_text", ""), row["prompt_wav"], stream=False)])
            done(row, audio, time.perf_counter() - t0)
            continue
        mis = [model.frontend.frontend_zero_shot(r["text"], ptext, pwav) for r in grp]
        mi0 = mis[0]
        for j in range(0, len(grp), args.batch_size):
            sub, sub_mi = grp[j : j + args.batch_size], mis[j : j + args.batch_size]
            t0 = time.perf_counter()
            wavs = model.model.batch_synthesize(
                [np.asarray(m["text"]) for m in sub_mi], flow_embedding=np.asarray(mi0["flow_embedding"]).reshape(-1),
                prompt_text=np.asarray(mi0["prompt_text"]), llm_prompt_speech_token=np.asarray(
                    mi0["llm_prompt_speech_token"]), flow_prompt_speech_token=np.asarray(
                    mi0["flow_prompt_speech_token"]), prompt_speech_feat=np.asarray(
                    mi0["prompt_speech_feat"]).reshape(-1, 80))
            wall = (time.perf_counter() - t0) / len(sub)
            for row, audio in zip(sub, wavs):
                done(row, np.asarray(audio, np.float32).reshape(-1), wall)
    total_wall = time.perf_counter() - t_start
    agg = {"n_utts": len(metrics), "total_audio_s": total_audio, "total_wall_s": total_wall,
           "rtf": total_wall / max(total_audio, 1e-6)}
    (out / "metrics.json").write_text(json.dumps({"aggregate": agg, "per_utt": metrics}, indent=1))
    print(json.dumps(agg))


if __name__ == "__main__":
    main()
