"""Emotion dataset generator with ASR transcription (the port's copy of
fangyan_tts_tpu/cli/generate_emotion_dataset.py, after the reference's
generate_emotion_dataset.py).

Scans CASIA/CSED-style emotion wav trees, transcribes with a pluggable ASR
backend, groups positive/neutral, writes Kaldi files + per-group
instruct.txt + a transcription cache.

ASR backends: `funasr` (the reference's paraformer-zh + fsmn-vad + ct-punc,
used when the funasr package is installed; imported only there) or `none`
(emit empty text; useful to build the index and fill transcripts later).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.kaldi_io import write_kaldi_dir, write_scp

# source layout: name -> (glob pattern, emotion-from-path extractor)
EMOTION_SOURCES = {
    "casia": {"pattern": "**/*.wav", "emotions": ["angry", "fear", "happy", "neutral", "sad", "surprise"]},
    "csed": {"pattern": "**/*.wav", "emotions": ["positive", "neutral", "negative"]},
}

POSITIVE = {"happy", "surprise", "positive"}
GROUP_INSTRUCT = {
    "positive": "请用非常开心的语气说。<|endofprompt|>",
    "neutral": "请用平静的语气说。<|endofprompt|>",
}


class ASREngine:
    """funasr paraformer wrapper (generate_emotion_dataset.py:73-117)."""

    def __init__(self, backend: str = "auto"):
        self.model = None
        if backend in ("auto", "funasr"):
            try:
                from funasr import AutoModel

                self.model = AutoModel(model="paraformer-zh", vad_model="fsmn-vad", punc_model="ct-punc")
            except ImportError:
                if backend == "funasr":
                    raise
                print("⚠️ funasr 不可用 — 文本留空 (--asr none 行为)")

    def transcribe(self, wav_path: str) -> str:
        if self.model is None:
            return ""
        try:
            result = self.model.generate(input=wav_path)
            return result[0]["text"] if result else ""
        except Exception as e:  # noqa: BLE001
            print(f"  ⚠️ ASR失败 {wav_path}: {e}")
            return ""


def classify_emotion(path: Path) -> str | None:
    parts = [p.lower() for p in path.parts]
    for p in parts:
        for emo_set, label in ((POSITIVE, "positive"), ({"neutral"}, "neutral")):
            if p in emo_set:
                return label
    return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="情感数据集生成 (ASR转写)")
    parser.add_argument("--source-dirs", nargs="+", required=True)
    parser.add_argument("--output-dir", default="dataset_emotion/generated")
    parser.add_argument("--asr", choices=["auto", "funasr", "none"], default="auto")
    parser.add_argument("--cache", default=None, help="转写缓存 json (默认 output-dir/asr_cache.json)")
    args = parser.parse_args(argv)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cache_path = Path(args.cache) if args.cache else out / "asr_cache.json"
    cache: dict[str, str] = {}
    if cache_path.exists():
        cache = json.loads(cache_path.read_text(encoding="utf-8"))

    asr = ASREngine("none" if args.asr == "none" else args.asr)
    wav_scp, text, utt2spk, instruct = {}, {}, {}, {}
    groups: dict[str, list[str]] = {"positive": [], "neutral": []}

    for src in args.source_dirs:
        src_path = Path(src)
        for wav in sorted(src_path.glob("**/*.wav")):
            group = classify_emotion(wav.relative_to(src_path))
            if group is None:
                continue
            uid = f"emo_{src_path.name}_{wav.stem}"
            wav_key = str(wav.resolve())
            if wav_key not in cache:
                cache[wav_key] = asr.transcribe(wav_key)
            wav_scp[uid] = wav_key
            text[uid] = cache[wav_key]
            utt2spk[uid] = f"emo_{src_path.name}"
            instruct[uid] = GROUP_INSTRUCT[group]
            groups[group].append(uid)

    cache_path.write_text(json.dumps(cache, ensure_ascii=False, indent=2), encoding="utf-8")
    write_kaldi_dir(out, wav_scp, text, utt2spk, instruct)
    for group, utts in groups.items():
        write_scp(out / f"instruct_{group}.txt", {u: GROUP_INSTRUCT[group] for u in utts})
    print(f"✅ positive {len(groups['positive'])} 条, neutral {len(groups['neutral'])} 条 -> {out}")


if __name__ == "__main__":
    main()
