"""ESD emotion dataset converter (the port's copy of
fangyan_tts_tpu/cli/generate_esd_dataset.py, after the reference's
generate_esd_dataset.py).

Walks ESD/<speaker>/{Happy,Surprise,Neutral} wav trees, maps each emotion to
a Chinese instruct, and writes Kaldi files + per-utterance instruct (the
reference's emotion->instruct map and output layout)."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.kaldi_io import write_kaldi_dir, write_scp

EMOTION_INSTRUCT_MAP = {
    "Happy": "请用非常开心的语气说。<|endofprompt|>",
    "Surprise": "请用非常惊讶的语气说。<|endofprompt|>",
    "Neutral": "请用平静的语气说。<|endofprompt|>",
    "Sad": "请用非常伤心的语气说。<|endofprompt|>",
    "Angry": "请用非常生气的语气说。<|endofprompt|>",
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="ESD情感数据集转换")
    parser.add_argument("--esd-dir", required=True, help="ESD 根目录 (ESD/<spk>/<Emotion>/*.wav)")
    parser.add_argument("--output-dir", default="dataset_emotion/esd")
    parser.add_argument("--emotions", nargs="*", default=["Happy", "Surprise", "Neutral"])
    args = parser.parse_args(argv)

    esd = Path(args.esd_dir)
    out = Path(args.output_dir)
    wav_scp, text, utt2spk, instruct = {}, {}, {}, {}

    # ESD layout: <spk>/<spk>.txt holds "utt\ttext\temotion" lines;
    # wavs under <spk>/<Emotion>/.
    for spk_dir in sorted(p for p in esd.iterdir() if p.is_dir()):
        spk = spk_dir.name
        transcripts: dict[str, str] = {}
        tfile = spk_dir / f"{spk}.txt"
        if tfile.exists():
            for line in tfile.read_text(encoding="utf-8", errors="replace").splitlines():
                parts = line.strip().split("\t")
                if len(parts) >= 2:
                    transcripts[parts[0]] = parts[1]
        for emotion in args.emotions:
            emo_dir = spk_dir / emotion
            if not emo_dir.exists():
                continue
            for wav in sorted(emo_dir.glob("**/*.wav")):
                utt = wav.stem
                uid = f"esd_{spk}_{emotion.lower()}_{utt}"
                wav_scp[uid] = str(wav.resolve())
                text[uid] = transcripts.get(utt, "")
                utt2spk[uid] = f"esd_{spk}"
                instruct[uid] = EMOTION_INSTRUCT_MAP[emotion]

    write_kaldi_dir(out, wav_scp, text, utt2spk, instruct)
    # the reference also writes instruct.txt
    write_scp(out / "instruct.txt", instruct)
    print(f"✅ 共 {len(wav_scp)} 条 -> {out}")


if __name__ == "__main__":
    main()
