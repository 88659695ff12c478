"""Model-quality evaluation: CER (via ASR) + speaker similarity (CAM++
cosine); the port's copy of fangyan_tts_tpu/cli/evaluate.py, the
Seed-TTS-eval protocol of the reference's quality tables and its GRPO CER
reward:

  1. synthesize every eval pair zero-shot (prompt wav + prompt text ->
     target text), writing <output_dir>/<utt>.wav;
  2. SS: CAM++ x-vector cosine between the prompt audio and the synthesized
     audio (models/campplus.py, on the card unless --device cpu);
  3. CER/WER: transcribe each synthesized wav with a pluggable ASR backend
     (funasr paraformer-zh / whisper, runtime/token2wav_asr_server.py
     make_asr_fn; or a remote --asr_url HTTP endpoint, stdlib) and score
     against the target text with the GRPO edit-distance scorer
     (train/grpo.py cer). If no ASR backend is available the CER column is
     skipped with a clear message — SS still reports.

Eval-list formats (auto-detected):
  - Seed-TTS-eval meta.lst lines:  utt|prompt_text|prompt_wav|target_text
  - jsonl: {"utt", "prompt_text", "prompt_wav", "target_text"}

Usage:
  python -m fangyan_tts_torch.cli.evaluate --model_dir <dir> \
      --eval_list meta.lst --output_dir eval_out [--asr funasr] [--device cpu]
  # score existing wavs only (no synthesis):
  python -m fangyan_tts_torch.cli.evaluate --model_dir <dir> \
      --eval_list meta.lst --output_dir eval_out --score_only
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def load_eval_list(path: str | Path) -> list[dict]:
    """Parse a Seed-TTS-eval meta.lst or a jsonl eval list."""
    pairs = []
    for raw in Path(path).read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("{"):
            d = json.loads(line)
            pairs.append({"utt": d["utt"], "prompt_text": d.get("prompt_text", ""),
                          "prompt_wav": d["prompt_wav"], "target_text": d["target_text"]})
        else:
            parts = line.split("|")
            if len(parts) != 4:
                raise ValueError(f"bad meta.lst line (want utt|prompt_text|prompt_wav|target_text): {line!r}")
            pairs.append({"utt": parts[0], "prompt_text": parts[1],
                          "prompt_wav": parts[2], "target_text": parts[3]})
    return pairs


def normalize_for_cer(text: str, lang: str) -> list[str]:
    """Seed-TTS-eval style scoring units: zh -> characters with punctuation/
    whitespace stripped; en -> lowercase words with punctuation stripped."""
    import re
    import unicodedata

    kept = "".join(c for c in text if not unicodedata.category(c).startswith("P"))
    if lang == "en":
        return re.sub(r"\s+", " ", kept.lower()).strip().split()
    return [c for c in kept if not c.isspace()]


def _detect_lang(text: str) -> str:
    return "zh" if any("一" <= c <= "鿿" for c in text) else "en"


def score_cer(ref_text: str, hyp_text: str, lang: str = "auto") -> float:
    """Edit-distance error rate over normalized units (chars zh / words en)."""
    from ..train.grpo import cer

    lang = _detect_lang(ref_text) if lang == "auto" else lang
    # grpo.cer edit-distances any sequence (list() is identity on the
    # normalized unit lists): chars for zh, words for en
    return float(cer(normalize_for_cer(ref_text, lang),
                     normalize_for_cer(hyp_text, lang)))


def speaker_similarity(frontend, wav_a_16k: np.ndarray, wav_b_16k: np.ndarray) -> float:
    """CAM++ x-vector cosine in [-1, 1] (models/campplus.py; the embedding
    the reference extracts per utterance in data prep stage 1)."""
    ea = np.asarray(frontend.extract_spk_embedding(wav_a_16k), np.float64)
    eb = np.asarray(frontend.extract_spk_embedding(wav_b_16k), np.float64)
    # clamp (not add) the eps: adding would swamp small-norm embeddings and
    # report cos(x, x) < 1
    ea = ea / max(np.linalg.norm(ea), 1e-30)
    eb = eb / max(np.linalg.norm(eb), 1e-30)
    return float(np.dot(ea, eb))


def make_asr(backend: str, asr_url: str | None):
    """ASR hook: 'funasr'/'whisper' via the reward server's pluggable
    backends, 'http' via a remote /asr endpoint, 'none' -> None (skip CER)."""
    if backend == "none":
        return None
    if backend == "http":
        import base64
        import io
        import urllib.request
        import wave

        def fn(wav: np.ndarray, sr: int) -> str:
            buf = io.BytesIO()
            pcm = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(pcm.tobytes())
            payload = json.dumps({"wav_b64": base64.b64encode(buf.getvalue()).decode(),
                                  "text": ""}).encode()
            req = urllib.request.Request(asr_url, data=payload,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())["text"]

        return fn
    from ..runtime.token2wav_asr_server import make_asr_fn

    return make_asr_fn(backend)


def run_eval(model_dir: str, pairs: list[dict], output_dir: str | Path,
             asr_fn=None, score_only: bool = False, lang: str = "auto",
             model=None, stream: bool = False, device: str | None = None) -> dict:
    """Synthesize (unless score_only with existing wavs) then score. `model`
    is a loaded api model; else AutoModel(model_dir) is loaded on `device`
    (CUDA when None).

    Returns {"per_utt": [...], "cer": mean or None, "ss": mean} and writes
    results.jsonl + summary.json under output_dir."""
    from ..data.audio import load_audio, write_wav

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    if model is None:
        from ..api import AutoModel

        model = AutoModel(model_dir, device=device)
    fe = model.frontend
    sr = model.sample_rate if hasattr(model, "sample_rate") else model.model.cfg.sample_rate

    results = []
    for p in pairs:
        wav_path = out / f"{p['utt']}.wav"
        if not (score_only and wav_path.exists()):
            chunks = [o["tts_speech"] for o in model.inference_zero_shot(
                p["target_text"], p["prompt_text"], p["prompt_wav"], stream=stream)]
            audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
            write_wav(wav_path, audio.astype(np.float32), sr)
        syn_16k, _ = load_audio(wav_path, target_sr=16000)
        prm_16k, _ = load_audio(p["prompt_wav"], target_sr=16000)
        row = {"utt": p["utt"], "wav": str(wav_path),
               "ss": speaker_similarity(fe, prm_16k, syn_16k)}
        if asr_fn is not None:
            hyp = asr_fn(syn_16k, 16000)
            row["hyp"] = hyp
            row["cer"] = score_cer(p["target_text"], hyp, lang=lang)
        results.append(row)
        print(f"[evaluate] {p['utt']}: ss={row['ss']:.3f}"
              + (f" cer={row['cer']:.3f} hyp={row.get('hyp', '')!r}" if "cer" in row else ""),
              file=sys.stderr, flush=True)

    summary = {
        "n": len(results),
        "ss": float(np.mean([r["ss"] for r in results])) if results else None,
        "cer": (float(np.mean([r["cer"] for r in results]))
                if results and "cer" in results[0] else None),
    }
    with open(out / "results.jsonl", "w", encoding="utf-8") as f:
        for r in results:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    (out / "summary.json").write_text(json.dumps(summary, ensure_ascii=False))
    return {"per_utt": results, **summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--eval_list", required=True,
                    help="Seed-TTS-eval meta.lst (utt|prompt_text|prompt_wav|target_text) or jsonl")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--asr", default="funasr", choices=["funasr", "whisper", "http", "none"],
                    help="ASR backend for CER ('none' skips CER, SS still reports)")
    ap.add_argument("--asr_url", default=None, help="remote /asr endpoint for --asr http")
    ap.add_argument("--lang", default="auto", choices=["auto", "zh", "en"])
    ap.add_argument("--score_only", action="store_true",
                    help="skip synthesis for utts whose wav already exists")
    ap.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    args = ap.parse_args(argv)

    pairs = load_eval_list(args.eval_list)
    try:
        asr_fn = make_asr(args.asr, args.asr_url)
    except RuntimeError as e:
        print(f"[evaluate] ASR backend unavailable ({e}); skipping CER — "
              f"SS (CAM++ cosine) still reported", file=sys.stderr)
        asr_fn = None
    summary = run_eval(args.model_dir, pairs, args.output_dir,
                       asr_fn=asr_fn, score_only=args.score_only, lang=args.lang, device=args.device)
    print(json.dumps({k: summary[k] for k in ("n", "cer", "ss")}, ensure_ascii=False))


if __name__ == "__main__":
    main()
