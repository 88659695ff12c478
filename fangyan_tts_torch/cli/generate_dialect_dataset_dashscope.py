"""DashScope (qwen3-tts-flash) dialect dataset generator (the port's copy of
fangyan_tts_tpu/cli/generate_dialect_dataset_dashscope.py, after the
reference's generate_dialect_dataset_dashscope.py): beijing/nanjing/minnan
voices with per-dialect instruct, QPS limiting, Kaldi output + per-dialect
instruct.txt.

Credentials: DASHSCOPE_API_KEY env var. The dashscope SDK is imported only
where it is used; --dry-run builds the Kaldi index without it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

from .generate_dialect_dataset import GlobalRateLimiter, load_aishell_data
from ..data.kaldi_io import write_kaldi_dir, write_scp

logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")
logger = logging.getLogger(__name__)

DIALECT_CONFIG = {
    "beijing": {"voice": "Dylan", "instruct": "请用北京话/儿化音说<|endofprompt|>", "desc": "北京话"},
    "nanjing": {"voice": "Li", "instruct": "请用南京方言说<|endofprompt|>", "desc": "南京话"},
    "minnan": {"voice": "Roy", "instruct": "请用闽南语说<|endofprompt|>", "desc": "闽南语"},
}
AISHELL_FILE = "aishell_transcript_v0.8.txt"


def synthesize(voice: str, text: str, out_path: str, limiter: GlobalRateLimiter) -> bool:
    import dashscope

    limiter.acquire()
    resp = dashscope.audio.qwen_tts.SpeechSynthesizer.call(
        model="qwen3-tts-flash", text=text, voice=voice, api_key=os.environ.get("DASHSCOPE_API_KEY"),
    )
    audio_url = getattr(getattr(resp, "output", None), "audio", {})
    url = audio_url.get("url") if isinstance(audio_url, dict) else getattr(audio_url, "url", None)
    if not url:
        return False
    import requests

    Path(out_path).write_bytes(requests.get(url, timeout=60).content)
    return True


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["all"] + list(DIALECT_CONFIG), default="all")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--input-dir", default="fangyan_text_dataset")
    p.add_argument("--output-dir", default="dataset_dashscope_dialect")
    p.add_argument("--samples-per-dialect", type=int, default=2000)
    p.add_argument("--qps", type=int, default=4)
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)

    aishell = os.path.join(args.input_dir, AISHELL_FILE)
    texts = load_aishell_data(aishell, args.samples_per_dialect) if os.path.exists(aishell) else []
    if not texts:
        logger.error("没有可用文本 (%s)", aishell)
        sys.exit(1)

    dialects = list(DIALECT_CONFIG) if args.mode == "all" else [args.mode]
    limiter = GlobalRateLimiter(args.qps)
    for dialect in dialects:
        conf = DIALECT_CONFIG[dialect]
        d = Path(args.output_dir) / dialect
        (d / "wavs").mkdir(parents=True, exist_ok=True)
        wav_scp, text_map, utt2spk, instruct = {}, {}, {}, {}
        for i, text in enumerate(texts[: args.samples_per_dialect]):
            utt = f"{dialect}_{i:05d}"
            wav_scp[utt] = str((d / "wavs" / f"{utt}.wav").resolve())
            text_map[utt] = text
            utt2spk[utt] = f"speaker_{dialect}"
            instruct[utt] = conf["instruct"]
        write_kaldi_dir(d, wav_scp, text_map, utt2spk, instruct)
        write_scp(d / "instruct.txt", instruct)
        logger.info("[%s] 索引 %d 条", conf["desc"], len(wav_scp))
        if args.dry_run:
            continue
        try:
            import dashscope  # noqa: F401
        except ImportError:
            logger.error("dashscope SDK 不可用 — 仅生成索引 (等价 --dry-run)")
            continue
        jobs = [(conf["voice"], text_map[u], wav_scp[u]) for u in wav_scp if not os.path.exists(wav_scp[u])]
        ok = 0
        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            futs = [ex.submit(synthesize, v, t, o, limiter) for v, t, o in jobs]
            for f in as_completed(futs):
                ok += bool(f.result())
        logger.info("[%s] 合成完成 %d/%d", conf["desc"], ok, len(jobs))


if __name__ == "__main__":
    main()
