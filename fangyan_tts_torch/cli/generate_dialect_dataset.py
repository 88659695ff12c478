"""Dialect TTS dataset generator (the port's copy of
fangyan_tts_tpu/cli/generate_dialect_dataset.py, after the reference's
generate_dialect_dataset.py).

Flag-compatible surface (--mode/--dry-run/--output-dir/--input-dir/--qps)
plus a pluggable synthesis backend:

- `--backend volcengine`: HTTP parity path — same request json, multi-account
  round-robin, global sliding-window QPS limiter, 3x retry, skip-if-exists.
  Credentials come ONLY from environment variables / .env
  (VOLC_APPID_<n>, VOLC_TOKEN_<n>, VOLC_CLUSTER, VOLC_API_URL).
- `--backend cuda` (the JAX package's `--backend tpu`): batched CosyVoice3
  synthesis on the card in place of the external API: one model, the
  per-dialect instruct text, prompt voices from --prompt-wav-dir/<dialect>.wav,
  texts sorted by length into batches of 16 through
  `CosyVoice3TTS.batch_synthesize`, 24 kHz WAVs, skip-if-exists. It runs on
  CUDA unless `--device cpu` is given.

Sampling/caching behavior matches the reference: 2000 AIShell transcripts
per dialect + the dialect text file, cached in dataset_cache.json so reruns
are reproducible; Kaldi files (wav.scp/text/utt2spk/spk2utt) with absolute
audio paths.

Run: python -m fangyan_tts_torch.cli.generate_dialect_dataset --mode hunan \
       --backend cuda --model-dir <dir> --prompt-wav-dir <dir> --output-dir out
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import random
import sys
import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import asdict, dataclass
from pathlib import Path

logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
logger = logging.getLogger(__name__)

DIALECT_CONFIG = {
    "hunan": {"voice": "BV216_streaming", "speaker": "speaker_hunan", "text_file": "hunan.txt", "desc": "湖南话"},
    "henan": {"voice": "BV214_streaming", "speaker": "speaker_henan", "text_file": "henan.txt", "desc": "河南话"},
    "cantonese": {"voice": "BV026_streaming", "speaker": "speaker_cantonese", "text_file": "cantonese.txt", "desc": "粤语"},
    "tianjin": {"voice": "BV212_streaming", "speaker": "speaker_tianjin", "text_file": "tianjin.txt", "desc": "天津话"},
    "sichuan": {"voice": "BV019_streaming", "speaker": "speaker_sichuan", "text_file": "sichuan.txt", "desc": "川渝话"},
    "zhengzhou": {"voice": "BV214_streaming", "speaker": "speaker_zhengzhou", "text_file": "zhengzhou.txt", "desc": "郑州话"},
    "hunan_pu": {"voice": "BV226_streaming", "speaker": "speaker_hunan_pu", "text_file": "hunan_pu.txt", "desc": "湖南普通话"},
    "dongbei": {"voice": "BV021_streaming", "speaker": "speaker_dongbei", "text_file": "dongbei.txt", "desc": "东北话"},
    "xian": {"voice": "BV210_streaming", "speaker": "speaker_xian", "text_file": "xian.txt", "desc": "西安话"},
    "shanghai": {"voice": "BV217_streaming", "speaker": "speaker_shanghai", "text_file": "shanghai.txt", "desc": "上海话"},
    "guangxi": {"voice": "BV213_streaming", "speaker": "speaker_guangxi", "text_file": "guangxi.txt", "desc": "广西普通话"},
}

AISHELL_FILE = "aishell_transcript_v0.8.txt"
AISHELL_PER_DIALECT_COUNT = 2000
MAX_RETRIES = 3
RETRY_DELAY = 2
REQUEST_TIMEOUT = 30

INSTRUCT_BY_DIALECT = {
    "hunan": "请用湖南话说。<|endofprompt|>", "henan": "请用河南话说。<|endofprompt|>",
    "cantonese": "请用粤语说。<|endofprompt|>", "tianjin": "请用天津话说。<|endofprompt|>",
    "sichuan": "请用四川话说。<|endofprompt|>", "zhengzhou": "请用郑州话说。<|endofprompt|>",
    "hunan_pu": "请用湖南普通话说。<|endofprompt|>", "dongbei": "请用东北话说。<|endofprompt|>",
    "xian": "请用西安话说。<|endofprompt|>", "shanghai": "请用上海话说。<|endofprompt|>",
    "guangxi": "请用广西话说。<|endofprompt|>",
}


@dataclass
class TextItem:
    utt_id: str
    text: str
    speaker_id: str
    voice_type: str
    dialect: str


class GlobalRateLimiter:
    """Sliding 1-second-window QPS limiter, thread-safe
    (generate_dialect_dataset.py:186-212)."""

    def __init__(self, qps: int):
        self.qps = qps
        self.timestamps: deque = deque()
        self.lock = threading.Lock()

    def acquire(self) -> None:
        with self.lock:
            now = time.time()
            while self.timestamps and self.timestamps[0] < now - 1.0:
                self.timestamps.popleft()
            if len(self.timestamps) >= self.qps:
                sleep_time = 1.0 - (now - self.timestamps[0])
                if sleep_time > 0:
                    time.sleep(sleep_time)
                    now = time.time()
                    while self.timestamps and self.timestamps[0] < now - 1.0:
                        self.timestamps.popleft()
            self.timestamps.append(now)


def load_aishell_data(file_path: str, count: int) -> list[str]:
    texts = []
    with open(file_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if count > 0 and i >= count:
                break
            parts = line.strip().split(maxsplit=1)
            if len(parts) >= 2:
                text = parts[1].replace(" ", "")
                if text:
                    texts.append(text)
    logger.info("从 %s 加载了 %d 条数据", file_path, len(texts))
    return texts


def load_dialect_data(file_path: str) -> list[str]:
    with open(file_path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def prepare_dataset(input_dir: str, output_dir: str, audio_ext: str = "mp3") -> dict[str, list[TextItem]]:
    """Cache-or-sample (generate_dialect_dataset.py:275-425)."""
    cache_file = os.path.join(output_dir, "dataset_cache.json")
    os.makedirs(output_dir, exist_ok=True)
    if os.path.exists(cache_file):
        logger.info("发现数据集缓存文件，正在加载: %s", cache_file)
        try:
            with open(cache_file, encoding="utf-8") as f:
                cache = json.load(f)
            return {d: [TextItem(**item) for item in items] for d, items in cache.items()}
        except (json.JSONDecodeError, TypeError, KeyError) as e:
            logger.warning("缓存加载失败: %s，将重新生成数据集", e)

    aishell_path = os.path.join(input_dir, AISHELL_FILE)
    aishell_texts = load_aishell_data(aishell_path, -1) if os.path.exists(aishell_path) else []
    if not aishell_texts:
        logger.warning("未找到 %s — 仅使用方言文本文件", AISHELL_FILE)

    dataset: dict[str, list[TextItem]] = {}
    for dialect, conf in DIALECT_CONFIG.items():
        items: list[TextItem] = []
        idx = 0
        if aishell_texts:
            sample_count = min(len(aishell_texts), AISHELL_PER_DIALECT_COUNT)
            for text in random.sample(aishell_texts, sample_count):
                items.append(TextItem(f"{dialect}_{idx:05d}", text, conf["speaker"], conf["voice"], dialect))
                idx += 1
        dialect_file = os.path.join(input_dir, conf["text_file"])
        if os.path.exists(dialect_file):
            for text in load_dialect_data(dialect_file):
                items.append(TextItem(f"{dialect}_{idx:05d}", text, conf["speaker"], conf["voice"], dialect))
                idx += 1
        else:
            logger.warning("[%s] 方言文本不存在: %s", conf["desc"], dialect_file)
        dataset[dialect] = items
        logger.info("[%s] 共 %d 条", conf["desc"], len(items))

    with open(cache_file, "w", encoding="utf-8") as f:
        json.dump({d: [asdict(i) for i in items] for d, items in dataset.items()}, f, ensure_ascii=False, indent=2)
    logger.info("数据集缓存已保存: %s", cache_file)
    return dataset


def generate_kaldi_files(items: list[TextItem], output_dir: str, dialect: str, audio_ext: str = "mp3") -> None:
    """wav.scp/text/utt2spk/spk2utt with absolute audio paths
    (generate_dialect_dataset.py:619-669)."""
    d = Path(output_dir) / dialect
    d.mkdir(parents=True, exist_ok=True)
    spk2utt: dict[str, list[str]] = {}
    with open(d / "wav.scp", "w", encoding="utf-8") as wf, \
         open(d / "text", "w", encoding="utf-8") as tf, \
         open(d / "utt2spk", "w", encoding="utf-8") as uf:
        for item in items:
            wav_abs = os.path.abspath(d / "wavs" / f"{item.utt_id}.{audio_ext}")
            wf.write(f"{item.utt_id} {wav_abs}\n")
            tf.write(f"{item.utt_id} {item.text}\n")
            uf.write(f"{item.utt_id} {item.speaker_id}\n")
            spk2utt.setdefault(item.speaker_id, []).append(item.utt_id)
    with open(d / "spk2utt", "w", encoding="utf-8") as sf:
        for spk, utts in spk2utt.items():
            sf.write(f"{spk} {' '.join(utts)}\n")
    logger.info("[%s] Kaldi索引文件已生成: %s", dialect, d)


# ---- HTTP (volcengine-compatible) backend -----------------------------------


def load_api_configs() -> list[dict]:
    """Multi-account config from env / .env — never from source."""
    env_file = Path(".env")
    if env_file.exists():
        for line in env_file.read_text().splitlines():
            if "=" in line and not line.startswith("#"):
                k, v = line.split("=", 1)
                os.environ.setdefault(k.strip(), v.strip())
    configs = []
    n = 1
    while True:
        appid = os.environ.get(f"VOLC_APPID_{n}") or (os.environ.get("VOLC_APPID") if n == 1 else None)
        token = os.environ.get(f"VOLC_TOKEN_{n}") or (os.environ.get("VOLC_TOKEN") if n == 1 else None)
        if not appid or not token:
            break
        configs.append(
            {
                "appid": appid,
                "access_token": token,
                "cluster": os.environ.get("VOLC_CLUSTER", "volcano_tts"),
                "api_url": os.environ.get("VOLC_API_URL", "https://openspeech.bytedance.com/api/v1/tts"),
            }
        )
        n += 1
    return configs


def synthesize_single_http(item: TextItem, output_dir: str, api_config: dict, rate_limiter: GlobalRateLimiter) -> tuple[bool, str]:
    import requests

    wav_dir = Path(output_dir) / item.dialect / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    out = wav_dir / f"{item.utt_id}.mp3"
    if out.exists():
        return True, "SKIPPED"
    request_json = {
        "app": {"appid": api_config["appid"], "token": "access_token", "cluster": api_config["cluster"]},
        "user": {"uid": "dialect_dataset_generator"},
        "audio": {"voice_type": item.voice_type, "encoding": "mp3", "speed_ratio": 1.0, "volume_ratio": 1.0, "pitch_ratio": 1.0},
        "request": {"reqid": str(uuid.uuid4()), "text": item.text, "text_type": "plain", "operation": "query", "with_frontend": 1, "frontend_type": "unitTson"},
    }
    header = {"Authorization": f"Bearer;{api_config['access_token']}"}
    for attempt in range(MAX_RETRIES):
        try:
            rate_limiter.acquire()
            resp = requests.post(api_config["api_url"], json=request_json, headers=header, timeout=REQUEST_TIMEOUT)
            result = resp.json()
            if "data" in result:
                out.write_bytes(base64.b64decode(result["data"]))
                return True, str(out)
            err = result.get("message", str(result)[:120])
        except Exception as e:  # noqa: BLE001
            err = str(e)[:120]
        if attempt < MAX_RETRIES - 1:
            time.sleep(RETRY_DELAY)
    return False, err


def synthesize_batch_http(items: list[TextItem], output_dir: str, qps: int) -> None:
    configs = load_api_configs()
    if not configs:
        logger.error("未配置 API 凭证 (VOLC_APPID/VOLC_TOKEN env) — 跳过合成。用 --dry-run 只生成索引，或 --backend cuda 本地合成。")
        return
    limiter = GlobalRateLimiter(qps)
    ok = fail = skip = 0
    with ThreadPoolExecutor(max_workers=len(configs)) as ex:
        futures = {ex.submit(synthesize_single_http, it, output_dir, configs[i % len(configs)], limiter): it for i, it in enumerate(items)}
        for i, fut in enumerate(as_completed(futures)):
            success, msg = fut.result()
            ok += success and msg != "SKIPPED"
            skip += msg == "SKIPPED"
            fail += not success
            if (i + 1) % 100 == 0:
                logger.info("进度 %d/%d (成功 %d 跳过 %d 失败 %d)", i + 1, len(items), ok, skip, fail)
    logger.info("合成完成: 成功 %d 跳过 %d 失败 %d", ok, skip, fail)


# ---- CUDA backend ------------------------------------------------------------


def dialect_prompt(model, dialect: str, prompt_wav_dir: str | None) -> dict:
    """batch_synthesize's prompt arguments for one dialect: its instruct text
    with the voice of <prompt_wav_dir>/<dialect>.wav (else default.wav)
    through frontend_instruct2, or the instruct text alone without a prompt
    directory."""
    import numpy as np

    instruct = INSTRUCT_BY_DIALECT.get(dialect, "请用方言说。<|endofprompt|>")
    if not prompt_wav_dir:
        return {
            "prompt_text": np.asarray(model.frontend.extract_text_token(instruct), np.int32),
            "flow_embedding": np.zeros(192, np.float32),
        }
    cand = Path(prompt_wav_dir) / f"{dialect}.wav"
    prompt_wav = str(cand if cand.exists() else Path(prompt_wav_dir) / "default.wav")
    mi = model.frontend.frontend_instruct2("", instruct, prompt_wav)
    return {
        "prompt_text": mi.get("prompt_text", np.zeros(0, np.int32)),
        "flow_prompt_speech_token": mi.get("flow_prompt_speech_token", np.zeros(0, np.int32)),
        "prompt_speech_feat": mi.get("prompt_speech_feat", np.zeros((0, 80), np.float32)),
        "flow_embedding": mi.get("flow_embedding", np.zeros(192, np.float32)),
    }


def synthesize_batch_cuda(
    items: list[TextItem], output_dir: str, model_dir: str, prompt_wav_dir: str | None, batch_size: int = 16,
    device: str | None = None, model=None,
) -> dict:
    """Batched CosyVoice3 synthesis on the card in place of the external API
    (the JAX package's `synthesize_batch_tpu`): utterances ride the batch
    dim through LLM/flow/vocoder in `batch_size` groups, bucketed by text
    length. `model` is a loaded api.CosyVoice3 (else one is loaded from
    model_dir on `device`, CUDA when None). Returns the run's counts and
    times: load_s, synth_s, utts, audio_s, batches."""
    import numpy as np

    from ..api import CosyVoice3
    from ..data.audio import write_wav

    t_load = time.perf_counter()
    if model is None:
        model = CosyVoice3(model_dir, device=device)
    stats = {"load_s": time.perf_counter() - t_load, "synth_s": 0.0, "utts": 0, "audio_s": 0.0, "batches": 0}
    by_dialect: dict[str, list[TextItem]] = {}
    for it in items:
        by_dialect.setdefault(it.dialect, []).append(it)

    for dialect, dialect_items in by_dialect.items():
        wav_dir = Path(output_dir) / dialect / "wavs"
        wav_dir.mkdir(parents=True, exist_ok=True)
        prompt_inputs = dialect_prompt(model, dialect, prompt_wav_dir)
        todo = [it for it in dialect_items if not (wav_dir / f"{it.utt_id}.wav").exists()]
        todo.sort(key=lambda it: len(it.text))  # length-bucket batches
        t0 = time.perf_counter()
        done = 0
        for j in range(0, len(todo), batch_size):
            chunk = todo[j : j + batch_size]
            texts = [np.asarray(model.frontend.extract_text_token(it.text), np.int32) for it in chunk]
            wavs = model.model.batch_synthesize(texts, **prompt_inputs)
            for it, wav in zip(chunk, wavs):
                write_wav(wav_dir / f"{it.utt_id}.wav", wav, model.sample_rate)
                stats["audio_s"] += len(wav) / model.sample_rate
            done += len(chunk)
            stats["batches"] += 1
            logger.info("[%s] %d/%d (%.2f utt/s)", dialect, done, len(todo), done / (time.perf_counter() - t0))
        stats["synth_s"] += time.perf_counter() - t0
        stats["utts"] += done
        logger.info("[%s] 合成完成 %d 条", dialect, done)
    return stats


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser(description="方言TTS数据集生成脚本")
    parser.add_argument("--mode", choices=["all"] + list(DIALECT_CONFIG.keys()), default="all")
    parser.add_argument("--dry-run", action="store_true", help="仅生成索引文件，不合成音频")
    parser.add_argument("--output-dir", default="dataset_new")
    parser.add_argument("--input-dir", default="fangyan_text_dataset")
    parser.add_argument("--qps", type=int, default=5)
    parser.add_argument("--backend", choices=["volcengine", "cuda"], default="volcengine")
    parser.add_argument("--model-dir", default=None, help="cuda backend: CosyVoice3 model dir")
    parser.add_argument("--prompt-wav-dir", default=None, help="cuda backend: per-dialect prompt voices")
    parser.add_argument("--device", default=None, help="cuda backend: torch device (CUDA when not given)")
    args = parser.parse_args(argv)

    audio_ext = "wav" if args.backend == "cuda" else "mp3"
    try:
        dataset = prepare_dataset(args.input_dir, args.output_dir, audio_ext)
    except FileNotFoundError:
        logger.error("数据文件加载失败，请检查文件路径")
        sys.exit(1)

    dialects = list(DIALECT_CONFIG.keys()) if args.mode == "all" else [args.mode]
    all_items: list[TextItem] = []
    for dialect in dialects:
        items = dataset[dialect]
        logger.info("处理 %s 数据集 (%d 条)", dialect.upper(), len(items))
        generate_kaldi_files(items, args.output_dir, dialect, audio_ext)
        all_items.extend(items)

    if args.dry_run:
        logger.info("Dry run — 已生成索引文件，跳过音频合成")
        return None
    if args.backend == "cuda":
        if not args.model_dir:
            logger.error("--backend cuda 需要 --model-dir")
            sys.exit(1)
        return synthesize_batch_cuda(all_items, args.output_dir, args.model_dir, args.prompt_wav_dir,
                                     device=args.device)
    synthesize_batch_http(all_items, args.output_dir, args.qps)
    return None


if __name__ == "__main__":
    main()
