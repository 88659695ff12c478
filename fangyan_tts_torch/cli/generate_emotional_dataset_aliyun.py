"""Aliyun NLS emotional dataset generator (the port's copy of
fangyan_tts_tpu/cli/generate_emotional_dataset_aliyun.py, after the
reference's generate_emotional_dataset_aliyun.py): 7 emo voices x 6 SSML
emotion categories, per-utterance instruct, Kaldi output, concurrent
synthesis with QPS limiting, resume (skip existing wavs), and AK/SK ->
NLS-token auto-fetch.

Token auto-fetch is on the stdlib: the Aliyun RPC CreateToken call is a
signed HTTPS GET (HMAC-SHA1 over the canonicalized query, per the public POP
protocol), so no aliyunsdkcore install is needed. The NLS synthesis itself
needs the alibabacloud-nls SDK (websocket streaming), imported only where
it is used; --dry-run builds the full Kaldi index without it.

Credentials: --token, or ALIYUN_AK_ID / ALIYUN_AK_SECRET (auto-fetch), plus
ALIYUN_APP_KEY / --appkey.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import hmac
import json
import logging
import os
import sys
import threading
import time
import urllib.parse
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass
from pathlib import Path

from ..data.kaldi_io import write_kaldi_dir, write_scp
from .generate_dialect_dataset import GlobalRateLimiter, load_aishell_data

logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")
logger = logging.getLogger(__name__)

VOICE_POOL = ["zhifeng_emo", "zhibing_emo", "zhimiao_emo", "zhimi_emo", "zhiyan_emo", "zhibei_emo", "zhitian_emo"]

EMOTION_CONFIG = {
    "happy": {"ssml": {"category": "happy", "intensity": "1.0"}, "instruct": "请用开心高兴的语气说<|endofprompt|>", "desc": "开心"},
    "sad": {"ssml": {"category": "sad", "intensity": "1.0"}, "instruct": "请用悲伤难过的语气说<|endofprompt|>", "desc": "悲伤"},
    "angry": {"ssml": {"category": "angry", "intensity": "1.0"}, "instruct": "请用愤怒生气的语气说<|endofprompt|>", "desc": "愤怒"},
    "surprise": {"ssml": {"category": "surprise", "intensity": "1.0"}, "instruct": "请用惊讶吃惊的语气说<|endofprompt|>", "desc": "惊讶"},
    "fear": {"ssml": {"category": "fear", "intensity": "1.0"}, "instruct": "请用害怕恐惧的语气说<|endofprompt|>", "desc": "恐惧"},
    "neutral": {"ssml": {"category": "neutral", "intensity": "1.0"}, "instruct": "请用平时正常的语气说<|endofprompt|>", "desc": "中立"},
}


def clean_text(text: str) -> str:
    return text.replace(" ", "").strip()


def ssml_text(text: str, ssml: dict) -> str:
    return f"<speak><emotion category=\"{ssml['category']}\" intensity=\"{ssml['intensity']}\">{text}</emotion></speak>"


# ------------------------------------------------- AK/SK -> token auto-fetch


def _pop_signature(params: dict, ak_secret: str) -> str:
    """Aliyun POP RPC signature: HMAC-SHA1 over
    'GET&%2F&' + percent-encoded canonicalized query (public protocol)."""

    def enc(s: str) -> str:
        return urllib.parse.quote(s, safe="~")

    canon = "&".join(f"{enc(k)}={enc(str(params[k]))}" for k in sorted(params))
    to_sign = "GET&%2F&" + enc(canon)
    digest = hmac.new((ak_secret + "&").encode(), to_sign.encode(), hashlib.sha1).digest()
    return base64.b64encode(digest).decode()


def fetch_token(ak_id: str, ak_secret: str, region: str = "cn-shanghai") -> str | None:
    """CreateToken via signed HTTPS GET (reference fetch_token, :149-178 —
    which requires aliyunsdkcore; this is SDK-free)."""
    params = {
        "AccessKeyId": ak_id,
        "Action": "CreateToken",
        "Format": "JSON",
        "RegionId": region,
        "SignatureMethod": "HMAC-SHA1",
        "SignatureNonce": str(uuid.uuid4()),
        "SignatureVersion": "1.0",
        "Timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "Version": "2019-02-28",
    }
    params["Signature"] = _pop_signature(params, ak_secret)
    url = f"https://nls-meta.{region}.aliyuncs.com/?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            jss = json.loads(r.read())
        if "Token" in jss and "Id" in jss["Token"]:
            expire = jss["Token"]["ExpireTime"]
            logger.info("Token获取成功! 过期时间: %s", time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(expire)))
            return jss["Token"]["Id"]
        logger.error("获取Token失败，响应: %s", jss)
    except OSError as e:
        logger.error("获取Token异常: %s", e)
    return None


# ------------------------------------------------------------ NLS synthesis


@dataclass
class GenTask:
    utt_id: str
    text: str
    emotion_key: str
    voice: str
    instruct: str
    output_path: str


class TtsCallback:
    """nls.SpeechSynthesizer callback sink (reference TtsCallback, :182-218)."""

    def __init__(self, output_path: str):
        self.output_path = output_path
        self.f = None
        self.error_msg = None
        self.success = False
        self._done = threading.Event()

    def on_metainfo(self, message, *args):
        pass

    def on_error(self, message, *args):
        logger.error("TTS Error: %s", message)
        self.error_msg = message
        self._done.set()

    def on_close(self, *args):
        if self.f:
            self.f.close()
            self.f = None
        self.success = True
        self._done.set()

    def on_data(self, data, *args):
        if self.f is None:
            self.f = open(self.output_path, "wb")
        self.f.write(data)

    def on_completed(self, message, *args):
        self._done.set()

    def wait(self):
        self._done.wait()


def process_task(task: GenTask, appkey: str, token: str, limiter: GlobalRateLimiter) -> bool:
    """One synthesis call (reference process_task, :293-343); nls is gated."""
    import nls  # noqa: PLC0415  (alibabacloud-nls, dependency-gated)

    limiter.acquire()
    cb = TtsCallback(task.output_path)
    synth_cls = getattr(nls, "NlsSpeechSynthesizer", None) or nls.SpeechSynthesizer
    tts = synth_cls(
        url="wss://nls-gateway-cn-shanghai.aliyuncs.com/ws/v1",
        token=token,
        appkey=appkey,
        on_metainfo=cb.on_metainfo,
        on_data=cb.on_data,
        on_completed=cb.on_completed,
        on_error=cb.on_error,
        on_close=cb.on_close,
    )
    tts.start(
        ssml_text(clean_text(task.text), EMOTION_CONFIG[task.emotion_key]["ssml"]),
        voice=task.voice,
        aformat="wav",
        sample_rate=24000,
        wait_complete=False,
    )
    cb.wait()
    # only error_msg decides failure: on_completed can fire before on_close
    # sets success (the reference checks the same way, :327-337)
    if cb.error_msg:
        if cb.f:
            cb.f.close()
            cb.f = None
        if os.path.exists(task.output_path):
            os.remove(task.output_path)
        return False
    return True


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--input-dir", default="fangyan_text_dataset")
    p.add_argument("--output-dir", default="dataset_aliyun_emotion")
    p.add_argument("--samples-per-emotion", type=int, default=300)
    p.add_argument("--qps", type=int, default=2)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--emotions", nargs="*", default=list(EMOTION_CONFIG))
    p.add_argument("--appkey", default=os.environ.get("ALIYUN_APP_KEY"))
    p.add_argument("--token", default=None, help="NLS AccessToken (else auto-fetch from AK/SK env)")
    args = p.parse_args(argv)

    aishell = os.path.join(args.input_dir, "aishell_transcript_v0.8.txt")
    texts = load_aishell_data(aishell, -1) if os.path.exists(aishell) else []
    if not texts:
        logger.error("没有可用文本 (%s)", aishell)
        sys.exit(1)

    token = args.token
    if not token and not args.dry_run:
        ak_id, ak_secret = os.environ.get("ALIYUN_AK_ID"), os.environ.get("ALIYUN_AK_SECRET")
        if ak_id and ak_secret:
            token = fetch_token(ak_id, ak_secret)
        if not token:
            logger.error("无 Token 且无法自动获取 (需要 --token 或 ALIYUN_AK_ID/ALIYUN_AK_SECRET) — 回退 --dry-run")
            args.dry_run = True

    limiter = GlobalRateLimiter(args.qps)
    for emotion in args.emotions:
        conf = EMOTION_CONFIG[emotion]
        d = Path(args.output_dir) / emotion
        (d / "wavs").mkdir(parents=True, exist_ok=True)
        wav_scp, text_map, utt2spk, instruct, tasks = {}, {}, {}, {}, []
        for i, text in enumerate(texts[: args.samples_per_emotion]):
            voice = VOICE_POOL[i % len(VOICE_POOL)]
            utt = f"{emotion}_{voice}_{i:05d}"
            path = str((d / "wavs" / f"{utt}.wav").resolve())
            wav_scp[utt] = path
            text_map[utt] = text
            utt2spk[utt] = voice
            instruct[utt] = conf["instruct"]
            if not os.path.exists(path):  # resume: skip already-synthesized
                tasks.append(GenTask(utt, text, emotion, voice, conf["instruct"], path))
        write_kaldi_dir(d, wav_scp, text_map, utt2spk, instruct)
        write_scp(d / "instruct.txt", instruct)
        logger.info("[%s] 索引 %d 条, 待合成 %d 条", conf["desc"], len(wav_scp), len(tasks))
        if args.dry_run or not tasks:
            continue
        try:
            import nls  # noqa: F401
        except ImportError:
            logger.error("alibabacloud-nls SDK 不可用 — 仅生成索引 (等价 --dry-run)")
            continue
        ok = fail = 0
        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            futures = {ex.submit(process_task, t, args.appkey, token, limiter): t for t in tasks}
            for fut in as_completed(futures):
                if fut.result():
                    ok += 1
                else:
                    fail += 1
        logger.info("[%s] 合成完成 %d 成功 / %d 失败", conf["desc"], ok, fail)


if __name__ == "__main__":
    main()
