"""Volcengine (Doubao) TTS API smoke test (the port's copy of
fangyan_tts_tpu/cli/doubao_tts.py, after the reference's doubao_tts.py):
one-shot synthesis request -> test_submit.mp3. Credentials from env/.env
(VOLC_APPID/VOLC_TOKEN) — never embedded in source. `requests` is imported
only where it is used."""

from __future__ import annotations

import argparse
import base64
import sys
import uuid


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--text", default="你好，这是一条测试语音。")
    p.add_argument("--voice", default="BV001_streaming")
    p.add_argument("--output", default="test_submit.mp3")
    args = p.parse_args(argv)

    from .generate_dialect_dataset import load_api_configs

    configs = load_api_configs()
    if not configs:
        print("❌ 未配置 VOLC_APPID/VOLC_TOKEN 环境变量")
        sys.exit(1)
    cfg = configs[0]

    import requests

    req = {
        "app": {"appid": cfg["appid"], "token": "access_token", "cluster": cfg["cluster"]},
        "user": {"uid": "doubao_tts_smoke"},
        "audio": {"voice_type": args.voice, "encoding": "mp3", "speed_ratio": 1.0, "volume_ratio": 1.0, "pitch_ratio": 1.0},
        "request": {"reqid": str(uuid.uuid4()), "text": args.text, "text_type": "plain", "operation": "query", "with_frontend": 1, "frontend_type": "unitTson"},
    }
    resp = requests.post(cfg["api_url"], json=req, headers={"Authorization": f"Bearer;{cfg['access_token']}"}, timeout=30)
    result = resp.json()
    if "data" in result:
        with open(args.output, "wb") as f:
            f.write(base64.b64decode(result["data"]))
        print(f"✅ 已保存 {args.output}")
    else:
        print(f"❌ 请求失败: {result}")
        sys.exit(1)


if __name__ == "__main__":
    main()
