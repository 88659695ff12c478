"""Fine-tune before/after comparison CLI (the port's copy of
fangyan_tts_tpu/cli/compare_inference.py, after the reference's
compare_inference.py).

Same flags (--pretrained_dir/--finetuned_llm/--prompt_wav/--output_dir) and
output layout (<dialect>_<i>_{original,finetuned}.wav); loads the model
twice — pristine, then with the fine-tuned LLM checkpoint loaded into
`model.model.llm` by `load_state_dict` (a `.msgpack` parameter tree, or a
reference `.pt` state dict with its epoch/step entries dropped) — and
synthesizes 10 sentences per dialect + mandarin via inference_instruct2.
It runs on CUDA unless `--device cpu` is given.

The test sentences are this framework's own set (the reference's texts are
arbitrary New-Year greetings; any fixed per-dialect sentence list exercises
the same path).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

DIALECT_DISPLAY = {
    "hunan": "湖南话", "henan": "河南话", "cantonese": "粤语", "sichuan": "四川话",
    "tianjin": "天津话", "zhengzhou": "郑州话", "hunan_pu": "湖南普通话",
    "dongbei": "东北话", "xian": "西安话", "shanghai": "上海话", "guangxi": "广西话",
}

_BASE_TEXTS = [
    "新春到，愿你的日子越过越红火。",
    "祝全家身体健康，万事如意。",
    "今年的收成特别好，大家都乐开了花。",
    "出门在外要照顾好自己，常回家看看。",
    "这碗汤的味道真是没得说。",
    "天气转凉了，记得多穿一件衣裳。",
    "孩子们放了假，院子里热闹得很。",
    "老街上的灯笼一挂，年味就足了。",
    "辛苦一年了，该好好歇一歇。",
    "愿新的一年，心想事成，平安顺遂。",
]

DIALECT_TEXTS = {name: list(_BASE_TEXTS) for name in list(DIALECT_DISPLAY) + ["mandarin"]}


def load_model(model_dir: str, finetuned_llm_path: str | None = None, device: str | None = None):
    """AutoModel load (on `device`, CUDA when None) + optional fine-tuned
    LLM swap."""
    from ..api import AutoModel

    print(f"加载模型: {model_dir}")
    model = AutoModel(model_dir=model_dir, device=device)
    if finetuned_llm_path and os.path.exists(finetuned_llm_path):
        print(f"替换 LLM 权重: {finetuned_llm_path}")
        model.model.llm.load_state_dict(_load_llm_state(finetuned_llm_path, model))
        print("LLM 权重替换完成")
    return model


def _load_llm_state(path: str, model) -> dict:
    """The checkpoint as a state_dict of the model's LLM, cast as the API
    casts a model directory's LLM."""
    from ..infer.tts import _cast_state
    from ..models.convert import fuse_qwen_split_params
    from ..models.from_jax import llm_from_jax

    if path.endswith(".msgpack"):
        from ..train.checkpoint import load_params

        p = load_params(path)
    else:  # reference torch checkpoint
        import torch

        from ..models.convert import filter_training_meta, llm_params_from_reference

        sd = filter_training_meta(torch.load(path, map_location="cpu", weights_only=False))
        p = llm_params_from_reference(sd, num_layers=model.cfg.llm.qwen.num_hidden_layers)
    return _cast_state(llm_from_jax(fuse_qwen_split_params(p), model.cfg.llm), model.model.dtype)


def generate_audio(model, text: str, instruct: str, prompt_wav: str, output_path: str, stream: bool = False) -> None:
    from ..data.audio import write_wav

    print(f"  生成: {text[:30]}...")
    if instruct:
        gen = model.inference_instruct2(text, instruct, prompt_wav, stream=stream)
    else:
        gen = model.inference_zero_shot(text, "", prompt_wav, stream=stream)
    for result in gen:
        write_wav(output_path, result["tts_speech"], model.sample_rate)
        print(f"  保存到: {output_path}")
        break


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="CosyVoice 微调前后推理对比")
    parser.add_argument("--pretrained_dir", type=str, required=True)
    parser.add_argument("--finetuned_llm", type=str, default=None)
    parser.add_argument("--prompt_wav", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./comparison_output")
    parser.add_argument("--dialects", nargs="*", default=None, help="subset of dialects to run")
    parser.add_argument("--num_texts", type=int, default=None, help="first N sentences per dialect (default: all)")
    parser.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    args = parser.parse_args(argv)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    test_cases = []
    for name, texts in DIALECT_TEXTS.items():
        if args.dialects and name not in args.dialects:
            continue
        instruct = "" if name == "mandarin" else f"请用{DIALECT_DISPLAY.get(name, name)}说。<|endofprompt|>"
        for i, text in enumerate(texts[: args.num_texts], 1):
            test_cases.append({"name": name, "text": text, "instruct": instruct, "index": i})

    if not os.path.exists(args.pretrained_dir):
        print(f"错误: 预训练模型目录不存在: {args.pretrained_dir}")
        return
    if not os.path.exists(args.prompt_wav):
        print(f"错误: 参考音频不存在: {args.prompt_wav}")
        return

    print("[1/2] 加载原始预训练模型...")
    model = load_model(args.pretrained_dir, device=args.device)
    for case in test_cases:
        out = output_dir / f"{case['name']}_{case['index']}_original.wav"
        generate_audio(model, case["text"], case["instruct"], args.prompt_wav, str(out))

    if args.finetuned_llm and os.path.exists(args.finetuned_llm):
        print("[2/2] 加载微调后模型...")
        model = load_model(args.pretrained_dir, args.finetuned_llm, device=args.device)
        for case in test_cases:
            out = output_dir / f"{case['name']}_{case['index']}_finetuned.wav"
            generate_audio(model, case["text"], case["instruct"], args.prompt_wav, str(out))
    else:
        print(f"跳过微调模型: 权重文件不存在 {args.finetuned_llm}")

    print(f"对比结果已保存到: {output_dir}")
    for f in sorted(output_dir.glob("*.wav")):
        print(f"  - {f.name}")


if __name__ == "__main__":
    main()
