"""Single-sentence dialect sweep (the port's copy of
fangyan_tts_tpu/cli/dialect_inference_test.py, after the reference's
dialect_inference_test.py): one fixed sentence synthesized under every
dialect instruct. It runs on CUDA unless `--device cpu` is given."""

from __future__ import annotations

import argparse
from pathlib import Path

from .compare_inference import DIALECT_DISPLAY, generate_audio, load_model

TEST_SENTENCE = "今天天气真不错，我们一起出去走走吧。"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="单句多方言推理测试")
    parser.add_argument("--pretrained_dir", type=str, required=True)
    parser.add_argument("--finetuned_llm", type=str, default=None)
    parser.add_argument("--prompt_wav", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./dialect_test_output")
    parser.add_argument("--text", type=str, default=TEST_SENTENCE)
    parser.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    args = parser.parse_args(argv)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = load_model(args.pretrained_dir, args.finetuned_llm, device=args.device)

    for name, display in list(DIALECT_DISPLAY.items()) + [("mandarin", "")]:
        instruct = "" if name == "mandarin" else f"请用{display}说。<|endofprompt|>"
        generate_audio(model, args.text, instruct, args.prompt_wav, str(out_dir / f"{name}.wav"))
    print(f"结果已保存到: {out_dir}")


if __name__ == "__main__":
    main()
