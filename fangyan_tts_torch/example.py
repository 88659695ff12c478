"""API walkthrough on the port's AutoModel, the counterpart of the root
example.py of the JAX package (after the reference's example.py:7-112):
zero-shot voice cloning, a saved speaker, fine-grained paralinguistic
markup, instructed synthesis (dialect and emotion), streaming, voice
conversion and segmented (bistream) text input. It writes the same wav
files as the JAX walkthrough, and runs on CUDA unless --device cpu.

python -m fangyan_tts_torch.example --model_dir <dir> --prompt_wav <3 s+ voice> [--out_prefix example] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

PROMPT_TEXT = "希望你以后能够做的比我还好呦。"
ZERO_SHOT_TEXT = "收到好友从远方寄来的生日礼物，那份意外的惊喜与深深的祝福让我心中充满了甜蜜的快乐，笑容如花儿般绽放。"
BISTREAM_PIECES = ("收到好友从远方寄来的生日礼物，", "那份意外的惊喜与深深的祝福", "让我心中充满了甜蜜的快乐，", "笑容如花儿般绽放。")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--prompt_wav", required=True)
    parser.add_argument("--out_prefix", default="example")
    parser.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    args = parser.parse_args(argv)

    from .api import AutoModel
    from .data.audio import write_wav

    cosyvoice = AutoModel(model_dir=args.model_dir, device=args.device)
    sr, prefix, prompt_wav = cosyvoice.sample_rate, args.out_prefix, args.prompt_wav

    def write_each(tag: str, outputs) -> None:
        for i, out in enumerate(outputs):
            write_wav(f"{prefix}_{tag}_{i}.wav", out["tts_speech"], sr)

    def write_joined(tag: str, outputs) -> None:
        write_wav(f"{prefix}_{tag}.wav", np.concatenate([out["tts_speech"] for out in outputs]), sr)

    # 1. zero-shot voice cloning: the prompt text transcribes prompt_wav
    write_each("zero_shot", cosyvoice.inference_zero_shot(ZERO_SHOT_TEXT, PROMPT_TEXT, prompt_wav))

    # 2. save the speaker for reuse, then synthesize by speaker id
    cosyvoice.add_zero_shot_spk(PROMPT_TEXT, prompt_wav, "my_zero_shot_spk")
    write_each("saved_spk", cosyvoice.inference_zero_shot("这是用保存的说话人合成的句子。", "", "",
                                                          zero_shot_spk_id="my_zero_shot_spk"))
    cosyvoice.save_spkinfo()

    # 3. fine-grained paralinguistic control
    write_each("fine_grained", cosyvoice.inference_cross_lingual(
        "在他讲述那个荒诞故事的过程中，他突然[laughter]停下来，因为他自己也被逗笑了[laughter]。", prompt_wav))

    # 4. instructed synthesis: dialect
    write_each("instruct_dialect", cosyvoice.inference_instruct2(
        "收到好友从远方寄来的生日礼物，我心中充满了快乐。", "请用四川话说。<|endofprompt|>", prompt_wav))

    # 5. instructed synthesis: emotion
    write_each("instruct_emotion", cosyvoice.inference_instruct2(
        "今天真是太开心啦！", "请非常开心地说一句话。<|endofprompt|>", prompt_wav))

    # 6. streaming synthesis (chunked audio out)
    write_joined("stream", cosyvoice.inference_zero_shot("流式合成的音频是一块一块产生的。", PROMPT_TEXT, prompt_wav,
                                                         stream=True))

    # 7. voice conversion: the source's content in the prompt's voice
    write_each("vc", cosyvoice.inference_vc(prompt_wav, prompt_wav))

    # 8. bistream: the text arrives as a generator (an LLM agent's output);
    # text and speech tokens interleave 5 : 15 and audio streams out while
    # the text is still arriving
    write_joined("bistream", cosyvoice.inference_zero_shot(iter(BISTREAM_PIECES), PROMPT_TEXT, prompt_wav,
                                                           stream=True))

    print(f"done — wrote {prefix}_*.wav")


if __name__ == "__main__":
    main()
