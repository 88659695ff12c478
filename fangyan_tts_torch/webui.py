"""Gradio web demo on the port, the counterpart of the root webui.py of the
JAX package (after the reference's webui.py:29-174): four inference modes
(pretrained voice / 3 s voice clone / cross-lingual / natural-language
instruct), per-mode instructions, uploaded or recorded prompts, input
warnings, a random-seed button, a streaming toggle and a speed slider.

gradio is imported only when the app is built. Without it the script
prints a hint naming the port's HTTP server and exits with code 1, before it
loads a model. The seed of a request seeds python, numpy and torch
(utils/common.set_all_random_seed) and the torch.Generator the model's
sampler draws from (the JAX package sets its PRNG key instead). It runs on
CUDA unless --device cpu.

python -m fangyan_tts_torch.webui --model_dir <dir> [--port 8000] [--device cpu]
"""

import argparse
import logging
import random
import sys

import numpy as np

MODES = ["预训练音色", "3s极速复刻", "跨语种复刻", "自然语言控制"]
INSTRUCT_DICT = {
    "预训练音色": "1. 选择预训练音色\n2. 点击生成音频按钮",
    "3s极速复刻": "1. 选择prompt音频文件，或录入prompt音频，注意不超过30s，若同时提供，优先选择prompt音频文件\n2. 输入prompt文本\n3. 点击生成音频按钮",
    "跨语种复刻": "1. 选择prompt音频文件，或录入prompt音频，注意不超过30s，若同时提供，优先选择prompt音频文件\n2. 点击生成音频按钮",
    "自然语言控制": "1. 选择预训练音色或prompt音频\n2. 输入instruct文本\n3. 点击生成音频按钮",
}
PROMPT_SR = 16000


def require_gradio():
    """The gradio module; without it, a hint on stderr and exit code 1."""
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed in this environment; run the HTTP/gRPC servers instead:", file=sys.stderr)
        print("  python -m fangyan_tts_torch.runtime.http_server --model_dir <dir>", file=sys.stderr)
        raise SystemExit(1)
    return gr


def build_app(cosyvoice):
    gr = require_gradio()

    from .utils.common import set_all_random_seed

    default_data = np.zeros(cosyvoice.sample_rate, np.int16)

    def generate_seed():
        return {"__type__": "update", "value": random.randint(1, 100000000)}

    def change_instruction(mode):
        return INSTRUCT_DICT[mode]

    def _pcm(out):
        return (np.clip(out["tts_speech"], -1, 1) * 32767).astype(np.int16)

    def generate(tts_text, mode, sft_dropdown, prompt_text, prompt_wav_upload, prompt_wav_record,
                 instruct_text, seed, stream, speed):
        prompt_wav = prompt_wav_upload if prompt_wav_upload is not None else prompt_wav_record
        # validation mirror of webui.py:59-94
        if mode == "自然语言控制" and instruct_text == "":
            gr.Warning("您正在使用自然语言控制模式, 请输入instruct文本")
            yield (cosyvoice.sample_rate, default_data)
            return
        if mode in ("3s极速复刻", "跨语种复刻"):
            if prompt_wav is None:
                gr.Warning("prompt音频为空，您是否忘记输入prompt音频？")
                yield (cosyvoice.sample_rate, default_data)
                return
            import wave

            try:
                with wave.open(prompt_wav, "rb") as w:
                    if w.getframerate() < PROMPT_SR:
                        gr.Warning(f"prompt音频采样率{w.getframerate()}低于{PROMPT_SR}")
                        yield (cosyvoice.sample_rate, default_data)
                        return
            except (OSError, EOFError, wave.Error):
                pass  # non-wav container; load_audio handles it downstream
        if mode == "预训练音色" and sft_dropdown == "":
            gr.Warning("没有可用的预训练音色！")
            yield (cosyvoice.sample_rate, default_data)
            return
        if mode == "3s极速复刻" and prompt_text == "":
            gr.Warning("prompt文本为空，您是否忘记输入prompt文本？")
            yield (cosyvoice.sample_rate, default_data)
            return

        set_all_random_seed(int(seed))
        cosyvoice.model.generator.manual_seed(int(seed))  # the sampler's own generator
        if mode == "预训练音色":
            logging.info("get sft inference request")
            gen = cosyvoice.inference_sft(tts_text, sft_dropdown, stream=stream, speed=speed)
        elif mode == "3s极速复刻":
            logging.info("get zero_shot inference request")
            gen = cosyvoice.inference_zero_shot(tts_text, prompt_text, prompt_wav, stream=stream, speed=speed)
        elif mode == "跨语种复刻":
            logging.info("get cross_lingual inference request")
            gen = cosyvoice.inference_cross_lingual(tts_text, prompt_wav, stream=stream, speed=speed)
        else:
            logging.info("get instruct inference request")
            try:
                gen = cosyvoice.inference_instruct(tts_text, sft_dropdown, instruct_text, stream=stream, speed=speed)
            except NotImplementedError:
                # v2/v3 natural-language control goes through instruct2 with
                # the prompt audio (cli/cosyvoice.py:163-189)
                if "<|endofprompt|>" not in instruct_text:
                    instruct_text = instruct_text + "<|endofprompt|>"
                gen = cosyvoice.inference_instruct2(tts_text, instruct_text, prompt_wav, stream=stream, speed=speed)
        for out in gen:
            yield (cosyvoice.sample_rate, _pcm(out))

    with gr.Blocks(title="fangyan-tts") as demo:
        gr.Markdown("## fangyan-tts — dialect & emotion TTS (PyTorch / CUDA)")
        gr.Markdown("#### 请输入需要合成的文本，选择推理模式，并按照提示步骤进行操作")
        tts_text = gr.Textbox(label="输入合成文本", lines=1, value="你好，我是通义生成式语音大模型，提供舒适自然的语音合成能力。")
        with gr.Row():
            mode = gr.Radio(choices=MODES, value=MODES[0], label="选择推理模式")
            instruction = gr.Text(label="操作步骤", value=INSTRUCT_DICT[MODES[0]], scale=0.5)
            sft_dropdown = gr.Dropdown(choices=cosyvoice.list_available_spks() or [""],
                                       value=(cosyvoice.list_available_spks() or [""])[0], label="选择预训练音色", scale=0.25)
            stream = gr.Radio(choices=[("否", False), ("是", True)], label="是否流式推理", value=False)
            speed = gr.Number(value=1, label="速度调节(仅支持非流式推理)", minimum=0.5, maximum=2.0, step=0.1)
            with gr.Column(scale=0.25):
                seed_button = gr.Button(value="\U0001F3B2")
                seed = gr.Number(value=0, label="随机推理种子")
        with gr.Row():
            prompt_wav_upload = gr.Audio(sources="upload", type="filepath", label="选择prompt音频文件，注意采样率不低于16khz")
            prompt_wav_record = gr.Audio(sources="microphone", type="filepath", label="录制prompt音频文件")
        prompt_text = gr.Textbox(label="输入prompt文本", lines=1, value="")
        instruct_text = gr.Textbox(label="输入instruct文本", lines=1, value="")
        generate_button = gr.Button("生成音频")
        audio_output = gr.Audio(label="合成音频", autoplay=True, streaming=True)

        seed_button.click(generate_seed, inputs=[], outputs=seed)
        generate_button.click(
            generate,
            inputs=[tts_text, mode, sft_dropdown, prompt_text, prompt_wav_upload, prompt_wav_record,
                    instruct_text, seed, stream, speed],
            outputs=[audio_output],
        )
        mode.change(fn=change_instruction, inputs=[mode], outputs=[instruction])
    return demo


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--device", default=None, help="torch device (CUDA when not given)")
    args = parser.parse_args(argv)
    require_gradio()

    from .api import AutoModel

    cosyvoice = AutoModel(model_dir=args.model_dir, device=args.device)
    demo = build_app(cosyvoice)
    demo.queue().launch(server_name="0.0.0.0", server_port=args.port)


if __name__ == "__main__":
    main()
