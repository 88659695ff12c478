"""Disaggregated serving in one process: the LLM on one device, token2wav on
another (fangyan_tts_tpu/runtime/disaggregated.py `DisaggregatedTTS`; the
reference's Triton "Disaggregated Server", an LLM pool and a token2wav pool).

A decode thread pushes each chunk of speech tokens (_stream_tokens) through a
queue as host arrays; the caller's thread runs the windowed token2wav
session on them, so the two stages overlap. On one card both stages sit on
it (the default). The two-process split (RemoteToken2Wav, tts_stream_remote)
needs the token2wav server, which is not ported yet.
"""

from __future__ import annotations

import copy
import queue
import threading

import numpy as np
import torch

from ..infer.stream import Token2WavSession


class DisaggregatedTTS:
    """A CosyVoice3TTS split over two torch devices: `llm_device` for the
    decode, `wav_device` for the flow and the vocoder (both the model's own
    device when not given). The model's modules are moved there."""

    def __init__(self, tts, llm_device: str | torch.device | None = None,
                 wav_device: str | torch.device | None = None):
        self.llm_device = torch.device(llm_device) if llm_device is not None else tts.device
        self.wav_device = torch.device(wav_device) if wav_device is not None else tts.device
        self.llm_side = self._side(tts, self.llm_device, ("llm",))
        self.wav_side = self._side(tts, self.wav_device, ("flow", "hift"))

    @staticmethod
    def _side(tts, device: torch.device, modules: tuple):
        """A shallow copy of `tts` that makes its tensors on `device`, with
        `modules` moved there (and its noise buffers made there anew)."""
        if device == tts.device:
            return tts
        side = copy.copy(tts)
        side.device = device
        side.generator = torch.Generator(device=device).manual_seed(int(tts.generator.initial_seed()))
        side._cfm_noise = side._nsf_noise_dev = None
        for name in modules:
            setattr(side, name, getattr(tts, name).to(device))
        return side

    def tts_stream(self, text, prompt_text=np.zeros(0, np.int32), llm_prompt_speech_token=np.zeros(0, np.int32),
                   flow_prompt_speech_token=np.zeros(0, np.int32), prompt_speech_feat=np.zeros((0, 80), np.float32),
                   flow_embedding=np.zeros(192, np.float32), **ratios):
        """Yields {"tts_speech": float32 chunk} as tts(stream=True) does: the
        decode on its own thread, token2wav on this one. A decode error is
        raised here."""
        token_q: queue.Queue = queue.Queue(maxsize=8)
        stop = threading.Event()
        end = object()

        def llm_job():
            with torch.inference_mode():
                try:
                    for chunk in self.llm_side._stream_tokens(text, prompt_text, llm_prompt_speech_token, **ratios):
                        if stop.is_set():
                            return
                        token_q.put(chunk)
                except BaseException as e:  # noqa: BLE001 - relayed to the consumer
                    token_q.put(e)
                    return
            token_q.put(end)

        worker = threading.Thread(target=llm_job, daemon=True)
        worker.start()
        try:
            sess = Token2WavSession(self.wav_side, flow_prompt_speech_token, prompt_speech_feat, flow_embedding)
            while (item := token_q.get()) is not end:
                if isinstance(item, BaseException):
                    raise item
                for audio in sess.push(item):
                    yield {"tts_speech": audio}
            yield {"tts_speech": sess.finish()}
        finally:
            stop.set()
            while worker.is_alive():  # unblock a put on a full queue
                try:
                    token_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            worker.join()
