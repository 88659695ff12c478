"""GRPO training CLI for the speech LM (fangyan_tts_tpu/cli/grpo_train.py),
with the JAX CLI's flags and defaults plus --device.

python -m fangyan_tts_torch.cli.grpo_train --model_dir <dir> \
    --data train.jsonl --steps 100 --group_size 8 [--reward_url http://host:50002] \
    [--device cuda|cpu]

Loads api.CosyVoice3(model_dir, fp16=True, load_frontend_models=False) on
one device, CUDA unless --device cpu. Each step picks --prompts_per_step
texts from the jsonl ({"text": ...} lines), decodes --group_size rollouts
of each as one batch (models/llm.generate_speech_tokens: the
decode-attention kernel on the card), synthesizes every rollout
(token2mel, the flash-attention kernel, then the vocoder), scores it
(-CER from the /asr endpoint of --reward_url, or without it the echo
reward) and takes one clipped-PG + KL update (train/grpo.py) of the LM's
leaves in the dtype the model directory holds: clip_by_global_norm(1.0)
then optax.adamw(lr) (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4), with
no finite skip. The reference policy is a frozen copy of the LM as loaded.
--out_dir gets metrics.jsonl and llm_grpo_step{N}.msgpack (the JAX
package's layout) every --save_every steps and at the last.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np


def reward_via_server(url: str):
    """Score wavs with the /asr endpoint (ASRRewardClient posts audio/wav)."""
    from ..train.grpo import ASRRewardClient

    return ASRRewardClient(url.rstrip("/") + "/asr")


def reward_echo(wavs, texts):
    """Bring-up reward: -CER against an empty transcription, -1 for any
    non-empty text; checks the plumbing without an ASR model."""
    from ..train.grpo import cer

    return np.asarray([-cer(t, "") for t in texts], np.float32)


ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX CLI keeps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--data", required=True, help="jsonl with {'text': ...} lines")
    ap.add_argument("--out_dir", default="exp/grpo")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--prompts_per_step", type=int, default=4)
    ap.add_argument("--group_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-6)
    ap.add_argument("--kl_coef", type=float, default=0.01)
    ap.add_argument("--clip_eps", type=float, default=0.2)
    ap.add_argument("--reward_url", default="", help="token2wav_asr_server base URL; empty = echo reward")
    ap.add_argument("--seed", type=int, default=1986)
    ap.add_argument("--save_every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..api import CosyVoice3
    from ..data.lm_plan import build_prompt_plan
    from ..models.from_jax import to_jax_tree
    from ..train.checkpoint import save_params
    from ..train.grpo import GRPOConfig, grpo_iteration, make_grpo_step
    from ..train.scheduler import plain_adam
    from ..train.trainer import frozen_copy, init_state

    logging.basicConfig(level=logging.INFO)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    cv = CosyVoice3(args.model_dir, fp16=True, load_frontend_models=False, device=args.device)
    tts = cv.model
    model = tts.llm
    with open(args.data, encoding="utf-8") as f:
        texts_all = [json.loads(line)["text"] for line in f if line.strip()]
    tokenize = cv.frontend.extract_text_token

    tx = plain_adam(args.lr, weight_decay=ADAMW_WEIGHT_DECAY, grad_clip=1.0)
    state = init_state(model, tx)
    cfg = GRPOConfig(group_size=args.group_size, clip_eps=args.clip_eps, kl_coef=args.kl_coef)
    step_fn = make_grpo_step(model, frozen_copy(model), tx, cfg)
    reward_fn = reward_via_server(args.reward_url) if args.reward_url else reward_echo

    def token2wav_fn(tokens: np.ndarray) -> np.ndarray:
        mel = tts.token2mel(tokens, np.zeros(0, np.int32), np.zeros((0, 80), np.float32),
                            np.zeros(192, np.float32), device_out=True)
        return tts.vocode(mel, finalize=True)

    gen = torch.Generator(device=tts.device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    with open(out / "metrics.jsonl", "a", encoding="utf-8") as metrics_f:
        for it in range(args.steps):
            idx = rng.choice(len(texts_all), size=args.prompts_per_step, replace=False)
            texts = [texts_all[i] for i in idx]
            plans = [build_prompt_plan(model.cfg, tokenize(t).tolist(), []) for t in texts]
            t0 = time.time()
            state, m = grpo_iteration(model, state, step_fn, plans, texts, reward_fn, token2wav_fn,
                                      args.group_size, gen)
            m.update(step=it, wall_s=round(time.time() - t0, 2))
            metrics_f.write(json.dumps(m) + "\n")
            metrics_f.flush()
            logging.info("step %d: %s", it, m)
            if (it + 1) % args.save_every == 0 or it + 1 == args.steps:
                save_params(out / f"llm_grpo_step{it + 1}.msgpack", to_jax_tree(model.state_dict(), model))


if __name__ == "__main__":
    main()
