"""GRPO reinforcement learning of the speech LM
(fangyan_tts_tpu/train/grpo.py): K rollouts a prompt, a reward a rollout
(the negative ASR character error rate of its synthesized audio, from an
external service, or any callable), group-relative advantages and a clipped
policy gradient with the k3 KL estimator against the frozen reference
policy.

- `generate_rollouts` decodes the K rollouts of every prompt as one batch
  through models/llm.generate_speech_tokens (the decode-attention kernel on
  the card) under no_grad, sampling from a torch.Generator; the buckets
  (`rollout_buckets`) are the JAX package's: the prompt plans left-padded
  to a multiple of 32, max_new a multiple of 64 and the cache a multiple of
  128;
- `make_rollout_batch` teacher-forces the rollouts under the rollout
  policy for old_logps, under no_grad;
- `make_grpo_step` runs the update on the LM's dense attention (no kernel)
  and switches the policy's gradients on for its own duration only, so
  that a serving module (loaded with requires_grad off) trains and goes
  back to serving as it was;
- the reference policy is a module of its own (train/trainer.frozen_copy),
  run under no_grad.

Nothing made under inference mode reaches the update: the rollouts run
under no_grad, and token2wav's inference-mode tensors stay with the flow
and the vocoder, which the update does not touch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..data.lm_plan import pad_plans_left, pad_plans_right
from ..models import qwen2 as q
from ..models.llm import CosyVoice3LM, generate_speech_tokens
from .scheduler import Optimizer
from .trainer import TrainState, grads_of, optimizer_apply


class GRPOConfig(NamedTuple):
    group_size: int = 8  # rollouts per prompt
    clip_eps: float = 0.2
    kl_coef: float = 0.01
    temperature: float = 1.0


def sequence_logps(model: CosyVoice3LM, src, ids, lengths, prompt_lens, rollout_tokens, rollout_lens) -> torch.Tensor:
    """Per-token logps of `rollout_tokens` (B, Tr) under the model,
    teacher-forced after the right-padded prompt plans src / ids (B, Tp) of
    `lengths`. Returns (B, Tr) float32, 0 past rollout_lens."""
    b, tp = ids.shape
    tr = rollout_tokens.shape[1]
    dev = ids.device
    # the rollout spliced in right after each row's prompt
    pos = torch.arange(tp + tr, device=dev)[None, :]
    roll_idx = pos - lengths[:, None]
    in_roll = (roll_idx >= 0) & (roll_idx < rollout_lens[:, None])
    in_prompt = pos < lengths[:, None]
    pad = torch.zeros((b, tr), dtype=ids.dtype, device=dev)
    padded_ids = torch.cat([ids, pad], dim=1)
    padded_src = torch.cat([src, pad.to(src.dtype)], dim=1)
    gathered = rollout_tokens.gather(1, roll_idx.clamp(0, tr - 1).expand(b, tp + tr).long()).to(ids.dtype)
    zero = torch.zeros((), dtype=ids.dtype, device=dev)
    full_ids = torch.where(in_roll, gathered, torch.where(in_prompt, padded_ids, zero))
    full_src = torch.where(in_roll, torch.ones((), dtype=src.dtype, device=dev),
                           torch.where(in_prompt, padded_src, zero.to(src.dtype)))

    x = model.embed_plan(full_src, full_ids)
    t = x.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
    h = model.llm(x, positions, q.prefill_attn_bias(t, lengths + rollout_lens))
    logp = torch.log_softmax(model.decode_logits(h).float(), dim=-1)
    # the logp of rollout token k comes from position lengths + k - 1
    tok_pos = (lengths[:, None] - 1 + torch.arange(tr, device=dev)[None, :]).clamp(0, t - 1).long()
    row_logp = logp.gather(1, tok_pos[..., None].expand(b, tr, logp.shape[-1]))
    picked = row_logp.gather(-1, rollout_tokens.long()[..., None])[..., 0]
    valid = torch.arange(tr, device=dev)[None, :] < rollout_lens[:, None]
    return torch.where(valid, picked, torch.zeros((), device=dev))


def grpo_advantages(rewards: torch.Tensor, group_size: int) -> torch.Tensor:
    """(N,) rewards, N = prompts * group_size -> group-normalized
    advantages, over the population std of each group (jnp.std's ddof 0)."""
    g = rewards.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, unbiased=False)
    return ((g - mean) / std.clamp(min=1e-6)).reshape(-1)


GRPO_KEYS = ("src", "ids", "lengths", "rollout_tokens", "rollout_lens", "old_logps", "rewards")


def make_grpo_step(model: CosyVoice3LM, ref_model: nn.Module, tx: Optimizer,
                   cfg: GRPOConfig = GRPOConfig()) -> Callable:
    """step(state, batch) -> (state, metrics). batch (make_rollout_batch):
    src / ids / lengths (the prompt plans, right-padded), rollout_tokens,
    rollout_lens, old_logps (under the rollout policy), rewards (N,).
    `ref_model` is the frozen reference (trainer.frozen_copy(model)); it
    must not share parameters with `model`."""
    if {id(p) for p in model.parameters()} & {id(p) for p in ref_model.parameters()}:
        raise ValueError("make_grpo_step: ref_model shares parameters with the policy; pass "
                         "trainer.frozen_copy(model)")
    dev = next(model.parameters()).device

    def loss_fn(batch):
        src, ids, lengths, tokens, lens, old_logps, rewards = (torch.as_tensor(batch[k], device=dev)
                                                               for k in GRPO_KEYS)
        logps = sequence_logps(model, src, ids, lengths, lengths, tokens, lens)
        with torch.no_grad():
            ref_logps = sequence_logps(ref_model, src, ids, lengths, lengths, tokens, lens)
        adv = grpo_advantages(rewards, cfg.group_size)[:, None]
        valid = (torch.arange(tokens.shape[1], device=dev)[None, :] < lens[:, None]).float()
        n_tok = valid.sum().clamp(min=1.0)
        ratio = torch.exp(logps - old_logps)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
        pg = -torch.minimum(ratio * adv, clipped * adv)
        delta = ref_logps - logps  # k3 KL estimator (Schulman): exp(ref - pi) - (ref - pi) - 1
        kl = torch.exp(delta) - delta - 1.0
        loss = ((pg + cfg.kl_coef * kl) * valid).sum() / n_tok
        return loss, {"pg_loss": (pg * valid).sum() / n_tok, "kl": (kl * valid).sum() / n_tok,
                      "reward_mean": rewards.mean()}

    def step(state: TrainState, batch: dict):
        was = [p.requires_grad for p in model.parameters()]
        model.requires_grad_(True)
        try:
            loss, aux = loss_fn(batch)
            grads = grads_of(model, loss)
        finally:
            for p, r in zip(model.parameters(), was):
                p.requires_grad_(r)
        opt_state = optimizer_apply(model, tx, grads, state.opt_state)
        metrics = {"loss": loss, **aux}
        return TrainState(state.step + 1, state.params, opt_state), {k: v.detach() for k, v in metrics.items()}

    return step


def cer(ref: str, hyp: str) -> float:
    """Character error rate (the reference's reward_tts.py scoring)."""
    r, h = list(ref), list(hyp)
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1, d[i - 1, j - 1] + (r[i - 1] != h[j - 1]))
    return d[-1, -1] / max(len(r), 1)


class ASRRewardClient:
    """Reward = -CER through an external ASR HTTP service (the reference's
    token2wav_asr_server pattern): each wav is posted as 16-bit mono
    audio/wav, and the reply's json "text" is scored against the text."""

    def __init__(self, url: str):
        self.url = url

    def __call__(self, wavs: list[np.ndarray], texts: list[str], sample_rate: int = 24000) -> np.ndarray:
        import io
        import json
        import urllib.request
        import wave as wave_mod

        scores = []
        for wav, text in zip(wavs, texts):
            buf = io.BytesIO()
            with wave_mod.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
            req = urllib.request.Request(self.url, data=buf.getvalue(), headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                hyp = json.loads(resp.read()).get("text", "")
            scores.append(-cer(text, hyp))
        return np.asarray(scores, np.float32)


# ------------------------------------------------------------ rollout driver


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def rollout_buckets(plans: list, group_size: int, min_ratio: float = 2.0, max_ratio: float = 20.0,
                    text_lens: list[int] | None = None) -> dict:
    """The rollouts' decode buckets (generate_rollouts' and the card's
    checks'): tp (the left-padded prompt length, a multiple of 32), the
    rows' min and max new tokens (from each prompt's text length: its plan's
    text positions unless given), max_new (a multiple of 64) and the cache
    length (a multiple of 128)."""
    rep = [p for p in plans for _ in range(group_size)]
    tlens = text_lens or [max(int((p.src == 0).sum()), 1) for p in plans]
    tlens = [t for t in tlens for _ in range(group_size)]
    tp = _round_up(max(len(p.ids) for p in rep), 32)
    min_lens = np.asarray([int(t * min_ratio) for t in tlens], np.int32)
    max_lens = np.asarray([int(t * max_ratio) for t in tlens], np.int32)
    max_new = max(_round_up(int(max_lens.max()), 64), 64)
    return dict(rows=rep, tp=tp, min_lens=min_lens, max_lens=max_lens, max_new=max_new,
                cache_len=_round_up(tp + max_new, 128))


@torch.no_grad()
def generate_rollouts(model: CosyVoice3LM, plans: list, group_size: int, generator: torch.Generator | None,
                      min_ratio: float = 2.0, max_ratio: float = 20.0,
                      text_lens: list[int] | None = None) -> tuple[np.ndarray, np.ndarray]:
    """K rollouts a prompt as one batched decode on the model's device.
    plans: data/lm_plan.build_prompt_plan plans. Returns (tokens (N, max_new),
    lens (N,)), N = len(plans) * group_size."""
    bk = rollout_buckets(plans, group_size, min_ratio, max_ratio, text_lens)
    dev = next(model.parameters()).device
    batch = pad_plans_left(bk["rows"], length=bk["tp"])
    res = generate_speech_tokens(
        model, *(torch.from_numpy(batch[k]).to(dev) for k in ("src", "ids", "lengths")),
        torch.from_numpy(bk["min_lens"]), torch.from_numpy(bk["max_lens"]), generator,
        max_new_tokens=bk["max_new"], cache_len=bk["cache_len"])
    return res.tokens.cpu().numpy(), res.num_tokens.cpu().numpy()


@torch.no_grad()
def make_rollout_batch(model: CosyVoice3LM, plans: list, group_size: int, rollout_tokens: np.ndarray,
                       rollout_lens: np.ndarray, rewards: np.ndarray) -> dict:
    """The make_grpo_step batch, tensors on the model's device: the prompt
    plans right-padded to a multiple of 32, the rollout tokens cut to a
    multiple of 32, and old_logps teacher-forced under `model` (the rollout
    policy)."""
    dev = next(model.parameters()).device
    rep = [p for p in plans for _ in range(group_size)]
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         pad_plans_right(rep, length=_round_up(max(len(p.ids) for p in rep), 32)).items()}
    tr = _round_up(max(int(rollout_lens.max()), 1), 32)
    tokens = torch.from_numpy(np.ascontiguousarray(rollout_tokens[:, :tr])).to(dev)
    lens = torch.as_tensor(rollout_lens, dtype=torch.int32, device=dev)
    old_logps = sequence_logps(model, b["src"], b["ids"], b["lengths"], b["lengths"], tokens, lens)
    return {"src": b["src"], "ids": b["ids"], "lengths": b["lengths"], "rollout_tokens": tokens,
            "rollout_lens": lens, "old_logps": old_logps,
            "rewards": torch.as_tensor(np.asarray(rewards, np.float32), device=dev)}


def grpo_iteration(model: CosyVoice3LM, state: TrainState, step_fn: Callable, plans: list, texts: list[str],
                   reward_fn: Callable, token2wav_fn: Callable, group_size: int,
                   generator: torch.Generator | None) -> tuple[TrainState, dict]:
    """One on-policy iteration: rollouts under the current policy ->
    synthesis (token2wav_fn(tokens (L,)) -> wav) -> rewards
    (reward_fn(wavs, texts) -> (N,)) -> one update."""
    tokens, lens = generate_rollouts(model, plans, group_size, generator)
    wavs = [token2wav_fn(tokens[i, : lens[i]]) for i in range(len(lens))]
    rep_texts = [t for t in texts for _ in range(group_size)]
    rewards = np.asarray(reward_fn(wavs, rep_texts), np.float32)
    batch = make_rollout_batch(model, plans, group_size, tokens, lens, rewards)
    state, metrics = step_fn(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}
