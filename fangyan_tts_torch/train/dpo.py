"""DPO fine-tuning of the speech LM (fangyan_tts_tpu/train/dpo.py):
`dpo_loss` (sigmoid with label smoothing, or IPO), `_seq_logps` and
`make_dpo_train_step`.

A batch stacks 2B right-padded plans, the B chosen first and the B rejected
after them. The per-sequence logp is the mean of the target tokens' logps
over the valid (not IGNORE_ID) target positions: the JAX package's
documented deviation from the reference, whose forward_dpo averages over
the ignored positions instead. The SFT loss (label-smoothed CE) is taken on
the chosen half only; the step applies the optimizer once a batch, with no
accumulation.

The reference policy is a module of its own (train/trainer.frozen_copy):
the JAX package's ref_params are an immutable tree, while an in-place step
on a module shared with the policy would move the reference too and hold
the preference loss at log 2. Its forward runs under no_grad. One device:
a `mesh` raises. The training forward runs the LM's dense attention (no
kernel of the port).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import qwen2 as q
from ..models.llm import IGNORE_ID, CosyVoice3LM, label_smoothed_ce
from .scheduler import Optimizer
from .trainer import LLM_KEYS, TrainState, check_mesh, grads_of, micro_tensors, optimizer_apply


def dpo_loss(policy_chosen_logps, policy_rejected_logps, ref_chosen_logps, ref_rejected_logps, beta: float = 0.01,
             label_smoothing: float = 0.0, ipo: bool = False):
    """Returns (mean loss, chosen rewards (B,), rejected rewards (B,))."""
    logits = (policy_chosen_logps - policy_rejected_logps) - (ref_chosen_logps - ref_rejected_logps)
    if ipo:
        losses = (logits - 1.0 / (2.0 * beta)) ** 2
    else:
        losses = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen_rewards = beta * (policy_chosen_logps - ref_chosen_logps)
    rejected_rewards = beta * (policy_rejected_logps - ref_rejected_logps)
    return losses.mean(), chosen_rewards, rejected_rewards


def _seq_logps(model: CosyVoice3LM, src, ids, lengths, targets) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(CE loss and acc of the chosen half, per-sequence mean logp (2B,))
    of a stacked batch."""
    x = model.embed_plan(src, ids)
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    logits = model.decode_logits(model.llm(x, positions, q.prefill_attn_bias(t, lengths)))
    mask = targets != IGNORE_ID
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, torch.where(mask, targets, 0).long()[..., None])[..., 0]
    seq_logps = (picked * mask).sum(dim=-1) / mask.sum(dim=-1).clamp(min=1)
    half = b // 2
    c = model.cfg
    ce_loss, acc = label_smoothed_ce(logits[:half], targets[:half], c.lsm_weight, c.length_normalized_loss)
    return ce_loss, acc, seq_logps


def make_dpo_train_step(model: CosyVoice3LM, ref_model: nn.Module, tx: Optimizer, mesh=None, beta: float = 0.01,
                        label_smoothing: float = 0.0, ipo: bool = False) -> Callable:
    """step(state, batch, rng=None) -> (state, metrics); batch: the stacked
    plans src, ids, lengths, targets (2B rows: chosen, then rejected),
    numpy or tensors. `ref_model` is the frozen reference
    (trainer.frozen_copy(model) before the first step); it must not share
    parameters with `model`."""
    check_mesh(mesh)
    shared = {id(p) for p in model.parameters()} & {id(p) for p in ref_model.parameters()}
    if shared:
        raise ValueError("make_dpo_train_step: ref_model shares parameters with the policy; pass "
                         "trainer.frozen_copy(model)")
    dev = next(model.parameters()).device

    def step(state: TrainState, batch: dict, rng=None):
        args = micro_tensors(batch, LLM_KEYS, dev, None)
        half = args[1].shape[0] // 2
        ce_loss, acc, logps = _seq_logps(model, *args)
        with torch.no_grad():
            _, _, ref_logps = _seq_logps(ref_model, *args)
        pref_loss, cr, rr = dpo_loss(logps[:half], logps[half:], ref_logps[:half], ref_logps[half:], beta=beta,
                                     label_smoothing=label_smoothing, ipo=ipo)
        loss = pref_loss + ce_loss
        opt_state = optimizer_apply(model, tx, grads_of(model, loss), state.opt_state)
        metrics = {"loss": loss, "sft_loss": ce_loss, "dpo_loss": pref_loss, "acc": acc,
                   "dpo_acc": (cr > rr).float().mean(), "chosen_reward": cr.mean(), "reject_reward": rr.mean()}
        return TrainState(state.step + 1, state.params, opt_state), {k: v.detach() for k, v in metrics.items()}

    return step
