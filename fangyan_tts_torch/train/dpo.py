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
the preference loss at log 2. Its forward runs under no_grad. The training
forward runs the LM's dense attention (no kernel of the port).

Under a mesh (train/trainer.py's module docstring): the policy is sharded
by trainer.shard_state, the reference on the same mesh here if it is not
yet; each process takes its rows of the chosen half and the same rows of
the rejected half (every pair stays on one rank; B must split over dp x
fsdp), and the means over pairs and tokens divide by counts summed over
the data ranks.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import qwen2 as q
from ..models.llm import IGNORE_ID, CosyVoice3LM, label_smoothed_ce
from .scheduler import Optimizer
from ..parallel import comm
from ..parallel.sharding import batch_pspec, fsdp_gathered, shard_module, sync_grads
from .trainer import LLM_KEYS, TrainState, data_total, grads_of, mesh_of, micro_tensors, optimizer_apply


def dpo_loss(policy_chosen_logps, policy_rejected_logps, ref_chosen_logps, ref_rejected_logps, beta: float = 0.01,
             label_smoothing: float = 0.0, ipo: bool = False, total=None):
    """Returns (mean loss, chosen rewards (B,), rejected rewards (B,)).
    `total`: as in models/llm.label_smoothed_ce (the mean over the pairs of
    every data rank)."""
    logits = (policy_chosen_logps - policy_rejected_logps) - (ref_chosen_logps - ref_rejected_logps)
    if ipo:
        losses = (logits - 1.0 / (2.0 * beta)) ** 2
    else:
        losses = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen_rewards = beta * (policy_chosen_logps - ref_chosen_logps)
    rejected_rewards = beta * (policy_rejected_logps - ref_rejected_logps)
    return _mean(losses, total), chosen_rewards, rejected_rewards


def _mean(x: torch.Tensor, total=None) -> torch.Tensor:
    if total is None:
        return x.mean()
    return x.sum() / total(torch.tensor(x.shape[0], device=x.device))


def _seq_logps(model: CosyVoice3LM, src, ids, lengths, targets,
               total=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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
    ce_loss, acc = label_smoothed_ce(logits[:half], targets[:half], c.lsm_weight, c.length_normalized_loss, total)
    return ce_loss, acc, seq_logps


def make_dpo_train_step(model: CosyVoice3LM, ref_model: nn.Module, tx: Optimizer, mesh=None, beta: float = 0.01,
                        label_smoothing: float = 0.0, ipo: bool = False) -> Callable:
    """step(state, batch, rng=None) -> (state, metrics); batch: the stacked
    plans src, ids, lengths, targets (2B rows: chosen, then rejected),
    numpy or tensors. `ref_model` is the frozen reference
    (trainer.frozen_copy(model) before the first step); it must not share
    parameters with `model`."""
    mesh = mesh_of(model, mesh)
    shared = {id(p) for p in model.parameters()} & {id(p) for p in ref_model.parameters()}
    if shared:
        raise ValueError("make_dpo_train_step: ref_model shares parameters with the policy; pass "
                         "trainer.frozen_copy(model)")
    if mesh is not None and getattr(ref_model, "_sharded", None) is None:
        shard_module(ref_model, mesh)
    dev = next(model.parameters()).device
    total = data_total(mesh)

    def step(state: TrainState, batch: dict, rng=None):
        args = micro_tensors(batch, LLM_KEYS, dev, None)
        half = args[1].shape[0] // 2
        if mesh is not None:  # this rank's pairs: its rows of the chosen half and the same of the rejected
            rows = batch_pspec(mesh, half)
            args = [torch.cat([a[:half][rows], a[half:][rows]]) for a in args]
            half = args[1].shape[0] // 2
        with fsdp_gathered(model):
            ce_loss, acc, logps = _seq_logps(model, *args, total=total)
            with torch.no_grad(), fsdp_gathered(ref_model):
                _, _, ref_logps = _seq_logps(ref_model, *args)
            pref_loss, cr, rr = dpo_loss(logps[:half], logps[half:], ref_logps[:half], ref_logps[half:], beta=beta,
                                         label_smoothing=label_smoothing, ipo=ipo, total=total)
            loss = pref_loss + ce_loss
            grads = grads_of(model, loss)
        sync_grads(model, grads)
        opt_state = optimizer_apply(model, tx, grads, state.opt_state)
        metrics = {"loss": loss, "sft_loss": ce_loss, "dpo_loss": pref_loss, "acc": acc,
                   "dpo_acc": _mean((cr > rr).float(), total), "chosen_reward": _mean(cr, total),
                   "reject_reward": _mean(rr, total)}
        group = mesh and mesh.group("data")
        return TrainState(state.step + 1, state.params, opt_state), {k: comm.total(v, group) for k, v in metrics.items()}

    return step
