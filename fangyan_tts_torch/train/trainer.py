"""Train steps of the LLM and the flow (fangyan_tts_tpu/train/trainer.py).

`make_llm_train_step` / `make_flow_train_step` return step(state, batch,
rng) -> (state, metrics), as the JAX ones do:
- accum > 1: the batch's leaves carry a leading (accum,) microbatch axis
  (data/dataset.stack_microbatches); the step runs forward and backward on
  each microbatch, sums the gradients and applies the optimizer once on
  their mean, as the JAX step's lax.scan does (the same numbers as the
  optimizer's MultiSteps over the same microbatches, one optimizer sweep);
- precision follows the modules' own casts, as in the JAX package: the LLM
  keeps float32 parameters and computes in its `dtype` (bf16 in training:
  embed_plan casts the embeddings, every matmul casts its weight to the
  activations' dtype, the loss is float32); the flow is float32 throughout;
- metrics: loss, acc (LLM) and the global norm of the gradients before
  clipping; the flow's single-step metrics also carry loss_cfm.

The flow loss's five draws come from `rng`: a torch.Generator on the
model's device (fresh draws for every microbatch, models/flow
flow_train_draws), or the draws themselves (a dict, or a sequence of accum
dicts) so that a caller can feed the JAX package's. The LLM step takes no
randomness and ignores `rng`.

TrainState.params is the module itself: the step updates its parameters in
place. One device: a `mesh` raises NotImplementedError (multi-device
training is a later slice of the port).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn as nn

from ..models.flow import flow_train_draws
from ..ops.device import resolve_device
from .scheduler import Optimizer, global_norm

LLM_KEYS = ("src", "ids", "lengths", "targets")
FLOW_KEYS = ("token", "token_len", "feat", "feat_len", "embedding")


@dataclass
class TrainState:
    step: int
    params: nn.Module  # trained in place
    opt_state: Any


def init_state(params: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(0, params, tx.init(list(params.parameters())))


def random_module(ctor: Callable[[], nn.Module], seed: int, device: str | torch.device | None = None) -> nn.Module:
    """A module with float32 weights made on `device` (CUDA unless the
    caller asks for the CPU) from `seed` by the JAX package's fast_init
    rules (N(0, 0.02) for tensors of 2 or more dimensions, ones for norm
    weights, zeros for biases), ready to train."""
    from ..infer.tts import _load, _random_state

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _load(ctor, _random_state(ctor, torch.float32, gen, dev), dev).requires_grad_(True).train()


def micro_tensors(batch: dict, keys: tuple, device: torch.device, i: int | None) -> list:
    """The batch's `keys` on `device` (numpy or tensors), microbatch i of a
    stacked batch or (i None) the whole of an unstacked one."""
    return [torch.as_tensor(batch[k] if i is None else batch[k][i], device=device) for k in keys]


def check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("fangyan_tts_torch trains on one device; multi-device training (the JAX "
                                  "package's parallel/ mesh) is not ported yet")


def grads_of(model: nn.Module, loss: torch.Tensor) -> list[torch.Tensor]:
    """d loss / d every parameter, zeros for one the loss does not reach."""
    params = list(model.parameters())
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def frozen_copy(model: nn.Module) -> nn.Module:
    """A deep copy of `model` that no optimizer step can move and autograd
    never records: the frozen reference policy of DPO and GRPO (the JAX
    package's immutable ref_params; a module shared with the policy would
    follow its in-place updates)."""
    return copy.deepcopy(model).requires_grad_(False).eval()


def optimizer_apply(module: nn.Module, tx: Optimizer, grads: list, opt_state):
    """One optimizer apply on the module's parameters, in place (optax's
    update, then apply_updates). Returns the new optimizer state."""
    params = list(module.parameters())
    updates, opt_state = tx.update(grads, opt_state, params)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return opt_state


def _make_step(model: nn.Module, tx: Optimizer, accum: int, micro: Callable) -> Callable:
    """micro(batch, i, rng) -> (metrics, grads) of microbatch i (i None:
    the batch is one microbatch)."""

    def apply(state: TrainState, grads: list, metrics: dict):
        new = TrainState(state.step + 1, state.params, optimizer_apply(model, tx, grads, state.opt_state))
        return new, {**metrics, "grad_norm": global_norm(grads)}

    def step(state: TrainState, batch: dict, rng=None):
        if accum == 1:
            metrics, grads = micro(batch, None, rng)
            return apply(state, grads, metrics)
        gsum, msum = None, None
        for i in range(accum):
            metrics, grads = micro(batch, i, rng)
            if gsum is None:
                gsum, msum = grads, metrics
            else:
                torch._foreach_add_(gsum, grads)
                msum = {k: msum[k] + v for k, v in metrics.items()}
        torch._foreach_div_(gsum, accum)
        return apply(state, gsum, {k: v / accum for k, v in msum.items()})

    return step


def make_llm_train_step(model: nn.Module, tx: Optimizer, mesh=None, accum: int = 1) -> Callable:
    """batch: right-padded plans src, ids (B, L), lengths (B,), targets (B,
    L) with IGNORE_ID padding (numpy or tensors); with accum > 1 each has a
    leading (accum,) axis."""
    check_mesh(mesh)
    dev = next(model.parameters()).device

    def micro(batch, i, rng):
        loss, acc = model(*micro_tensors(batch, LLM_KEYS, dev, i))
        return {"loss": loss.detach(), "acc": acc}, grads_of(model, loss)

    return _make_step(model, tx, accum, micro)


def make_flow_train_step(model: nn.Module, tx: Optimizer, mesh=None, streaming: bool = False,
                         accum: int = 1) -> Callable:
    """batch: token (B, Lt), token_len, feat (B, L_mel, 80), feat_len,
    embedding (B, 192); with accum > 1 each has a leading (accum,) axis.
    rng: a torch.Generator on the model's device, or the draws (see the
    module docstring)."""
    check_mesh(mesh)
    dev = next(model.parameters()).device

    def micro(batch, i, rng):
        args = micro_tensors(batch, FLOW_KEYS, dev, i)
        feat = args[2]
        if isinstance(rng, torch.Generator):
            draws = flow_train_draws(feat.shape[0], feat.shape, dev, rng)
        else:
            draws = rng if i is None else rng[i]
        loss, aux = model(*args, draws, streaming=streaming)
        metrics = {"loss": loss.detach()}
        if i is None:  # the JAX step reports the loss's aux only without accumulation
            metrics.update({k: v.detach() for k, v in aux.items()})
        return metrics, grads_of(model, loss)

    return _make_step(model, tx, accum, micro)
