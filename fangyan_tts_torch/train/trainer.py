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
place.

Under a mesh (parallel/mesh.make_mesh; every process runs the same step on
the same global batch): `shard_state` shards the module by the rules of
parallel/sharding.py and slices every parameter-shaped optimizer slot as
its own parameter (a structural walk, so two parameters of one shape keep
their own placements). A step takes this process's rows (the batch padded
to a multiple of dp x fsdp with rows that weigh nothing,
data/dataset.rank_rows; stacked microbatches shard dim 1); the loss and
accuracy divide by token counts summed over the data ranks, so each rank's
value is its share and their sum the global batch's; fsdp-sharded weights
are gathered for the forward and their gradients reduce-scattered; the
gradients are then summed over the data ranks (an fsdp-sharded parameter's
over dp) and the optimizer's clip norm and finite check run across the
processes. The flow's draws are made for the global batch and sliced, so a
sharded step sees the draws of the unsharded one.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as nn

from ..data.dataset import pad_rows, rank_rows
from ..models.flow import flow_train_draws
from ..ops.device import resolve_device
from ..parallel import comm
from ..parallel.mesh import Mesh
from ..parallel.sharding import Placement, fsdp_gathered, local_part, shard_module, sync_grads
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


def micro_tensors(batch: dict, keys: tuple, device: torch.device, i: int | None, rows: slice = slice(None)) -> list:
    """The batch's `keys` on `device` (numpy or tensors), microbatch i of a
    stacked batch or (i None) the whole of an unstacked one; `rows` of it."""
    return [torch.as_tensor(batch[k] if i is None else batch[k][i], device=device)[rows] for k in keys]


def mesh_of(model: nn.Module, mesh) -> Mesh | None:
    """The mesh a step of `model` runs on: the one its parameters were
    sharded on (shard_state), None for one process. A `mesh` argument must
    be that mesh."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a fangyan_tts_torch.parallel Mesh (parallel.make_mesh), got {type(mesh)}")
    sh = getattr(model, "_sharded", None)
    if mesh is not None and mesh.size > 1 and (sh is None or sh.mesh != mesh):
        raise ValueError("the module is not sharded on this mesh: shard it first with trainer.shard_state(state, "
                         "mesh, tx) (or parallel.shard_module)")
    return None if sh is None else sh.mesh


def data_total(mesh: Mesh | None):
    """Sums a count over the data ranks (None for one process: the loss
    then divides by its own count)."""
    if mesh is None:
        return None
    return lambda x: comm.total(x, mesh.group("data"))


def shard_state(state: "TrainState", mesh: Mesh, tx: Optimizer | None = None) -> "TrainState":
    """Shard state.params (the module, in place) on `mesh` by the rules of
    parallel/sharding.py, and slice each parameter-shaped optimizer slot
    (adam's mu and nu, the MultiSteps accumulator: lists in the parameters'
    order) as its own parameter. `tx` is accepted for the JAX signature."""
    model = state.params
    names = [n for n, _ in model.named_parameters()]
    shard_module(model, mesh)
    sh = getattr(model, "_sharded", None)
    if sh is None:
        return state
    places = [sh.placements[n] for n in names]

    def walk(x):
        if isinstance(x, list) and len(x) == len(places) and all(isinstance(t, torch.Tensor) for t in x):
            return [_slot(t, p, mesh) for t, p in zip(x, places)]
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x

    return TrainState(state.step, model, walk(state.opt_state))


def _slot(t: torch.Tensor, p: Placement, mesh: Mesh) -> torch.Tensor:
    return t if p.axis is None else local_part(t, p, mesh.rank(p.axis), mesh.shape[p.axis])


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
    update, then apply_updates). Returns the new optimizer state. The
    gradients of a sharded module must be summed over its data ranks
    already (parallel/sharding.sync_grads)."""
    params = list(module.parameters())
    updates, opt_state = tx.update(grads, opt_state, params, getattr(module, "_sharded", None))
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return opt_state


def _make_step(model: nn.Module, tx: Optimizer, accum: int, micro: Callable) -> Callable:
    """micro(batch, i, rng) -> (metrics, grads) of microbatch i (i None:
    the batch is one microbatch)."""

    def apply(state: TrainState, grads: list, metrics: dict):
        sync_grads(model, grads)
        new = TrainState(state.step + 1, state.params, optimizer_apply(model, tx, grads, state.opt_state))
        return new, {**metrics, "grad_norm": global_norm(grads, getattr(model, "_sharded", None))}

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
    leading (accum,) axis. Under a mesh (see the module docstring), every
    process passes the same global batch."""
    mesh = mesh_of(model, mesh)
    dev = next(model.parameters()).device
    total = data_total(mesh)

    def micro(batch, i, rng):
        batch, rows = rank_rows(batch, mesh, axis=1 if i is not None else 0)
        with fsdp_gathered(model):
            loss, acc = model(*micro_tensors(batch, LLM_KEYS, dev, i, rows), total=total)
            grads = grads_of(model, loss)
        group = mesh and mesh.group("data")
        return {"loss": comm.total(loss, group), "acc": comm.total(acc, group)}, grads

    return _make_step(model, tx, accum, micro)


def make_flow_train_step(model: nn.Module, tx: Optimizer, mesh=None, streaming: bool = False,
                         accum: int = 1) -> Callable:
    """batch: token (B, Lt), token_len, feat (B, L_mel, 80), feat_len,
    embedding (B, 192); with accum > 1 each has a leading (accum,) axis.
    rng: a torch.Generator on the model's device, or the draws (see the
    module docstring)."""
    mesh = mesh_of(model, mesh)
    dev = next(model.parameters()).device
    total = data_total(mesh)

    def micro(batch, i, rng):
        batch, rows = rank_rows(batch, mesh, axis=1 if i is not None else 0)
        args = micro_tensors(batch, FLOW_KEYS, dev, i, rows)
        shape = tuple(np.shape(batch["feat"])[1 if i is not None else 0:])  # the global batch's
        if isinstance(rng, torch.Generator):
            draws = flow_train_draws(shape[0], shape, dev, rng)
        else:
            draws = rng if i is None else rng[i]
            if mesh is not None:
                draws = pad_rows(draws, mesh.data_size)
        draws = {k: torch.as_tensor(v, device=dev)[rows] for k, v in draws.items()}
        with fsdp_gathered(model):
            loss, aux = model(*args, draws, streaming=streaming, total=total)
            grads = grads_of(model, loss)
        group = mesh and mesh.group("data")
        metrics = {"loss": comm.total(loss, group)}
        if i is None:  # the JAX step reports the loss's aux only without accumulation
            metrics.update({k: comm.total(v, group) for k, v in aux.items()})
        return metrics, grads

    return _make_step(model, tx, accum, micro)
