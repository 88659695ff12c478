"""Placement rules for the port's modules and the sharding that follows them
(fangyan_tts_tpu/parallel/sharding.py).

The rules are the JAX package's, written on the port's parameter names,
each with the torch dim it shards:

- tensor parallel ('tp'): the Qwen2 q/k/v projection and the MLP's
  gate/up are column-parallel (the output features, torch dim 0 of a
  Linear weight, dim 1 of a QLinear's (in, out) `kernel_q`), o_proj and
  down_proj row-parallel (the input features); the DiT's to_qkv and ff_0
  column, to_out and ff_2 row; the embedding tables shard their
  vocabulary; `llm_decoder` is column-parallel and its logits are gathered.
  A column-parallel layer's bias and scale shard with its columns; a
  row-parallel layer's replicate (the bias is added once, after the
  all-reduce). When tp > 1 and a rule matches, the parameter is not
  fsdp-sharded; a rule whose dim tp does not divide falls through.
- fsdp ('fsdp'), when no tp rule placed it: a tensor whose JAX form (the
  layer axis of the nn.scan stacks in front, Dense kernels (in, out),
  convolutions reversed) has at least 2 dims and 2**16 elements shards its
  largest dim that fsdp divides, ties going to the first JAX dim; the port
  never shards the layer axis (its layers are separate tensors), and takes
  the next dim where the JAX rule would.
- everything else replicates.

Layout departures from the JAX package, where GSPMD reshards after the
matmul and the port must not:
- the fused q/k/v (`qkv_proj`, `to_qkv`) and gate/up (`gate_up_proj`)
  layers are split head-aware: a rank holds its own query heads, KV heads
  and value heads (its gate and up halves), each a contiguous part of its
  segment, concatenated; `gather_module` puts the segments back. tp must
  divide the query heads, the KV heads, the DiT heads and the MLP hidden,
  or `shard_module` raises;
- the int4 MLP's `kernel_q4` (which no JAX rule names) splits with its
  layer: column on its output dim, row on the packed input rows (two input
  rows a byte, so a rank's rows start on a byte);
- the DiT rotates only head 0's channels (a quirk kept from the reference),
  so only the rank that holds head 0 rotates.

A module holding the MLA-MoE backbone (models/mla_moe.py) has no rules
here: `shard_module` raises NotImplementedError for it.

`shard_module` slices a module's tensors in place and swaps each
tensor-parallel layer's class to one that takes its collectives around
its part (`TPLinear`, `TPQLinear`: models/qwen2.qdense and flax_dense hand
them over; `VocabParallelEmbedding`); it records the layout on the module,
which `gather_module` (the single-device state_dict, bit-equal to the one
sharded), the train steps and the optimizer's norm read. A checkpoint
loads whole into the unsharded module, which is then sharded.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, replace
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import qwen2 as q
from . import comm
from .mesh import Mesh

# (regex over the port's parameter name, the torch dim tp shards or None to
# replicate). First match that tp divides wins.
_TP_RULES: list[tuple[str, int | None]] = [
    (r"embed_tokens\.weight$", 0),
    (r"speech_embedding\.weight$", 0),
    (r"input_embedding\.weight$", 0),
    (r"self_attn\.qkv_proj\.weight$", 0),
    (r"self_attn\.qkv_proj\.kernel_q$", 1),
    (r"self_attn\.qkv_proj\.(bias|scale)$", 0),
    (r"self_attn\.o_proj\.weight$", 1),
    (r"self_attn\.o_proj\.kernel_q$", 0),
    (r"self_attn\.o_proj\.scale$", None),
    (r"mlp\.gate_up_proj\.weight$", 0),
    (r"mlp\.gate_up_proj\.kernel_q4?$", 1),
    (r"mlp\.gate_up_proj\.scale$", 0),
    (r"mlp\.down_proj\.weight$", 1),
    (r"mlp\.down_proj\.kernel_q4?$", 0),
    (r"mlp\.down_proj\.scale$", None),
    (r"llm_decoder\.weight$", 0),
    (r"attn\.to_qkv\.weight$", 0),
    (r"attn\.to_qkv\.kernel_q$", 1),
    (r"attn\.to_qkv\.(bias|scale)$", 0),
    (r"attn\.to_out\.weight$", 1),
    (r"attn\.to_out\.kernel_q$", 0),
    (r"attn\.to_out\.(bias|scale)$", None),
    (r"ff_0\.weight$", 0),
    (r"ff_0\.kernel_q$", 1),
    (r"ff_0\.(bias|scale)$", 0),
    (r"ff_2\.weight$", 1),
    (r"ff_2\.kernel_q$", 0),
    (r"ff_2\.(bias|scale)$", None),
]

_FSDP_MIN_SIZE = 2**16  # don't bother sharding tiny tensors

_STACKED = ("layers", "blocks", "encoders", "up_encoders", "mid")


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives: sharded over `axis` ('tp' or 'fsdp') along the
    torch dim `dim`, or replicated (axis None). `segments`: the sizes of the
    fused parts along `dim` (q, k, v; gate, up), each split on its own."""

    axis: str | None = None
    dim: int | None = None
    segments: tuple[int, ...] = ()

    def spec(self, ndim: int) -> tuple:
        """The PartitionSpec-like tuple over the torch dims."""
        return tuple(self.axis if d == self.dim else None for d in range(ndim))


REPLICATED = Placement()


def _sizes(mesh) -> dict:
    return dict(mesh) if isinstance(mesh, Mapping) else mesh.shape


def param_pspec(name: str, shape: tuple[int, ...], mesh, stack: int = 0, perm: tuple[int, ...] | None = None) -> tuple:
    """The placement of the port's tensor `name` of torch `shape` as a tuple
    over its dims (None, 'tp' or 'fsdp' each). `stack`: the layer count of
    its nn.scan stack in the JAX package (0 outside one); `perm`: its axes
    torch -> JAX (None: the same). `mesh`: a Mesh or a dict of axis sizes."""
    return _placement(name, tuple(shape), _sizes(mesh), stack, perm).spec(len(shape))


def _placement(name: str, shape: tuple[int, ...], sizes: dict, stack: int, perm) -> Placement:
    tp, fsdp = sizes.get("tp", 1), sizes.get("fsdp", 1)
    if tp > 1:
        for pat, dim in _TP_RULES:
            if re.search(pat, name) and (dim is None or (dim < len(shape) and shape[dim] % tp == 0)):
                return REPLICATED if dim is None else Placement("tp", dim)
    jshape = tuple(shape[p] for p in perm) if perm is not None else shape
    if stack:
        jshape = (stack, *jshape)
    if fsdp > 1 and len(jshape) >= 2 and int(np.prod(jshape)) >= _FSDP_MIN_SIZE:
        for j in sorted(range(len(jshape)), key=lambda i: -jshape[i]):  # stable: ties keep the first JAX dim
            if jshape[j] % fsdp or (stack and j == 0):
                continue
            jd = j - 1 if stack else j
            return Placement("fsdp", perm[jd] if perm is not None else jd)
    return REPLICATED


def _jax_views(module: nn.Module) -> dict[str, tuple[int, tuple[int, ...] | None]]:
    """(stack length, torch -> JAX perm) of every state_dict tensor."""
    from ..models.from_jax import jax_key

    owners = dict(module.named_modules())
    out = {}
    for name, t in module.state_dict(keep_vars=True).items():
        path, perm = jax_key(name, t.dim(), owners)
        s = next((i for i, p in enumerate(path) if p in _STACKED), None)
        stack = len(owners[".".join(path[: s + 1])]) if s is not None else 0
        out[name] = (stack, perm)
    return out


def placement_tree(module: nn.Module, mesh) -> dict[str, tuple]:
    """{state_dict name: placement tuple over its torch dims} by the rules.
    A sharded module reports the placements it was sharded with."""
    sh = getattr(module, "_sharded", None)
    if sh is not None:
        return {n: sh.placements[n].spec(t.dim()) for n, t in module.state_dict(keep_vars=True).items()}
    sizes = _sizes(mesh)
    views = _jax_views(module)
    return {n: _placement(n, tuple(t.shape), sizes, *views[n]).spec(t.dim())
            for n, t in module.state_dict(keep_vars=True).items()}


def batch_pspec(mesh: Mesh, n: int) -> slice:
    """The rows of an n-row global batch that this process takes: batches
    shard their leading dim over (dp, fsdp), as the JAX package's
    batch_pspec (fsdp is a data axis for activations too); ranks that differ
    only in tp take the same rows. n must be a multiple of dp x fsdp
    (data/dataset.rank_rows pads a batch to one)."""
    d = mesh.data_size
    if n % d:
        raise ValueError(f"a batch of {n} rows does not split over dp x fsdp = {d} data ranks")
    per = n // d
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


# ---------------------------------------------------------------- sharding


@dataclass
class TPLayer:
    """What a tensor-parallel layer's forward needs: 'col' (input copied in,
    local columns out, gathered when `gather`), 'row' (local input rows,
    partial sums reduced) or 'vocab' (this rank's rows of an embedding
    table); whether the bias is this rank's part (a column layer's) or
    whole, added after the collective; this process's tp rank."""

    mode: str
    group: object
    rank: int = 0
    gather: bool = False
    local_bias: bool = False

    def __deepcopy__(self, memo):  # a process group is a handle: copies of a module share it
        return self


class _TPDense(q.TPDense):
    """A Linear or QLinear sharded by the tp rules (`self.tp`, a TPLayer)."""

    def tp_dense(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """qdense (dtype None) or flax_dense (in `dtype`) on this rank's part:
        a column layer's input is copied in, its local bias added to its
        columns, which the LM head gathers; a row layer's partial sums are
        reduced, then its whole bias added. The kernels are called through
        models/qwen2's names, as the unsharded layers call them."""
        tp = self.tp
        if tp.mode == "col":
            x = comm.copy_to(x, tp.group)
        if isinstance(self, q.QLinear):
            y = (q.int4_matmul(x, self.kernel_q4, self.scale) if self.bits == 4
                 else q.int8_dot(x, self.kernel_q, self.scale))
        else:
            dtype = dtype or x.dtype
            y = F.linear(x.to(dtype), self.weight.to(dtype))
        bias = None if self.bias is None else self.bias.to(y.dtype)
        if tp.mode == "row":
            y = comm.reduce_from(y, tp.group)
        elif tp.local_bias and bias is not None:
            y, bias = y + bias, None
        if tp.gather:
            y = comm.gather(y, -1, tp.group)
        return y if bias is None else y + bias


class TPLinear(_TPDense, nn.Linear):
    """A tensor-parallel nn.Linear (its class swapped by shard_module)."""


class TPQLinear(_TPDense, q.QLinear):
    """A tensor-parallel QLinear (its class swapped by shard_module)."""


class VocabParallelEmbedding(nn.Embedding):
    """An embedding whose rows are this rank's part of the vocabulary
    (`self.tp`, a TPLayer): a masked lookup of the ids it holds, then a sum
    over the tp group (every id is held by one rank)."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.weight.shape[0]
        local = ids - self.tp.rank * n
        inside = (local >= 0) & (local < n)
        out = F.embedding(local.clamp(0, n - 1), self.weight) * inside[..., None].to(self.weight.dtype)
        return comm.reduce_from(out, self.tp.group)


@dataclass
class Sharded:
    """The layout a module was sharded with (module._sharded)."""

    mesh: Mesh
    placements: dict[str, Placement]  # every state_dict tensor
    param_axes: list[str | None]  # the axis of each tensor of module.parameters(), in order


def _fused_segments(module: nn.Module, name: str, size: int) -> tuple[int, ...]:
    from ..models.dit import DiTAttention
    from ..models.qwen2 import Qwen2Attention, Qwen2MLP

    owner = module.get_submodule(name.rsplit(".", 2)[0]) if name.count(".") >= 2 else None
    if isinstance(owner, Qwen2Attention) and ".qkv_proj." in name:
        return (owner.nq, owner.nkv, owner.nkv)
    if isinstance(owner, Qwen2MLP) and ".gate_up_proj." in name:
        return (size // 2, size // 2)
    if isinstance(owner, DiTAttention) and ".to_qkv." in name:
        return (size // 3,) * 3
    return (size,)


def local_part(t: torch.Tensor, p: Placement, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s part of the whole tensor t: the rank-th of n equal parts
    of each segment along p.dim."""
    parts = []
    off = 0
    for seg in p.segments:
        per = seg // n
        parts.append(t.narrow(p.dim, off + rank * per, per))
        off += seg
    return torch.cat(parts, dim=p.dim).clone() if len(parts) > 1 else parts[0].clone()


def _whole(local: torch.Tensor, p: Placement, group) -> torch.Tensor:
    """The whole tensor from every rank's part (local_part's inverse)."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    every = comm.gather_dim(local.contiguous(), p.dim, group)
    ranks = torch.chunk(every, n, dim=p.dim)
    out = []
    per = [seg // n for seg in p.segments]
    for i in range(len(p.segments)):
        off = sum(per[:i])
        out += [r.narrow(p.dim, off, per[i]) for r in ranks]
    return torch.cat(out, dim=p.dim)


def _check_tp(module: nn.Module, tp: int) -> None:
    from ..models.dit import DiT
    from ..models.qwen2 import Qwen2Model

    for name, m in module.named_modules():
        if isinstance(m, Qwen2Model):
            c = m.cfg
            bytes_ = 2 if c.quant_int8 and c.quant_int4_mlp else 1  # int4: two hidden rows a byte
            if c.num_attention_heads % tp or c.num_key_value_heads % tp or c.intermediate_size % (tp * bytes_):
                raise ValueError(f"tp={tp} must divide the query heads ({c.num_attention_heads}), the KV heads "
                                 f"({c.num_key_value_heads}) and the MLP hidden ({c.intermediate_size}"
                                 f"{', in whole int4 bytes' if bytes_ == 2 else ''}) of {name or 'the model'}")
        elif isinstance(m, DiT) and (m.cfg.heads % tp or m.cfg.dim * m.cfg.ff_mult % tp):
            raise ValueError(f"tp={tp} must divide the DiT heads ({m.cfg.heads}) and its feed-forward hidden "
                             f"({m.cfg.dim * m.cfg.ff_mult}) of {name or 'the model'}")


def _local_configs(module: nn.Module, mesh: Mesh) -> None:
    """Give the modules that count heads their per-rank head counts (the KV
    caches and the attention reshapes follow them), and the DiT's head-0
    rotation to the rank that holds head 0."""
    from ..models.dit import DiT, DiTAttention
    from ..models.flow import CausalMaskedDiffWithDiT
    from ..models.llm import CosyVoice3LM
    from ..models.qwen2 import Qwen2Attention, Qwen2Model

    tp, tp_rank = mesh.tp, mesh.rank("tp")
    for m in module.modules():
        if isinstance(m, (Qwen2Attention, Qwen2Model)):
            m.cfg = replace(m.cfg, num_attention_heads=m.cfg.num_attention_heads // tp,
                            num_key_value_heads=m.cfg.num_key_value_heads // tp)
            if isinstance(m, Qwen2Attention):
                m.nq, m.nkv = m.nq // tp, m.nkv // tp
        elif isinstance(m, CosyVoice3LM):
            m.cfg = replace(m.cfg, qwen=replace(m.cfg.qwen, num_attention_heads=m.cfg.qwen.num_attention_heads // tp,
                                                num_key_value_heads=m.cfg.qwen.num_key_value_heads // tp))
        elif isinstance(m, (DiTAttention, DiT)):
            m.cfg = replace(m.cfg, heads=m.cfg.heads // tp)
            if isinstance(m, DiTAttention):
                m.rotary = tp_rank == 0
            else:
                m.tp_mesh = mesh  # DiTChunk.of shards its chunk estimator alike
        elif isinstance(m, CausalMaskedDiffWithDiT):
            m.cfg = replace(m.cfg, dit=replace(m.cfg.dit, heads=m.cfg.dit.heads // tp))


def shard_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice `module`'s parameters and buffers to this process's parts by
    the rules, in place, and mark its layers for their sharded forwards.
    Returns the module. A mesh of one process leaves it as it is."""
    if mesh.size == 1:
        return module
    from ..models.mla_moe import MLAMoEModel

    if any(isinstance(m, MLAMoEModel) for m in module.modules()):
        raise NotImplementedError("shard_module: the MLA-MoE backbone has no sharding rules (its experts and "
                                  "latent attention run on one device)")
    if getattr(module, "_sharded", None) is not None:
        raise ValueError("module is sharded already")
    tp = mesh.tp
    if tp > 1:
        _check_tp(module, tp)
    views = _jax_views(module)
    placements: dict[str, Placement] = {}
    for name, t in module.state_dict(keep_vars=True).items():
        p = _placement(name, tuple(t.shape), mesh.shape, *views[name])
        if p.axis is not None:
            p = replace(p, segments=_fused_segments(module, name, t.shape[p.dim]))
        placements[name] = p
    for name, p in placements.items():
        if p.axis is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        n, r = mesh.shape[p.axis], mesh.rank(p.axis)
        if leaf in owner._parameters:
            old = owner._parameters[leaf]
            owner._parameters[leaf] = nn.Parameter(local_part(old.data, p, r, n), requires_grad=old.requires_grad)
        else:
            owner._buffers[leaf] = local_part(owner._buffers[leaf], p, r, n)
    if tp > 1:
        _mark_tp(module, placements, mesh)
        _local_configs(module, mesh)
    names = {id(t): n for n, t in module.named_parameters()}
    axes = [placements[names[id(t)]].axis for t in module.parameters()]
    module._sharded = Sharded(mesh, placements, axes)
    return module


def _mark_tp(module: nn.Module, placements: dict[str, Placement], mesh: Mesh) -> None:
    group = mesh.group("tp")
    for name, m in module.named_modules():
        prefix = name + "." if name else ""
        if isinstance(m, nn.Embedding) and placements[prefix + "weight"].axis == "tp":
            m.__class__ = VocabParallelEmbedding
            m.tp = TPLayer("vocab", group, mesh.rank("tp"))
        elif isinstance(m, (nn.Linear, q.QLinear)):
            linear = isinstance(m, nn.Linear)
            p = placements[prefix + ("weight" if linear else "kernel_q4" if m.bits == 4 else "kernel_q")]
            if p.axis != "tp":
                continue
            col = p.dim == (0 if linear else 1)
            bias = placements.get(prefix + "bias")
            m.__class__ = TPLinear if linear else TPQLinear
            # the LM head's logits are gathered for the sampler and the loss
            m.tp = TPLayer("col" if col else "row", group, mesh.rank("tp"), gather=col and name.endswith("llm_decoder"),
                           local_bias=bias is not None and bias.axis == "tp")


def replicate_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Record `mesh` on `module` with every tensor replicated (the
    data-parallel GAN's layout): its steps split the rows and sum the
    gradients over the data ranks."""
    if mesh.size > 1:
        module._sharded = Sharded(mesh, {n: REPLICATED for n in module.state_dict()},
                                  [None] * len(list(module.parameters())))
    return module


def gather_module(module: nn.Module) -> dict[str, torch.Tensor]:
    """The single-device state_dict of a sharded module (every process gets
    it; a collective, so every process calls it): each sharded tensor put
    back whole, bit-equal to the tensor that was sharded."""
    sh = getattr(module, "_sharded", None)
    sd = module.state_dict()
    if sh is None:
        return sd
    return {n: _whole(t, sh.placements[n], sh.mesh.group(sh.placements[n].axis)) if sh.placements[n].axis else t
            for n, t in sd.items()}


@contextlib.contextmanager
def fsdp_gathered(module: nn.Module):
    """Inside the block, every fsdp-sharded parameter of `module` reads as
    its whole tensor, gathered over the fsdp group (its gradient is
    reduce-scattered back to the shard); module.parameters() still yields
    the shards. Keep the backward pass inside the block (remat recomputes
    through the whole tensors)."""
    sh = getattr(module, "_sharded", None)
    shadowed = []
    if sh is not None and sh.mesh.fsdp > 1:
        group = sh.mesh.group("fsdp")
        for name, p in sh.placements.items():
            if p.axis != "fsdp":
                continue
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            src = owner._parameters.get(leaf)
            if src is None:
                src = owner._buffers[leaf]
            # an instance attribute shadows the registered tensor for attribute reads
            owner.__dict__[leaf] = comm.gather_sum(src, p.dim, group)
            shadowed.append((owner, leaf))
    try:
        yield module
    finally:
        for owner, leaf in shadowed:
            del owner.__dict__[leaf]


def sync_grads(module: nn.Module, grads: list[torch.Tensor]) -> None:
    """Sum a step's gradients (module.parameters() order) over the data
    ranks, in place: an fsdp-sharded parameter's over dp (its fsdp sum came
    with the reduce-scatter), every other's over dp x fsdp."""
    sh = getattr(module, "_sharded", None)
    if sh is None:
        return
    comm.all_reduce_grads([g for g, a in zip(grads, sh.param_axes) if a != "fsdp"], sh.mesh.group("data"))
    comm.all_reduce_grads([g for g, a in zip(grads, sh.param_axes) if a == "fsdp"], sh.mesh.group("dp"))
