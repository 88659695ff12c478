"""Explicit collectives of the sharded models and steps.

Megatron's pair for tensor parallelism, as autograd functions:
- `copy_to(x, group)`: identity forward, all-reduce backward (the input of a
  column-parallel layer, whose ranks each take part of its gradient);
- `reduce_from(x, group)`: all-reduce forward, identity backward (the
  output of a row-parallel layer, a partial sum on each rank);
- `gather(x, dim, group)`: every rank's x concatenated along dim; backward
  takes this rank's part of the gradient (what follows is replicated:
  the LM's logits before the sampler and the loss, the data-parallel GAN
  outputs before theirs);
- `gather_sum(x, dim, group)`: the same forward; backward sums the
  gradient over the group and takes this rank's part (a reduce-scatter:
  an fsdp weight, whose full tensor each data rank uses on its own rows).

`total(x, group)` sums a value over a group with no autograd (the token
counts that losses divide by, metrics); `all_reduce_grads` sums gradient
lists in place, a few flat buffers at a time.

Every collective is an all-reduce: a gather is an all-reduce of a
zero-filled buffer holding this rank's part (exact: each element is one
value plus zeros). gloo takes CUDA tensors for all_reduce and broadcast
only, and two ranks on one card must use gloo, so this keeps one code path
for CPU ranks, shared-card ranks and NCCL ranks. A group of None is a size-1
axis: every function is then the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_BUCKET_ELEMS = 1 << 26  # 256 MB of float32 a flat all-reduce


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's equal-shaped x, concatenated along `dim` in rank order
    (no autograd)."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    shape = list(x.shape)
    part = shape[dim]
    shape[dim] *= n
    buf = x.new_zeros(shape)
    buf.narrow(dim, r * part, part).copy_(x)
    return _reduce(buf, group)


def _part(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = g.shape[dim] // n
    return g.narrow(dim, r * size, size).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return gather_dim(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.summed:
            g = _reduce(g.clone(), ctx.group)
        return _part(g, ctx.dim, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Reduce.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, dim % x.dim(), group, False)


def gather_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, dim % x.dim(), group, True)


def total(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group, outside autograd (a count or a metric)."""
    if group is None:
        return x.detach()
    return _reduce(x.detach().clone(), group)


def all_reduce_grads(grads: list[torch.Tensor], group) -> None:
    """Sum each tensor of `grads` over the group, in place: the tensors go
    through flat buffers of at most _BUCKET_ELEMS elements, one dtype each."""
    if group is None or not grads:
        return
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        bucket, n = [], 0
        for g in same + [None]:
            if g is not None and (not bucket or n + g.numel() <= _BUCKET_ELEMS):
                bucket.append(g)
                n += g.numel()
                continue
            flat = _reduce(torch.cat([t.reshape(-1) for t in bucket]), group)
            for t, part in zip(bucket, torch.split(flat, [t.numel() for t in bucket])):
                t.copy_(part.view_as(t))
            bucket, n = ([g], g.numel()) if g is not None else ([], 0)
