"""Autograd-aware collectives over a process group.

The counterparts of what XLA's SPMD partitioner inserts for the JAX
package's mesh (``gaot_tpu/parallel/mesh.py``, ``spatial.py``):

- :func:`copy_to_group`: identity forward, all-reduce backward (the input
  of a column-parallel product: every rank's partial gradient of the
  replicated activation is summed);
- :func:`reduce_from_group`: all-reduce forward, identity backward (the
  output of a row-parallel product);
- :func:`gather_along`: all-gather along an axis, whose backward takes this
  rank's slice of the summed gradient;
- :func:`sum_over`: all-reduce forward and backward (a statistic every rank
  reads, of parts every rank holds).

Every collective is one ``all_reduce``: a gather sums zero-filled slots in
which each rank wrote its own part. Gloo runs only ``broadcast`` and
``all_reduce`` on CUDA tensors (the PyTorch docs' backend table), and two
ranks on one card can only use gloo (NCCL refuses two ranks on one
device), so this one code path runs on every backend; NCCL's
``all_gather_into_tensor`` would move half the bytes of a two-rank gather
and is not used. bf16 tensors are summed in fp32 (gloo's CPU all-reduce
has no bf16 on every build) and cast back: a gather's sum of zeros and one
value is exact either way. With no group (an axis of one rank: the mesh
makes none) every function returns its input; a group of one rank runs
the collective, as on the card's NCCL group of one process. Nothing here
reads a device value on the host, so a step that calls them can be
captured in a CUDA graph with its NCCL collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, as a new tensor (``t`` is not
    written); ``t`` itself without a group."""
    if group is None:
        return t
    wide = t.dtype in (torch.bfloat16, torch.float16, torch.bool)
    out = t.float() if wide else t.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype) if wide else out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (every
    rank's ``t`` of one shape), by one all-reduce of zero-filled slots."""
    if group is None:
        return t
    size = group_size(group)
    dim = dim % t.dim()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    dtype = torch.float32 if t.dtype in (torch.bfloat16, torch.float16, torch.bool) \
        else t.dtype
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out.narrow(dim, group_rank(group) * n, n).copy_(t)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        summed = all_reduce(grad.contiguous(), ctx.group)
        return (summed.narrow(ctx.dim, group_rank(ctx.group) * ctx.n, ctx.n)
                .contiguous(), None, None)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward; the gradient passed through."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` (rank order); the backward keeps this
    rank's slice of the gradient summed over ``group``."""
    if group is None:
        return x
    return _GatherAlong.apply(x, group, dim % x.dim())


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward and backward: every rank reads the
    sum, so each part's gradient is the ranks' gradients summed."""
    return x if group is None else _SumOver.apply(x, group)
