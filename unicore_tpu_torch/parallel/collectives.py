"""Differentiable collectives of a process mesh (parallel/mesh.py's
`ProcessMesh`), Megatron's pairs as torch.autograd.Functions:

  * `to_group`: identity forward, all-reduce of the gradient over the
    group backward.  It stands where a tensor that every rank of the
    group holds whole enters work that each rank does on its own part
    (the normed input of the column-parallel q/k/v/wi products, the
    hidden states before each rank's sequence block of the head): each
    rank's backward then sees the gradient of every rank's part.
  * `from_group`: all-reduce over the group forward, identity backward.
    It sums the ranks' shares of a row-parallel product (o, wo) into the
    replicated residual stream, and the ranks' loss terms into the loss:
    the gradient of a sum is each term's gradient as it stands.

torch.distributed.nn.functional.all_reduce is not used for from_group:
its backward all-reduces the gradient again, which multiplies the
replicated residual stream's gradients by the group's size.

On gloo a card tensor goes to a host copy and back (NCCL would take it
as it is).  A group of one rank is the identity both ways.
"""

from __future__ import annotations

from typing import List

import torch


def group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, host_comm: bool) -> torch.Tensor:
    """Σ over the ranks of `group` of `x`, a new tensor on x's device
    (x itself is not written); through a host copy when `host_comm`."""
    import torch.distributed as dist

    if group_size(group) == 1:
        return x.clone()
    buf = x.detach().to("cpu", copy=True) if host_comm else x.detach().clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group, host_comm: bool) -> List[torch.Tensor]:
    """x of every rank of `group`, in group rank order, on x's device."""
    import torch.distributed as dist

    if group_size(group) == 1:
        return [x]
    src = x.detach().to("cpu") if host_comm else x.detach()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return [p.to(x.device) for p in parts]


class _ToGroup(torch.autograd.Function):
    """forward: x; backward: Σ over the group of the gradient."""

    @staticmethod
    def forward(ctx, x, group, host_comm):
        ctx.group, ctx.host_comm = group, host_comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group, ctx.host_comm), None, None


class _FromGroup(torch.autograd.Function):
    """forward: Σ over the group of x; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group, host_comm):
        return all_reduce(x, group, host_comm)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def to_group(x: torch.Tensor, group, host_comm: bool) -> torch.Tensor:
    return _ToGroup.apply(x, group, host_comm)


def from_group(x: torch.Tensor, group, host_comm: bool) -> torch.Tensor:
    return _FromGroup.apply(x, group, host_comm)
