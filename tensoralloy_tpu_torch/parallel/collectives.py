"""Collectives over a `Mesh`, with the gradients the sharded routes need.

`torch.distributed`'s own differentiable collectives do not fit: the
module is deprecated, and its `all_reduce` also sums in backward, so a
replicated energy differentiated on every rank would count each rank's
share n times. Here:

* `psum`   — sum forward, identity backward. A rank's partial per-atom
  sums become the whole structure's; the gradient of the (replicated)
  energy flows back into this rank's own share of the pairs.
* `gather` — concatenate the ranks' blocks forward, this rank's block of
  the gradient backward. Every rank computes the same loss from the same
  gathered predictions, so each holds the same upstream gradient.

`all_reduce` and `all_gather` are the plain (no autograd) forms. With
gloo on CUDA tensors (ranks sharing one card) each collective runs on a
host copy; a mesh without a group (this process alone) makes every
collective the identity.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..utils import tree_flatten, tree_unflatten


def _via_host(x: torch.Tensor, mesh) -> bool:
    return x.is_cuda and dist.get_backend(mesh.group) == "gloo"


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `x` over the mesh's ranks (a new tensor)."""
    if mesh.group is None:
        return x
    host = _via_host(x, mesh)
    y = x.detach().to("cpu" if host else x.device, copy=True).contiguous()
    dist.all_reduce(y, group=mesh.group)
    return y.to(x.device) if host else y


def all_reduce_many(tensors: Sequence[torch.Tensor], mesh
                    ) -> List[torch.Tensor]:
    """`all_reduce` of several tensors of one dtype in one collective."""
    if mesh.group is None or not tensors:
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
    return out


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along dim 0 in rank
    order."""
    if mesh.group is None:
        return x
    host = _via_host(x, mesh)
    y = x.detach().to("cpu" if host else x.device).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y, group=mesh.group)
    out = torch.cat(parts)
    return out.to(x.device) if host else out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n = x.shape[0]
        ctx.block = slice(mesh.rank * n, (mesh.rank + 1) * n)
        return all_gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.block], None


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over ranks forward, identity backward (module docstring)."""
    return x if mesh.group is None else _PSum.apply(x, mesh)


def gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate over ranks forward, this rank's block backward."""
    return x if mesh.group is None else _Gather.apply(x, mesh)


def broadcast(tree, mesh, src: int = 0):
    """A tree of tensors -> rank `src`'s values on every rank (new
    tensors; one collective per dtype)."""
    if mesh.group is None:
        return tree
    flat = tree_flatten(tree)
    out = {}
    for dtype in sorted({v.dtype for v in flat.values()}, key=str):
        keys = [k for k, v in flat.items() if v.dtype == dtype]
        buf = torch.cat([flat[k].detach().reshape(-1) for k in keys])
        host = _via_host(buf, mesh)
        staged = buf.to("cpu") if host else buf.clone()
        dist.broadcast(staged, src=src, group=mesh.group)
        buf = staged.to(buf.device) if host else staged
        lo = 0
        for k in keys:
            n = flat[k].numel()
            out[k] = buf[lo:lo + n].view(flat[k].shape).clone()
            lo += n
    return tree_unflatten(out)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (one small all-reduce, on the
    card under NCCL)."""
    if mesh.group is not None:
        device = mesh.device if dist.get_backend(mesh.group) == "nccl" \
            else "cpu"
        dist.all_reduce(torch.zeros(1, device=device), group=mesh.group)
