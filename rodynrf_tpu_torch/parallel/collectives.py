"""Collectives with their backward stated, for data parallelism over rays
(parallel/mesh.py) and the sample-sharded compositor
(parallel/sample_shard.py). The JAX package has no counterpart: GSPMD and
shard_map insert XLA's collectives and their transposes there.

`torch.distributed.nn.functional` is not used: its all_reduce backward sums
every rank's cotangent, which counts a loss that every rank computes W times.
Each Function below says which cotangent it receives and what it returns.

- `gather_rows(x, group)`: all-gather along dim 0 of a tensor whose result
  feeds a loss that every rank of the group computes identically. Every rank
  then holds the same cotangent of the gathered tensor, so the backward is
  the rank's own rows of it times W, with no communication: the sum over the
  ranks of their identical cotangents. The trainer averages the gradients
  over the ranks afterwards (mesh.py's gradient rule).
- `psum(x, group)`: all-reduce SUM whose result is replicated over the
  group and read identically by every rank: backward is the identity.
- `pbroadcast(x, group)`: a replicated value entering a computation that
  differs between the ranks: forward is the identity, backward all-reduces
  the ranks' different cotangents (SUM).
- `gather_varying(x, group)`: all-gather along dim 0 of values that each rank
  then uses in its own way (the compositor's per-shard totals): backward is
  reduce-scatter SUM of the ranks' cotangents.
- `all_gather_dim` / `reduce_scatter_mean_dim`: plain (no autograd) gather
  and averaged reduce-scatter along any dim, for grids sharded at rest.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch renamed the tensor collectives; the old names warn where both exist
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((group_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_tensor(out, x, group=group)
    return out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // group_size(group),) + tuple(x.shape[1:]))
    _reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        w, r = group_size(ctx.group), group_rank(ctx.group)
        n = g.shape[0] // w
        return g[r * n:(r + 1) * n] * w, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _GatherVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g, ctx.group), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherRows.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _Psum.apply(x, group)


def pbroadcast(x: torch.Tensor, group) -> torch.Tensor:
    return _PBroadcast.apply(x, group)


def gather_varying(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherVarying.apply(x, group)


def gather_rows_packed(tensors, group):
    """`gather_rows` of several tensors with the same leading length in one
    collective per dtype ([W·n, ...] each). Each rank's tensors ride one
    after the other in one flat buffer, so every part comes back contiguous
    and so does every cotangent the backward hands to a rank's tensors:
    the reductions downstream see the layouts they see without the mesh."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    w = group_size(group)
    for ids in by_dtype.values():
        flat = gather_rows(torch.cat([tensors[i].reshape(-1) for i in ids]), group)
        parts = torch.split(flat.view(w, -1), [tensors[i].numel() for i in ids], dim=1)
        for i, part in zip(ids, parts):
            out[i] = part.reshape((-1,) + tuple(tensors[i].shape[1:]))
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor from every rank's equal slice along `dim`."""
    full = _gather0(x.detach().movedim(dim, 0), group)
    return full.movedim(0, dim).contiguous()


def reduce_scatter_mean_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Each rank's slice along `dim` of the mean over the ranks of `x`
    (reduce-scatter SUM, then / W: the sum's bits are those of all_reduce
    SUM of two ranks)."""
    part = _reduce_scatter0(x.detach().movedim(dim, 0), group)
    return (part / group_size(group)).movedim(0, dim).contiguous()


def all_reduce_mean_(tensors, group) -> None:
    """Average every tensor over the ranks in place with one flattened
    all-reduce (SUM, then / W) per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    w = group_size(group)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= w
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
