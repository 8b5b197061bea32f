"""Data parallelism over rays on torch.distributed (port of
rodynrf_tpu/parallel/mesh.py).

The JAX package runs one process over all devices and lets GSPMD place a
1-D `data` mesh: parameters replicated, the ray batch sharded, gradients
all-reduced by XLA. The port runs one process per card (NCCL; gloo over CPU
processes in the tests) on a 1-D `DeviceMesh` named `data`, and does the
placement by hand, because its parameters are a tree of leaf tensors driven
by three `torch.optim.Adam`s, not an `nn.Module` that DDP or FSDP could wrap.

**The mesh does not change the result.** The loss has batch statistics: the
monodepth loss normalises each camera by the median and deviation over the
batch's rays, the masked L1 means and the order loss divide by mask sums
over the batch, and the flat bucket keeps the first N occupied samples of
the whole batch. A per-rank loss averaged over the ranks would change all
of them. So:

**The gradient rule.** Each rank draws the global batch's samples (the same
generator, draw for draw), evaluates the per-ray work (the passes' field
evaluations and compositing, and the scene-flow MLP) on its contiguous span
of the rays only, and gathers the per-ray outputs the losses read
(collectives.gather_rows). Every rank then computes the same global loss on
the whole batch, with the loss code unchanged, so every batch statistic is
exact. The gather's backward returns the rank's own rows of the cotangent
times W: every rank holds the same cotangent, so this is the sum over the
ranks without communication. After the backward, every gradient is
averaged over the ranks with one flattened all-reduce (`sync_gradients`).
Then
- a gradient that flows through a rank's own rows is counted once: W times
  the rank's share, over W;
- a gradient that every rank computes in full is counted once too: W equal
  copies, over W. TV, L1 and ortho on the parameters and the pose-to-ray
  math outside the passes are of this kind.

**Sharded grids** (`--shard_grids 1`, `grid_sharded`): every [C, H, W]
plane grid and its Adam moments live sharded at rest along the first axis
the group size divides (H, W, C), replicated where none divides. Each step
gathers a full working copy, the loss's gradient on it is averaged back by a
reduce-scatter (SUM, then / W), and Adam steps on the shard: Adam is
elementwise, so this is the replicated update.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import all_gather_dim, all_reduce_mean_, reduce_scatter_mean_dim

AXIS = "data"


def make_mesh(n_devices: int = 0, device: str = "cuda", axis: str = AXIS):
    """The 1-D data mesh over the ranks of the process group the caller
    started (one rank per card, or per CPU process). `n_devices` 0 means
    every rank; another count must equal the group's size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group (one process per device: "
                           "python -m rodynrf_tpu_torch, torchrun, or init_process_group)")
    world = dist.get_world_size()
    n = n_devices if n_devices and n_devices > 0 else world
    if n != world:
        raise ValueError(f"a data mesh of {n} devices over a process group of {world} ranks")
    return init_device_mesh(torch.device(device).type, (n,), mesh_dim_names=(axis,))


def mesh_group(mesh):
    return mesh.get_group(AXIS) if mesh.mesh_dim_names else mesh.get_group()


def replicated(mesh, tree):
    """Every tensor of `tree` made equal to rank 0's, in place (the start of
    a run: the same seed gives every rank the same initial tree already)."""
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for _, t in _named(tree):
            dist.broadcast(t.data, src=src, group=group)
    return tree


def batch_sharded(mesh, x):
    """This rank's contiguous span of `x` along dim 0."""
    from .multihost import process_span

    a, b = process_span(x.shape[0], mesh.get_local_rank(), mesh.size())
    return x[a:b]


def shard_batch_indices(mesh, ray_idx):
    """This rank's span of a ray-index batch (the rows its per-ray work
    evaluates; the step itself takes the global batch)."""
    return batch_sharded(mesh, ray_idx)


def grid_sharded(mesh, shape) -> Optional[int]:
    """The axis of a [C, H, W] plane grid sharded over the mesh (or over
    `mesh` ranks, given a count): the first one the mesh size divides in the
    order H, W, C (grid dims are arbitrary odd numbers, so the channel axis
    is often the one that divides); None (replicated) when none divides."""
    n = mesh if isinstance(mesh, int) else mesh.size()
    for dim in (1, 2, 0):
        if shape[dim] % n == 0:
            return dim
    return None


def _is_plane(path) -> bool:
    return any("plane" in str(p) for p in path)


def _named(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, prefix + (i,))
    else:
        yield prefix, tree


def _map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def grid_dims(mesh, params) -> Tuple[Tuple[tuple, int], ...]:
    """((path, axis), ...) of the plane grids `--shard_grids` shards: every
    3-D leaf under a `plane` key whose axes the mesh size divides."""
    out = []
    for path, t in _named(params):
        if _is_plane(path) and t.dim() == 3:
            dim = grid_sharded(mesh, t.shape)
            if dim is not None:
                out.append((path, dim))
    return tuple(out)


def _slice(t, dim, rank, n):
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).contiguous()


def shard_train_inputs(mesh, params, opt_state, aabb, data, shard_grids: bool = False):
    """Place the training state on the mesh: every leaf made equal to rank
    0's (`replicated`); with `shard_grids`, every plane grid cut to this
    rank's slice of its `grid_sharded` axis, and the Adams rebuilt over the
    new leaves with their moments cut alike. The dataset and aabb stay whole
    on every rank (the step indexes them by the global batch). Returns
    (params, opt_state, aabb, data, dims): `dims` as `grid_dims` gives them,
    () without sharding."""
    replicated(mesh, params)
    replicated(mesh, [aabb])
    if not shard_grids:
        return params, opt_state, aabb, data, ()
    from ..train.step import init_opt_state

    sharded, dims_t = shard_params(mesh, params)
    dims = dict(dims_t)
    rank, n = mesh.get_local_rank(), mesh.size()
    paths = {id(t): path for path, t in _named(params)}
    fresh = init_opt_state(sharded)
    for name, opt in opt_state.items():
        old = [p for g in opt.param_groups for p in g["params"]]
        new = [p for g in fresh[name].param_groups for p in g["params"]]
        for p_old, p_new in zip(old, new):
            st = opt.state.get(p_old)
            if not st:
                continue
            dim = dims.get(paths[id(p_old)])
            fresh[name].state[p_new] = {
                k: (_slice(v, dim, rank, n) if dim is not None and k != "step" else v.clone())
                for k, v in st.items()}
    return sharded, fresh, aabb, data, dims_t


def working_copy(params, dims, group):
    """The step's full parameter tree: each sharded grid gathered into a new
    leaf that collects the loss's gradient; every other leaf as it is."""
    dims = dict(dims)
    if not dims:
        return params
    return _map(lambda path, t: all_gather_dim(t, dims[path], group).requires_grad_(True)
                if path in dims else t, params)


def gather_full(tree, dims, group):
    """A tree with every sharded leaf gathered whole (detached), for
    checkpoints and the upsample; other leaves as they are."""
    dims = dict(dims)
    return _map(lambda path, t: all_gather_dim(t, dims[path], group) if path in dims else t,
                tree)


def sync_gradients(params, work, dims, group) -> None:
    """After the backward: every replicated leaf's gradient averaged over
    the ranks with one flattened all-reduce, every sharded grid's gradient
    (on its working copy) averaged back onto the shard by a reduce-scatter.
    A leaf the loss did not reach takes part with zeros."""
    dims = dict(dims)
    rep = []
    for (path, p), (_, w) in zip(_named(params), _named(work)):
        g = w.grad if w.grad is not None else torch.zeros_like(w)
        if path in dims:
            p.grad = reduce_scatter_mean_dim(g, dims[path], group)
        else:
            p.grad = g
            rep.append(g)
    with torch.no_grad():
        all_reduce_mean_(rep, group)


def resolve_devices(batch_size: int, n_dev: int) -> int:
    """The data-parallel device count for `n_dev` devices: a batch that does
    not divide them shards over the largest divisor, with the JAX trainer's
    warning (uneven shards are not supported; a proper divisor leaves at
    least half the devices idle, so its print branch never runs)."""
    d = math.gcd(batch_size, n_dev)
    if d != n_dev:
        warnings.warn(f"[parallel] batch_size {batch_size} does not divide {n_dev} devices; "
                      f"sharding rays over {d} device(s) — {n_dev - d} of {n_dev} devices will "
                      "sit IDLE. Pick a batch_size divisible by the device count.", stacklevel=2)
    return d


def adam_states_full(opt_state, params, dims, group) -> Dict[str, list]:
    """Every Adam's per-parameter state with sharded moments gathered whole,
    in each Adam's parameter order ([] before its first step)."""
    dims = dict(dims)
    paths = {id(t): path for path, t in _named(params)}
    out = {}
    for name, opt in opt_state.items():
        ps = [p for g in opt.param_groups for p in g["params"]]
        if not all(p in opt.state and opt.state[p] for p in ps):
            out[name] = []
            continue
        rows = []
        for p in ps:
            dim = dims.get(paths.get(id(p)))
            rows.append({k: (all_gather_dim(v, dim, group) if dim is not None and k != "step"
                             else v) for k, v in opt.state[p].items()
                         if k in ("step", "exp_avg", "exp_avg_sq")})
        out[name] = rows
    return out


def shard_params(mesh, params):
    """(params with every plane grid cut to this rank's slice of its
    `grid_sharded` axis as a new leaf, dims as `grid_dims` gives them)."""
    dims = dict(grid_dims(mesh, params))
    rank, n = mesh.get_local_rank(), mesh.size()
    sharded = _map(lambda path, t: _slice(t.detach(), dims[path], rank, n)
                   .requires_grad_(True) if path in dims else t, params)
    return sharded, tuple(dims.items())


def broadcast_from_first(mesh, t: Optional[torch.Tensor], dtype, device) -> torch.Tensor:
    """Rank 0's tensor `t` on every rank (the others pass None): its shape,
    then its values. Masks and bucket sizes are decided on rank 0 alone, so
    that last-bit differences between the ranks' own computations can
    never make them choose different shapes and wait in different
    collectives."""
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    first = mesh.get_local_rank() == 0
    ndim = torch.tensor([t.dim() if first else 0], dtype=torch.int64, device=device)
    dist.broadcast(ndim, src=src, group=group)
    shape = (torch.tensor(t.shape, dtype=torch.int64, device=device) if first
             else torch.zeros(int(ndim), dtype=torch.int64, device=device))
    dist.broadcast(shape, src=src, group=group)
    buf = (t.to(device=device, dtype=dtype).contiguous() if first
           else torch.empty([int(s) for s in shape.tolist()], dtype=dtype, device=device))
    dist.broadcast(buf, src=src, group=group)
    return buf


def barrier(mesh) -> None:
    dist.barrier(group=mesh_group(mesh))
