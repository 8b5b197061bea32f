"""Sample-axis sharding: the dual-field compositor over a 2-D (ray × sample)
mesh of ranks (port of rodynrf_tpu/parallel/sample_shard.py).

Everything in the render pipeline except the transmittance prefix is
pointwise per sample. The one sequential op, the exclusive transmittance
``T_i = prod_{j<i}(1 - alpha_j + eps)`` (ops/compositing.py), is computed as
a distributed exclusive prefix product: each sample shard takes its local
exclusive cumprod, the per-shard totals are all-gathered along the sample
group (K values per ray for K sample shards), and each shard multiplies in
the product of its predecessors. Per-ray reductions (rgb, depth and acc
maps) are local sums all-reduced over the sample group.

Each rank calls the returned function on its own [R/n_ray, S/n_sample]
blocks (`shard_compositor_inputs`). The per-ray outputs come back whole on
every rank of a sample group and the two weight maps stay sharded.

**The gradient rule** (collectives.py): every rank of a sample group is
taken to compute the same loss from the replicated per-ray outputs (a loss
on a sharded weight map sums it over the sample group first, with `psum`).
Then
- the per-ray sums are `psum`: the cotangent of the replicated sum is the
  same on every rank, so each rank's own term gets it unchanged (identity
  backward);
- the dynamic weights' normaliser, a replicated sum that each shard divides
  its own weights by, enters through `pbroadcast`: each rank's cotangent of
  it differs, so the backward all-reduces them;
- the per-shard totals are `gather_varying`: every later shard reads them in
  its own way, so the backward reduce-scatters the ranks' cotangents (SUM).
The gradients of each rank's input blocks are then those of the dense
compositor (tests/test_torch_parallel_sample_shard.py).

As in the JAX package, nothing on the train path calls it: it is a library
entry for sample counts or eval chunks too deep for one device.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.compositing import RenderOutputs, _depth_tail, _white_fill
from .collectives import gather_varying, pbroadcast, psum

RAY_AXIS = "ray"
SAMPLE_AXIS = "sample"


def make_2d_mesh(n_ray: int, n_sample: int, device: str = "cuda"):
    """A (ray, sample) DeviceMesh over the first n_ray·n_sample ranks of the
    started process group."""
    from torch.distributed.device_mesh import init_device_mesh

    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n_ray * n_sample:
        raise ValueError(
            f"make_2d_mesh({n_ray}, {n_sample}) needs {n_ray * n_sample} "
            f"devices, but only {have} are available"
        )
    return init_device_mesh(torch.device(device).type, (n_ray, n_sample),
                            mesh_dim_names=(RAY_AXIS, SAMPLE_AXIS))


def _exclusive_prod_sharded(factors: torch.Tensor, group, k: int, n_shards: int):
    """Exclusive prefix product along the GLOBAL sample axis: `factors` is
    this rank's [R_loc, S_loc] block of a [R, S] array; returns its block of
    ``T[:, i] = prod_{j < i_global} factors[:, j]``."""
    local_cum = torch.cumprod(factors, dim=-1)
    excl_local = torch.cat([torch.ones_like(factors[:, :1]), local_cum[:, :-1]], dim=-1)
    # [K, R_loc]: every shard's total product, in sample-shard order
    totals = gather_varying(local_cum[:, -1].contiguous(), group).view(n_shards, -1)
    pred = (torch.arange(n_shards, device=factors.device) < k)[:, None]
    offset = torch.prod(torch.where(pred, totals, torch.ones_like(totals)), dim=0)
    return excl_local * offset[:, None]


def _raw2outputs_local(rgb_s, sigma_s, rgb_d, sigma_d, dists, blending, z_vals, rays,
                       white, *, group, k: int, n_sample_shards: int, is_train: bool,
                       ray_type: str) -> RenderOutputs:
    """One rank's part of the dual-field compositor: the math of
    ops/compositing.raw2outputs with the three transmittance prefixes as
    distributed exclusive products and the per-ray sums psum'd over the
    sample group. rays/white are per-ray (whole on the sample group)."""
    excl = partial(_exclusive_prod_sharded, group=group, k=k, n_shards=n_sample_shards)

    def ray_sum(x):
        return psum(torch.sum(x, -1), group)

    alpha_d = 1.0 - torch.exp(-sigma_d * dists)
    alpha_s = 1.0 - torch.exp(-sigma_s * dists)
    T_d = excl(1.0 - alpha_d + 1e-10)
    T_s = excl(1.0 - alpha_s + 1e-10)
    alpha_mix = (1.0 - alpha_d * blending) * (1.0 - alpha_s * (1.0 - blending))
    T_full = excl(alpha_mix + 1e-10)

    weights_d = alpha_d * T_d
    weights_s = alpha_s * T_s
    wd_sum = pbroadcast(torch.clamp(ray_sum(weights_d), min=1e-10), group)
    weights_d = weights_d / wd_sum[:, None]
    weights_full = (alpha_d * blending + alpha_s * (1.0 - blending)) * T_full

    rgb_map_d = psum(torch.sum(weights_d[..., None] * rgb_d, -2), group)
    rgb_map_s = psum(torch.sum(weights_s[..., None] * rgb_s, -2), group)
    rgb_map_full = psum(torch.sum(
        (T_full * alpha_d * blending)[..., None] * rgb_d
        + (T_full * alpha_s * (1.0 - blending))[..., None] * rgb_s, -2), group)

    acc_d, acc_s, acc_full = ray_sum(weights_d), ray_sum(weights_s), ray_sum(weights_full)
    if is_train and white is not None:
        rgb_map_d = _white_fill(rgb_map_d, 1.0 - acc_d[..., None], white)
        rgb_map_s = _white_fill(rgb_map_s, 1.0 - acc_s[..., None], white)
        rgb_map_full = _white_fill(rgb_map_full, torch.relu(1.0 - acc_full[..., None]), white)

    depth_d = _depth_tail(ray_sum(weights_d * z_vals), acc_d, rays, ray_type)
    depth_s = _depth_tail(ray_sum(weights_s * z_vals), acc_s, rays, ray_type)
    depth_full = _depth_tail(ray_sum(weights_full * z_vals), acc_full, rays, ray_type,
                             relu=True)
    return RenderOutputs(
        torch.clamp(rgb_map_full, 0.0, 1.0), depth_full, acc_full, weights_full,
        torch.clamp(rgb_map_s, 0.0, 1.0), depth_s, acc_s, weights_s,
        torch.clamp(rgb_map_d, 0.0, 1.0), depth_d, acc_d, weights_d,
        ray_sum(weights_full * blending),
    )


def make_sample_sharded_raw2outputs(mesh, *, is_train: bool = False, ray_type: str = "ndc"):
    """The dual-field compositor over a (ray, sample) mesh.

    Returns ``fn(rgb_s, sigma_s, rgb_d, sigma_d, dists, blending, z_vals,
    rays, white=None) -> RenderOutputs`` on this rank's blocks: every
    [R, S(, 3)] input as its (ray, sample) block, rays and white [R] as the
    ray block. Per-ray outputs come back for the ray block, the same on
    every rank of the sample group; the weight maps stay (ray, sample)
    blocks."""
    body = partial(
        _raw2outputs_local,
        group=mesh.get_group(SAMPLE_AXIS),
        k=mesh.get_local_rank(SAMPLE_AXIS),
        n_sample_shards=mesh[SAMPLE_AXIS].size(),
        is_train=is_train,
        ray_type=ray_type,
    )

    def fn(rgb_s, sigma_s, rgb_d, sigma_d, dists, blending, z_vals, rays,
           white: Optional[torch.Tensor] = None) -> RenderOutputs:
        return body(rgb_s, sigma_s, rgb_d, sigma_d, dists, blending, z_vals, rays, white)

    return fn


def _block(x, mesh, axes):
    for dim, axis in enumerate(axes):
        n, i = mesh[axis].size(), mesh.get_local_rank(axis)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {n} ranks")
        x = x.narrow(dim, i * (size // n), size // n)
    return x.contiguous()


def shard_compositor_inputs(mesh, rgb_s, sigma_s, rgb_d, sigma_d, dists, blending, z_vals,
                            rays):
    """This rank's blocks of the compositor inputs: [R, S(, 3)] arrays cut
    over both axes, per-ray arrays over rays only."""
    rs = (RAY_AXIS, SAMPLE_AXIS)
    return (
        _block(rgb_s, mesh, rs), _block(sigma_s, mesh, rs), _block(rgb_d, mesh, rs),
        _block(sigma_d, mesh, rs), _block(dists, mesh, rs), _block(blending, mesh, rs),
        _block(z_vals, mesh, rs), _block(rays, mesh, (RAY_AXIS,)),
    )
