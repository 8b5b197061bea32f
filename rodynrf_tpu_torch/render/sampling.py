"""Ray-point samplers for the three scene parameterizations (port of
rodynrf_tpu/render/sampling.py; reference models/tensorBase.py:487-559).

All samplers return (xyz [R, S, 3], z_vals [R, S], ray_valid [R, S]). Jitter
is drawn from an explicit CPU `torch.Generator` (None = no jitter, eval
mode) and moved to the rays' device; det_jitter=True applies the constant
0.5 jitter of golden-comparison mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.spaces import contract
from ..utils.profiling import span


def _rand(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32).to(like.device, like.dtype)


def sample_ray_ndc(rays_o, rays_d, near: float, far: float, n_samples: int, aabb,
                   gen: Optional[torch.Generator], det_jitter: bool = False):
    """Uniform z in [near, far]; jitter shared across rays
    (reference: tensorBase.py:487-499)."""
    interpx = torch.linspace(near, far, n_samples, device=rays_o.device, dtype=rays_o.dtype)[None]
    if det_jitter:
        interpx = interpx + 0.5 * ((far - near) / n_samples)
    elif gen is not None:
        interpx = interpx + _rand(gen, interpx.shape, rays_o) * ((far - near) / n_samples)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * interpx[..., None]
    inb = torch.all((pts >= aabb[0]) & (pts <= aabb[1]), dim=-1)
    return pts, interpx.expand(rays_o.shape[0], n_samples), inb


def sample_ray_world(rays_o, rays_d, near: float, far: float, n_samples: int, aabb,
                     step_size: float, gen: Optional[torch.Generator], det_jitter: bool = False):
    """World-space AABB march (reference: tensorBase.py:501-522)."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    rng = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)[None]
    if det_jitter:
        rng = rng + 0.5
    elif gen is not None:
        rng = rng + _rand(gen, (rays_o.shape[0], 1), rays_o)
    interpx = t_min[..., None] + step_size * rng
    pts = rays_o[..., None, :] + rays_d[..., None, :] * interpx[..., None]
    inb = torch.all((pts >= aabb[0]) & (pts <= aabb[1]), dim=-1)
    return pts, interpx.expand(rays_o.shape[0], n_samples), inb


def sample_ray_contracted(rays_o, rays_d, near: float, far: float, n_samples: int,
                          gen: Optional[torch.Generator], det_jitter: bool = False):
    """Inner/outer split with mip-NeRF-360 contraction (reference:
    tensorBase.py:524-559). Inner: uniform [near, 2]; outer: inverse-distance
    [2, far]; all samples valid."""
    inner_n = n_samples - n_samples // 2
    outer_n = n_samples // 2

    interpx_inner = torch.linspace(near, 2.0, inner_n + 1, device=rays_o.device,
                                   dtype=rays_o.dtype)[None]
    step_in = (2.0 - near) / inner_n
    if det_jitter:
        jitter = torch.full_like(interpx_inner, 0.5) * step_in
    elif gen is not None:
        jitter = _rand(gen, interpx_inner.shape, rays_o) * step_in
    else:
        jitter = None
    if jitter is not None:
        interpx_inner = torch.cat(
            [interpx_inner[:, :-1] + jitter[:, :-1], interpx_inner[:, -1:]], -1)
    interpx_inner = (interpx_inner[:, 1:] + interpx_inner[:, :-1]) * 0.5

    rng = torch.arange(outer_n + 1, dtype=rays_o.dtype, device=rays_o.device)[None]
    if det_jitter:
        rng = torch.cat([rng[:, :-1] + 0.5, rng[:, -1:]], -1)
    elif gen is not None:
        jitter = _rand(gen, rng.shape, rays_o)
        rng = torch.cat([rng[:, :-1] + jitter[:, :-1], rng[:, -1:]], -1)
    rng = torch.flip(rng, dims=(1,))
    rng = (rng[:, 1:] + rng[:, :-1]) * 0.5
    interpx_outer = 1.0 / (1.0 / far + (1.0 / 2.0 - 1.0 / far) * rng / outer_n)

    interpx = torch.cat([interpx_inner, interpx_outer], -1)  # [1, S]
    pts = contract(rays_o[..., None, :] + rays_d[..., None, :] * interpx[..., None])
    z_vals = interpx.expand(rays_o.shape[0], n_samples)
    return pts, z_vals, torch.ones_like(z_vals, dtype=torch.bool)


def sample_xyz(rays: torch.Tensor, n_samples: int, ray_type: str, near_far, aabb,
               step_size: float, gen: Optional[torch.Generator] = None,
               det_jitter: bool = False):
    """Dispatch (reference: renderer.py:147-170). rays [R, 6] packed (o, d)."""
    with span("sampler"):
        rays_o, rays_d = rays[:, :3], rays[:, 3:6]
        near, far = near_far
        if ray_type == "ndc":
            return sample_ray_ndc(rays_o, rays_d, near, far, n_samples, aabb, gen, det_jitter)
        if ray_type == "contract":
            return sample_ray_contracted(rays_o, rays_d, near, far, n_samples, gen, det_jitter)
        return sample_ray_world(rays_o, rays_d, near, far, n_samples, aabb, step_size, gen,
                                det_jitter)
