"""Secondary ray utilities: hierarchical PDF sampling, DDA, distance helpers
(port of rodynrf_tpu/core/rays_extra.py; reference dataLoader/ray_utils.py:
11-27 depth2dist/ndc2dist, 254-352 sample_pdf/ray_marcher/dda, 355-403
read_pfm/ndc_bbox). Not in the training loop (the reference never calls
sample_pdf or ray_marcher from train.py); public surface. Random draws take
an explicit `torch.Generator` where the JAX package takes a key.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch


def depth2dist(z_vals: torch.Tensor, cos_angle: torch.Tensor) -> torch.Tensor:
    """(reference: ray_utils.py:11-19)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * cos_angle[..., None]


def ndc2dist(ndc_pts: torch.Tensor, cos_angle: torch.Tensor) -> torch.Tensor:
    """(reference: ray_utils.py:22-27)."""
    dists = torch.linalg.norm(ndc_pts[:, 1:] - ndc_pts[:, :-1], dim=-1)
    return torch.cat([dists, 1e10 * cos_angle[..., None]], -1)


def _uniform(shape, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) draws from `generator` (on its own device), on `like`'s."""
    return torch.rand(shape, generator=generator, device=generator.device).to(like.device)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF hierarchical sampling (reference: ray_utils.py:254-296):
    bins [B, n_bins], weights [B, n_bins - 1] -> [B, n_samples]. Evenly
    spaced quantiles with `det` or without a generator, else uniform draws."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    shape = (*cdf.shape[:-1], n_samples)
    if det or generator is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device).expand(shape)
    else:
        u = _uniform(shape, generator, cdf)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def dda(rays_o: torch.Tensor, rays_d: torch.Tensor, bbox_3d: torch.Tensor):
    """Slab-method ray/aabb intersection (reference: ray_utils.py:299-306).
    Returns (t_near, t_far), each [B, 1]."""
    inv_d = 1.0 / (rays_d + 1e-6)
    t_min = (bbox_3d[:1] - rays_o) * inv_d
    t_max = (bbox_3d[1:] - rays_o) * inv_d
    t = torch.stack([t_min, t_max])
    t_near = torch.amax(torch.amin(t, dim=0), dim=-1, keepdim=True)
    t_far = torch.amin(torch.amax(t, dim=0), dim=-1, keepdim=True)
    return t_near, t_far


def ray_marcher(
    rays: torch.Tensor,
    n_samples: int = 64,
    lindisp: bool = False,
    perturb: float = 0.0,
    bbox_3d: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Uniform depth or disparity marching (reference: ray_utils.py:309-352):
    rays [B, 8] (o, d, near, far) -> (xyz [B, n, 3], rays_o, rays_d,
    z_vals [B, n]). `bbox_3d` replaces near/far by the box's slabs; with
    `perturb` > 0 and a generator the depths are jittered in their bins."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if bbox_3d is not None:
        near, far = dda(rays_o, rays_d, bbox_3d)

    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype, device=rays.device)
    if not lindisp:
        z_vals = near * (1 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(rays.shape[0], n_samples)

    if perturb > 0 and generator is not None:
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mids], -1)
        z_vals = lower + (upper - lower) * perturb * _uniform(z_vals.shape, generator, z_vals)

    xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals


def ndc_bbox(all_rays: torch.Tensor) -> torch.Tensor:
    """Bounding box [2, 3] of the rays' near and far points (reference:
    ray_utils.py:393-403)."""
    near = all_rays[..., :3].reshape(-1, 3)
    far = (all_rays[..., :3] + all_rays[..., 3:6]).reshape(-1, 3)
    lo = torch.minimum(near.amin(0), far.amin(0))
    hi = torch.maximum(near.amax(0), far.amax(0))
    return torch.stack([lo, hi])


def read_pfm(filename: str):
    """Portable float map reader (reference: ray_utils.py:355-390). Returns
    (the map as a numpy array [H, W] or [H, W, 3], top row first; the
    scale)."""
    with open(filename, "rb") as f:
        header = f.readline().decode().rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode())
        if not dims:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale
