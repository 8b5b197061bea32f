"""Plain PyTorch rendering of chosen rays of a frame (reference
renderer.py:24-144, 359-372): all-pixel rays of one camera at one time, the
deterministic sampler, both fields and the dual compositor.

Imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import model as M

MAPS = ("rgb", "depth", "rgb_s", "depth_s", "rgb_d", "depth_d", "blending", "delta_xyz")


def frame_rays(model: M.Model, c2w: torch.Tensor, focal: float, pixels: torch.Tensor):
    """Rays [N, 6] through pixels [N] (row-major ids) of one camera c2w [3, 4]."""
    H, W = model.H, model.W
    j = torch.div(pixels, W, rounding_mode="floor").to(torch.float32) + 0.5
    i = (pixels % W).to(torch.float32) + 0.5
    dirs = torch.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -torch.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    if model.ray_type == "ndc":
        rays_o, rays_d = M.ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return torch.cat([rays_o, rays_d], -1)


@torch.no_grad()
def render_rays(params, model: M.Model, aabb, c2w, focal: float, t_value: float,
                pixels: torch.Tensor, chunk: int = 4096) -> Dict[str, torch.Tensor]:
    """The frame's maps at `pixels`, in chunks of `chunk` rays."""
    out = {k: [] for k in MAPS}
    for s in range(0, pixels.shape[0], chunk):
        rays = frame_rays(model, c2w, focal, pixels[s:s + chunk])
        ts = torch.full((rays.shape[0],), float(t_value), device=rays.device)
        xyz, z, valid = M.sample_points(model, rays, aabb, None)
        st = M.eval_static(params["static"], model, aabb, rays, ts, xyz, z, valid)
        dn = M.eval_dynamic(params["dynamic"], model, aabb, rays, ts, xyz, z, valid)
        o = M.composite(st, dn, rays, model.ray_type, False)
        maps = (o.rgb_full, o.depth_full, o.rgb_s, o.depth_s, o.rgb_d, o.depth_d,
                o.dynamicness, torch.mean(torch.abs(dn.xyz_prime - dn.pts_ref), dim=1))
        for k, v in zip(MAPS, maps):
            out[k].append(v)
    return {k: torch.cat(v, 0) for k, v in out.items()}
