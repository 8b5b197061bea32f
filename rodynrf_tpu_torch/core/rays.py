"""Ray generation: pixel -> camera-space direction -> world ray -> NDC
(port of rodynrf_tpu/core/rays.py; reference dataLoader/ray_utils.py:30-250,
train.py:96-103). OpenGL camera convention; differentiable wrt focal and
poses. Matmuls stay in full float32 on the card (the package turns TF32 off)."""

from __future__ import annotations

import torch


def ids2pixel(W: int, H: int, ids: torch.Tensor):
    """Flat pixel id -> (col i, row j, view index) (reference: train.py:96-103)."""
    col = ids % W
    row = torch.div(ids, W, rounding_mode="floor") % H
    view_ids = torch.div(ids, W * H, rounding_mode="floor")
    return col, row, view_ids


def get_ray_directions_lean(i, j, focal, center):
    """Camera-space dirs for sampled pixels (reference: ray_utils.py:53-69).

    i/j are pixel column/row indices; focal = (fx, fy); center = (cx, cy).
    Adds the half-pixel offset internally.
    """
    dtype = focal[0].dtype if torch.is_tensor(focal[0]) else torch.float32
    i = i.to(dtype) + 0.5
    j = j.to(dtype) + 0.5
    return torch.stack(
        [(i - center[0]) / focal[0], -(j - center[1]) / focal[1], -torch.ones_like(i)],
        dim=-1,
    )


def get_rays_lean(directions: torch.Tensor, c2w: torch.Tensor):
    """Per-ray world origin/direction from per-ray c2w (reference: ray_utils.py:72-90).

    directions: (B, 3); c2w: (B, 3, 4). Returns (rays_o, rays_d), both (B, 3).
    """
    rays_d = torch.einsum("bi,bji->bj", directions, c2w[:, :3, :3])
    rays_o = c2w[:, :3, 3]
    return rays_o, rays_d


def ndc_rays_blender(H: int, W: int, focal, near: float, rays_o, rays_d):
    """LLFF forward-facing NDC warp; per-axis focal, differentiable wrt focal
    (reference: ray_utils.py:115-140)."""
    if isinstance(focal, (tuple, list)):
        fx, fy = focal[0], focal[1]
    else:
        fx = fy = focal
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * fx)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * fy)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * fx)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * fy)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def get_ray_directions_blender(H: int, W: int, focal, center=None, device=None):
    """Full-image camera-space dirs grid [H, W, 3] (reference:
    ray_utils.py:93-112)."""
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    ii, jj = ii + 0.5, jj + 0.5
    cent = center if center is not None else [W / 2, H / 2]
    return torch.stack(
        [(ii - cent[0]) / focal[0], -(jj - cent[1]) / focal[1], -torch.ones_like(ii)], dim=-1
    )


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Full-image rays from one c2w [3, 4] (reference: ray_utils.py:143-164).
    Returns (rays_o, rays_d), both [H·W, 3]."""
    rays_d = directions @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
