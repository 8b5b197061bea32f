"""Scene parameterizations: NDC <-> world, mip-NeRF-360 contraction <-> world
(port of rodynrf_tpu/core/spaces.py; reference renderer.py:1266-1296 and
models/tensorBase.py:550-556)."""

from __future__ import annotations

import torch


def ndc2world(pts: torch.Tensor, H: float, W: float, f) -> torch.Tensor:
    """NDC -> world (reference: renderer.py:1266-1273)."""
    pts_z = 2.0 / (torch.clamp(pts[..., 2:], -1.0, 1.0 - 1e-6) - 1.0)
    pts_x = -pts[..., 0:1] * pts_z * W / 2.0 / f
    pts_y = -pts[..., 1:2] * pts_z * H / 2.0 / f
    return torch.cat([pts_x, pts_y, pts_z], dim=-1)


def world2ndc(pts_world: torch.Tensor, H: float, W: float, f) -> torch.Tensor:
    """World -> NDC (reference: renderer.py:1276-1282)."""
    o0 = -1.0 / (W / (2.0 * f)) * pts_world[..., 0:1] / pts_world[..., 2:]
    o1 = -1.0 / (H / (2.0 * f)) * pts_world[..., 1:2] / pts_world[..., 2:]
    o2 = 1.0 + 2.0 / pts_world[..., 2:]
    return torch.cat([o0, o1, o2], dim=-1)


def contract(pts: torch.Tensor) -> torch.Tensor:
    """L-inf mip-NeRF-360 contraction into the [-2, 2] cube
    (reference: tensorBase.py:550-556)."""
    norm = torch.amax(torch.abs(pts), dim=-1, keepdim=True)
    safe = torch.clamp(norm, min=1e-9)
    contracted = (2.0 - 1.0 / safe) * (pts / safe)
    return torch.where(norm > 1.0, contracted, pts)


def contract2world(pts_contract: torch.Tensor) -> torch.Tensor:
    """Inverse contraction (reference: renderer.py:1285-1296)."""
    norm = torch.amax(torch.abs(pts_contract), dim=-1, keepdim=True)
    safe = torch.clamp(norm, min=1e-9)
    scale = -1.0 / (norm - 2.0)
    return torch.where(norm > 1.0, pts_contract / safe * scale, pts_contract)
