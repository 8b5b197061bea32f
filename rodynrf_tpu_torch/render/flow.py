"""Induced optical flow & disparity from volumetric 3D points (port of
rodynrf_tpu/render/flow.py; reference renderer.py:1299-1392)."""

from __future__ import annotations

import torch

from ..core.spaces import contract, contract2world, ndc2world, world2ndc


def render_3d_point(H, W, f, c2w, weights, pts, rays, ray_type: str = "ndc"):
    """Expected 3D point per ray -> neighbor-camera pixel + NDC depth
    (reference: renderer.py:1328-1370). c2w [R, 3, 4] per-ray neighbor poses;
    weights [R, S]; pts [R, S, 3]; rays [R, 6]."""
    w2c = torch.transpose(c2w[:, :3, :3], 1, 2)

    acc_map = torch.sum(weights, -1)[:, None]
    pts_map = torch.sum(weights[..., None] * pts, -2)
    if ray_type == "ndc":
        pts_map = pts_map + (1.0 - acc_map) * (rays[:, :3] + rays[:, 3:])
    elif ray_type == "contract":
        pts_map = pts_map + (1.0 - acc_map) * contract(rays[:, :3] + rays[:, 3:] * 256.0)

    pts_world = ndc2world(pts_map, H, W, f) if ray_type == "ndc" else contract2world(pts_map)
    pts_world = pts_world - c2w[..., 3]
    pts_cam = torch.sum(pts_world[..., None, :] * w2c[:, :3, :3], -1)

    pts_plane = torch.cat(
        [
            pts_cam[..., 0:1] / (-pts_cam[..., 2:]) * f + W * 0.5,
            -pts_cam[..., 1:2] / (-pts_cam[..., 2:]) * f + H * 0.5,
        ],
        -1,
    )
    pts_cam_ndc = world2ndc(pts_cam, H, W, f)
    return pts_plane, pts_cam_ndc[:, 2:]


def induce_flow(H, W, focal, pose_neighbor, weights, pts_3d, pts_2d, rays, ray_type="ndc"):
    """(reference: renderer.py:1383-1392). Returns (flow [R,2], disparity [R,1])."""
    pts_2d_neighbor, induced_disp = render_3d_point(
        H, W, focal, pose_neighbor, weights, pts_3d, rays, ray_type
    )
    return pts_2d_neighbor - pts_2d, induced_disp


def render_single_3d_point(H, W, f, c2w, pt_ndc):
    """One NDC point per ray -> neighbor-camera pixel + disparity in [0, 1]
    (reference: renderer.py:1299-1325). c2w [R, 3, 4]; pt_ndc [R, 3]."""
    w2c = torch.transpose(c2w[:, :3, :3], 1, 2)
    pts_world = ndc2world(pt_ndc, H, W, f) - c2w[..., 3]
    pts_cam = torch.sum(pts_world[..., None, :] * w2c[:, :3, :3], -1)
    pts_plane = torch.cat(
        [
            pts_cam[..., 0:1] / (-pts_cam[..., 2:]) * f + W * 0.5,
            -pts_cam[..., 1:2] / (-pts_cam[..., 2:]) * f + H * 0.5,
        ],
        -1,
    )
    pts_cam_ndc = world2ndc(pts_cam, H, W, f)
    return pts_plane, (pts_cam_ndc[:, 2:] + 1.0) / 2.0


def induce_flow_single(H, W, focal, pose_neighbor, pts_3d_neighbor, pts_2d):
    """(reference: renderer.py:1373-1380). Returns flow [R, 2]."""
    pts_2d_neighbor, _ = render_single_3d_point(H, W, focal, pose_neighbor, pts_3d_neighbor)
    return pts_2d_neighbor - pts_2d
