"""LLFF-style pose utilities: averaging, recentering, spiral paths (port
of rodynrf_tpu/data/llff.py; reference dataLoader/nvidia.py:20-137,
duplicated in davis.py). Pure numpy, host-side preprocessing.
"""

from __future__ import annotations

import numpy as np

from .imageio import resize_linear


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """(reference: nvidia.py:25-59)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, blender2opencv: np.ndarray | None = None):
    """(reference: nvidia.py:62-89)."""
    if blender2opencv is not None:
        poses = poses @ blender2opencv
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (np.linalg.inv(pose_avg_homo) @ poses_homo)[:, :3]
    return poses_centered, pose_avg_homo


def viewmatrix(z, up, pos):
    """(reference: nvidia.py:92-99)."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([-vec0, vec1, vec2, pos], 1)
    return m


def render_path_spiral(c2w, up, rads, focal, zrate, N_rots=2, N=120):
    """(reference: nvidia.py:102-114)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * N_rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(viewmatrix(z, up, c))
    return render_poses


def get_spiral(c2ws_all, near_fars, rads_scale=1.0, N_views=120):
    """(reference: nvidia.py:117-136)."""
    c2w = average_poses(c2ws_all)
    up = normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth, inf_depth = near_fars.min() * 0.9, near_fars.max() * 5.0
    focal = 1.0 / (((1.0 - dt) / close_depth + dt / inf_depth))
    tt = c2ws_all[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, focal, zrate=0.5, N=N_views))


def resize_flow(flow: np.ndarray, H_new: int, W_new: int) -> np.ndarray:
    """Resize a flow field and rescale its vectors.

    The reference scales flow x by H ratio and y by W ratio
    (nvidia.py:139-144) — swapped, but harmless there because its configs
    only use uniform downsampling. We scale each component by its own axis
    ratio (identical behavior for uniform scaling, correct otherwise). The
    resize is cv2's INTER_LINEAR (data/imageio.resize_linear).
    """
    H_old, W_old = flow.shape[0:2]
    out = resize_linear(flow, (W_new, H_new))
    out[:, :, 0] *= W_new / W_old
    out[:, :, 1] *= H_new / H_old
    return out
