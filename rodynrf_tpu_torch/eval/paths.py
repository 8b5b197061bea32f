"""Novel-view camera path generation + path rendering (port of
rodynrf_tpu/eval/paths.py).

Functional equivalents of the reference's `generate_path`
(reference: train.py:166-330), `generate_follow_spiral` (train.py:334-413),
and `evaluation_path` (renderer.py:969-1263). Five path families:
dolly, zoom, spiral, fix_view, change_view_time.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..data.imageio import write_png
from ..render.renderer import render_image
from .evaluation import write_video
from .metrics import visualize_depth_numpy


def _offset_pose(c2w: np.ndarray, x_trans: float, y_trans: float, z_trans: float) -> np.ndarray:
    """ref_pose @ inv(translation) (reference: train.py:183-198)."""
    i_pose = np.eye(4)
    i_pose[:3, 3] = [x_trans, y_trans, z_trans]
    i_pose = np.linalg.inv(i_pose)
    ref_pose = np.eye(4)
    ref_pose[:3, :4] = c2w[:3, :4]
    return (ref_pose @ i_pose)[:3, :]


def generate_path(c2w: np.ndarray, focal: float, sc: float, length: int):
    """(reference: train.py:166-330). Returns dict of (poses [N,3,4],
    focals [N]) per path name."""
    max_disp = 48.0
    max_trans = max_disp / focal * sc

    dolly_poses, dolly_focals = [], []
    for i in range(30):
        z_trans = max_trans * 2.5 * i / float(30 // 2)
        dolly_poses.append(_offset_pose(c2w, 0.0, 0.0, z_trans))
        dolly_focals.append(focal - focal * 0.1 * z_trans / max_trans / 2.5)

    zoom_poses, zoom_focals = [], []
    for i in range(30):
        z_trans = max_trans * 2.5 * i / float(30 // 2)
        zoom_poses.append(_offset_pose(c2w, 0.0, 0.0, z_trans))
        zoom_focals.append(focal)

    spiral_poses, spiral_focals = [], []
    for i in range(30):
        x_trans = max_trans * 1.5 * np.sin(2.0 * np.pi * i / 30.0) * 2.0
        y_trans = max_trans * 1.5 * (np.cos(2.0 * np.pi * i / 30.0) - 1.0) * 2.0 / 3.0
        spiral_poses.append(_offset_pose(c2w, x_trans, y_trans, 0.0))
        spiral_focals.append(focal)

    fix_view_poses = [c2w[:3, :4].copy() for _ in range(length)]
    fix_view_focals = [focal] * length

    cvt_poses, cvt_focals = [], []
    for i in range(length):
        x_trans = max_trans * 1.5 * np.sin(2.0 * np.pi * i / 30.0) * 2.0
        y_trans = max_trans * 1.5 * (np.cos(2.0 * np.pi * i / 30.0) - 1.0) * 2.0 / 3.0
        cvt_poses.append(_offset_pose(c2w, x_trans, y_trans, 0.0))
        cvt_focals.append(focal)

    return {
        "dolly": (np.stack(dolly_poses), np.asarray(dolly_focals)),
        "zoom": (np.stack(zoom_poses), np.asarray(zoom_focals)),
        "spiral": (np.stack(spiral_poses), np.asarray(spiral_focals)),
        "fix_view": (np.stack(fix_view_poses), np.asarray(fix_view_focals)),
        "change_view_time": (np.stack(cvt_poses), np.asarray(cvt_focals)),
    }


def generate_follow_spiral(c2ws: np.ndarray, focal: float, sc: float):
    """(reference: train.py:334-413): forward then backward wiggle."""
    num = int(c2ws.shape[0] * 2)
    max_trans = 48.0 * 2 / focal * sc
    poses = []
    for i in range(c2ws.shape[0]):
        x = max_trans * np.sin(2.0 * np.pi * i / num * 4.0)
        y = max_trans * (np.cos(2.0 * np.pi * i / num * 4.0) - 1.0) * 0.33
        poses.append(_offset_pose(c2ws[i], x, y, 0.0))
    for i in range(c2ws.shape[0]):
        x = max_trans * np.sin(2.0 * np.pi * i / num * 2.0)
        y = max_trans * (np.cos(2.0 * np.pi * i / num * 2.0) - 1.0) * 0.33
        poses.append(_offset_pose(c2ws[c2ws.shape[0] - 1 - i], x, y, 0.0))
    return poses


def evaluation_path(
    render_chunk_builder,
    params,
    aabb,
    poses: np.ndarray,
    focals: Sequence[float],
    scene,
    ray_type: str,
    save_path: str,
    prtx: str = "",
    change_time="change",
    chunk: int = 8192,
):
    """Render an arbitrary pose/focal path (reference: renderer.py:969-1263).

    ``change_time`` = "change" sweeps scene time across frames; a float holds
    time fixed. render_chunk_builder: the chunk renderer (the focal is an
    argument of render_image, so it may vary per frame for dolly/zoom).
    """
    W, H = scene.img_wh
    os.makedirs(save_path, exist_ok=True)
    os.makedirs(save_path + "/rgbd_npy", exist_ok=True)
    N = len(poses)
    frames, depths = [], []
    for i in range(N):
        if change_time == "change":
            t_val = i / max(N - 1, 1) * 2.0 - 1.0
        else:
            t_val = float(change_time)
        maps = render_image(
            render_chunk_builder, params, aabb, poses[i], float(focals[i]), t_val,
            H, W, ray_type, chunk=chunk,
        )
        rgb8 = (maps["rgb"] * 255).astype(np.uint8)
        depth = maps["depth"]
        if ray_type == "contract":
            depth = -1.0 / (depth + 1e-6)
        frames.append(rgb8)
        depths.append(depth)
        write_png(f"{save_path}/{prtx}{i:03d}.png", rgb8)
        np.save(f"{save_path}/rgbd_npy/{prtx}{i:03d}.npy", depth)

    write_video(f"{save_path}/{prtx}video.mp4", frames)

    # global-quantile depth video (reference: train.py:628-735)
    all_depth = np.stack(depths)
    dmin = float(np.quantile(all_depth[:, ::4, ::4], 0.05))
    dmax = float(np.quantile(all_depth[:, ::4, ::4], 0.95))
    depth_frames = [
        visualize_depth_numpy(np.clip(d, dmin, dmax), (dmin, dmax))[0] for d in depths
    ]
    write_video(f"{save_path}/{prtx}depthvideo.mp4", depth_frames)
    return frames, depths
