"""Test-set evaluation: render every training view, score, write artifacts
(port of rodynrf_tpu/eval/evaluation.py).

Functional equivalent of the reference's `evaluation`
(reference: renderer.py:660-966): renders each view at its own timestamp,
computes PSNR (+SSIM/LPIPS when available), writes per-frame PNGs, depth
.npys, mp4 videos, and `mean.txt`, and returns per-frame near/far bounds
from static-depth quantiles (used by the poses_bounds export,
train.py:2642-2658). PNGs are written by data/imageio.py, so no image
library is needed; videos are best-effort.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np

from ..data.imageio import write_png
from ..render.renderer import render_image
from .metrics import psnr as psnr_fn
from .metrics import rgb_lpips, rgb_ssim


def write_video(path: str, frames: List[np.ndarray], fps: int = 30):
    """mp4 writer via imageio-ffmpeg with cv2 fallback; without either it
    writes nothing and says so in one line."""
    arr = np.stack(frames)
    try:
        import imageio

        imageio.mimwrite(path, arr, fps=fps, quality=8)
        return
    except Exception:
        pass
    try:
        import cv2

        h, w = arr.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in arr:
            vw.write(f[..., ::-1])
        vw.release()
        return
    except Exception:
        pass  # video export is best-effort (matches reference robustness)
    print(f"[video] {path} not written (neither imageio nor cv2 can write mp4 here)")


def evaluate(
    render_chunk,
    params,
    aabb,
    poses_mtx: np.ndarray,
    focal: float,
    scene,
    ray_type: str,
    save_path: Optional[str] = None,
    prtx: str = "",
    n_vis: int = -1,
    compute_extra_metrics: bool = False,
    chunk: int = 8192,
    frame_seconds: Optional[List[float]] = None,
):
    """Returns (PSNRs, near_fars, depth_maps). `frame_seconds`, if given,
    gets each frame's render time (render_image returns host arrays, so the
    device's work is inside it). LPIPS, where weights are given, runs on the
    device of `aabb` (a tensor, as the renderer takes it)."""
    W, H = scene.img_wh
    T = poses_mtx.shape[0]
    interval = 1 if n_vis < 0 else max(T // n_vis, 1)
    idxs = list(range(0, T, interval))

    if save_path is not None:
        for sub in ("", "_static", "_dynamic"):
            os.makedirs(save_path + sub, exist_ok=True)
            os.makedirs(save_path + sub + "/rgbd", exist_ok=True)

    PSNRs, ssims, l_alexes, l_vggs = [], [], [], []
    near_fars: List[Tuple[float, float]] = []
    rgb_frames, rgb_s_frames, rgb_d_frames, depth_maps = [], [], [], []

    ts_per_frame = (
        np.linspace(-1.0, 1.0, scene.n_frames) if scene.n_frames > 1 else np.zeros(1)
    )

    for out_i, idx in enumerate(idxs):
        t0 = time.perf_counter()
        maps = render_image(
            render_chunk, params, aabb, poses_mtx[idx], focal,
            float(ts_per_frame[idx]), H, W, ray_type, chunk=chunk,
        )
        if frame_seconds is not None:
            frame_seconds.append(time.perf_counter() - t0)
        depth_s = maps["depth_s"]
        # near/far from static-depth quantiles (renderer.py:848-861)
        if ray_type == "contract":
            near_fars.append(
                (float(np.quantile(depth_s, 0.01)), float(np.quantile(depth_s, 0.99)))
            )
        else:
            inv = 1.0 / (depth_s + 1e-6)
            near_fars.append((float(np.quantile(inv, 0.01)), float(np.quantile(inv, 0.99))))

        depth = maps["depth"]
        if ray_type == "contract":
            depth = -1.0 / (depth + 1e-6)
            depth_s = -1.0 / (depth_s + 1e-6)

        if scene.rgbs_stack is not None and idx < len(scene.rgbs_stack):
            gt = scene.rgbs_stack[idx]
            PSNRs.append(psnr_fn(maps["rgb"], gt))
            if compute_extra_metrics:
                ssims.append(rgb_ssim(maps["rgb"], gt, 1))
                la = rgb_lpips(gt, maps["rgb"], "alex", device=aabb.device)
                lv = rgb_lpips(gt, maps["rgb"], "vgg", device=aabb.device)
                if la is not None:
                    l_alexes.append(la)
                if lv is not None:
                    l_vggs.append(lv)

        rgb8 = (maps["rgb"] * 255).astype(np.uint8)
        rgb8_s = (maps["rgb_s"] * 255).astype(np.uint8)
        rgb8_d = (maps["rgb_d"] * 255).astype(np.uint8)
        rgb_frames.append(rgb8)
        rgb_s_frames.append(rgb8_s)
        rgb_d_frames.append(rgb8_d)
        depth_maps.append(depth)

        if save_path is not None:
            write_png(f"{save_path}/{prtx}{out_i:03d}.png", rgb8)
            write_png(f"{save_path}_static/{prtx}{out_i:03d}.png", rgb8_s)
            write_png(f"{save_path}_dynamic/{prtx}{out_i:03d}.png", rgb8_d)
            blending8 = (np.clip(maps["blending"], 0, 1) * 255).astype(np.uint8)
            write_png(f"{save_path}_dynamic/{prtx}{out_i:03d}_blending.png", blending8)
            np.save(f"{save_path}/rgbd/{prtx}{out_i:03d}.npy", depth)
            np.save(f"{save_path}_static/rgbd/{prtx}{out_i:03d}.npy", depth_s)

    if save_path is not None:
        write_video(f"{save_path}/{prtx}video.mp4", rgb_frames)
        write_video(f"{save_path}_static/{prtx}video.mp4", rgb_s_frames)
        write_video(f"{save_path}_dynamic/{prtx}video.mp4", rgb_d_frames)
        if PSNRs:
            stats = [float(np.mean(PSNRs))]
            if compute_extra_metrics and ssims:
                stats.append(float(np.mean(ssims)))
                stats.append(float(np.mean(l_alexes)) if l_alexes else float("nan"))
                stats.append(float(np.mean(l_vggs)) if l_vggs else float("nan"))
            np.savetxt(f"{save_path}/{prtx}mean.txt", np.asarray(stats))

    return PSNRs, near_fars, depth_maps


def export_poses_bounds(
    path: str, poses_mtx: np.ndarray, focal: float, H: int, W: int, downsample: float,
    near_fars,
):
    """`poses_bounds_RoDynRF.npy` export (reference: train.py:2642-2658):
    axis-swapped [-y, x, z, t] poses + (H, W, f)*downsample + near/far."""
    T = poses_mtx.shape[0]
    p = np.concatenate(
        [-poses_mtx[..., 1:2], poses_mtx[..., :1], poses_mtx[..., 2:4]], -1
    )
    hwf = np.array([H, W, focal], np.float64) * downsample
    hwf = np.tile(hwf[None, :, None], (T, 1, 1))
    flat = np.concatenate([p, hwf], -1).reshape(T, -1)
    out = np.concatenate([flat, np.asarray(near_fars, np.float64)], -1)
    np.save(path, out)
    return out
