"""Procedural tiny dynamic scene — the framework's deterministic test fixture.

The reference has no tests and no fixture (SURVEY.md §4); this generates a
small monocular video of a moving Gaussian blob over a gradient background,
with consistent fake optical flow, disparity, and motion masks, shaped
exactly like the Nvidia/DAVIS loaders' outputs.
"""

from __future__ import annotations

import numpy as np

from .scene import SceneData, default_bbox, default_focal


def make_synthetic_scene(
    T: int = 4, H: int = 24, W: int = 32, ray_type: str = "ndc", seed: int = 0
) -> SceneData:
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")

    rgbs = np.zeros((T, H, W, 3), np.float32)
    fg = np.zeros((T, H, W), np.float32)
    flows_f = np.zeros((T, H, W, 2), np.float32)
    flows_b = np.zeros((T, H, W, 2), np.float32)
    disps = np.zeros((T, H, W), np.float32)

    # blob trajectory: left -> right
    cx = np.linspace(W * 0.25, W * 0.75, T)
    cy = np.full(T, H * 0.5)
    r = min(H, W) * 0.15

    for t in range(T):
        base = np.stack(
            [xx / W * 0.5 + 0.25, yy / H * 0.5 + 0.25, np.full_like(xx, 0.4)], -1
        )
        blob = np.exp(-(((xx - cx[t]) ** 2 + (yy - cy[t]) ** 2) / (2 * r * r)))
        rgbs[t] = base * (1 - blob[..., None]) + blob[..., None] * np.array([0.9, 0.2, 0.1])
        fg[t] = (blob > 0.4).astype(np.float32)
        dx = cx[min(t + 1, T - 1)] - cx[t]
        flows_f[t, ..., 0] = dx * (blob > 0.1)
        dxb = cx[max(t - 1, 0)] - cx[t]
        flows_b[t, ..., 0] = dxb * (blob > 0.1)
        disps[t] = 0.5 + 0.3 * (yy / H) + 0.4 * blob

    flow_masks = np.ones((T, H, W), np.float32)

    ts = np.linspace(-1.0, 1.0, T, dtype=np.float32)
    ts_full = np.repeat(ts, H * W)

    poses = np.zeros((T, 3, 4), np.float32)
    poses[:, 0, 0] = poses[:, 1, 1] = poses[:, 2, 2] = 1.0
    # slight camera translation per frame
    poses[:, 0, 3] = np.linspace(-0.02, 0.02, T)

    return SceneData(
        rgbs=rgbs.reshape(-1, 3),
        ts=ts_full,
        flows_f=flows_f.reshape(-1, 2),
        flow_masks_f=flow_masks.reshape(-1),
        flows_b=flows_b.reshape(-1, 2),
        flow_masks_b=flow_masks.reshape(-1),
        disps=disps.reshape(-1),
        fg_masks=fg.reshape(-1),
        img_wh=(W, H),
        n_frames=T,
        scene_bbox=default_bbox(ray_type),
        near_far=(0.0, 1.0) if ray_type == "ndc" else (0.1, 256.0),
        focal=default_focal(W, H),
        poses=poses,
        white_bg=False,
        rgbs_stack=rgbs,
    )
