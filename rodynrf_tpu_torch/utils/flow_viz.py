"""Optical-flow visualization (Middlebury color wheel; port of
rodynrf_tpu/utils/flow_viz.py, numpy only).

Equivalent of the reference's flow_viz (reference: flow_viz.py:1-136,
duplicated at scripts/RAFT/utils/flow_viz.py) — the standard Baker et al.
"A Database and Evaluation Methodology for Optical Flow" color coding.
Implemented from the published algorithm.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """55-entry RYGCBM color wheel (15 RY, 6 YG, 4 GC, 11 CB, 13 BM, 6 MR)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 visualization."""
    assert flow.ndim == 3 and flow.shape[-1] == 2
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        # saturate towards white at small radii
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col)
    return img
