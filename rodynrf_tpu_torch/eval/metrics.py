"""Quality metrics: PSNR, SSIM, LPIPS (when weights exist), depth
visualization (port of rodynrf_tpu/eval/metrics.py; reference
utils.py:98-151 rgb_ssim, 79-84 rgb_lpips, 13-55 visualize_depth).

PSNR, SSIM and the colormaps are numpy and scipy; LPIPS runs the port's
network (eval/lpips.py) on the caller's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import check_device
from .lpips import load_lpips


def psnr(img0: np.ndarray, img1: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(img0) - np.asarray(img1)) ** 2))
    return -10.0 * np.log(mse) / np.log(10.0)


def rgb_ssim(
    img0,
    img1,
    max_val,
    filter_size=11,
    filter_sigma=1.5,
    k1=0.01,
    k2=0.03,
    return_map=False,
):
    """Gaussian-window SSIM (reference: utils.py:98-151, mipnerf-derived)."""
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    # imported here: scipy.signal pulls in numpy.testing, which runs a command at import
    import scipy.signal

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack(
            [convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
             for i in range(z.shape[-1])],
            -1,
        )

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = filt_fn(img0**2) - mu00
    sigma11 = filt_fn(img1**2) - mu11
    sigma01 = filt_fn(img0 * img1) - mu01

    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11), np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


_LPIPS_MODELS = {}  # (weights path, net, device) -> eval.lpips.LPIPS
_LPIPS_MISS_LOGGED = set()


def _lpips_weights(net_name: str):
    """The path of the `lpips` state-dict dump for `net_name`:
    $LPIPS_WEIGHTS_{NET}, else $LPIPS_WEIGHTS_DIR/lpips_{net}.pth; None when
    neither names a file."""
    path = os.environ.get(f"LPIPS_WEIGHTS_{net_name.upper()}")
    if not path:
        d = os.environ.get("LPIPS_WEIGHTS_DIR")
        path = os.path.join(d, f"lpips_{net_name}.pth") if d else None
    return path if path and os.path.exists(path) else None


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex", device="cuda"):
    """LPIPS of two [H, W, 3] images in [0, 1] (reference: utils.py:68-84),
    scored on `device` (the card unless the caller asks for the CPU) by the
    port's network with the weights `_lpips_weights` finds. Without weights
    it returns None, touching no device, and prints a one-line notice once
    per network; a miss is not cached (the weights may appear later in the
    process)."""
    path = _lpips_weights(net_name)
    if path is None:
        if net_name not in _LPIPS_MISS_LOGGED:
            print(f"[lpips] no weights for '{net_name}' (set $LPIPS_WEIGHTS_DIR); "
                  "scoring without lpips")
            _LPIPS_MISS_LOGGED.add(net_name)
        return None
    dev = check_device(device)
    key = (path, net_name, dev)
    if key not in _LPIPS_MODELS:
        _LPIPS_MODELS[key] = load_lpips(path, net_name, dev)

    def nchw(x):
        x = np.ascontiguousarray(np.asarray(x, np.float32).transpose(2, 0, 1))
        return torch.from_numpy(x)[None].to(dev)

    with torch.no_grad():
        return float(_LPIPS_MODELS[key](nchw(np_gt), nchw(np_im))[0])


# cv2's COLORMAP_JET (OpenCV 5.0.0, `cv2.applyColorMap` of the levels
# 0-255), as RGB: the JAX package colours depth through cv2
_JET_RGB = np.array([
    (0, 0, 128), (0, 0, 132), (0, 0, 136), (0, 0, 140), (0, 0, 144),
    (0, 0, 148), (0, 0, 152), (0, 0, 156), (0, 0, 160), (0, 0, 164),
    (0, 0, 168), (0, 0, 172), (0, 0, 176), (0, 0, 180), (0, 0, 184),
    (0, 0, 188), (0, 0, 192), (0, 0, 196), (0, 0, 200), (0, 0, 204),
    (0, 0, 208), (0, 0, 212), (0, 0, 216), (0, 0, 220), (0, 0, 224),
    (0, 0, 228), (0, 0, 232), (0, 0, 236), (0, 0, 240), (0, 0, 244),
    (0, 0, 248), (0, 0, 252), (0, 0, 255), (0, 4, 255), (0, 8, 255),
    (0, 12, 255), (0, 16, 255), (0, 20, 255), (0, 24, 255), (0, 28, 255),
    (0, 32, 255), (0, 36, 255), (0, 40, 255), (0, 44, 255), (0, 48, 255),
    (0, 52, 255), (0, 56, 255), (0, 60, 255), (0, 64, 255), (0, 68, 255),
    (0, 72, 255), (0, 76, 255), (0, 80, 255), (0, 84, 255), (0, 88, 255),
    (0, 92, 255), (0, 96, 255), (0, 100, 255), (0, 104, 255), (0, 108, 255),
    (0, 112, 255), (0, 116, 255), (0, 120, 255), (0, 124, 255), (0, 128, 255),
    (0, 132, 255), (0, 136, 255), (0, 140, 255), (0, 144, 255), (0, 148, 255),
    (0, 152, 255), (0, 156, 255), (0, 160, 255), (0, 164, 255), (0, 168, 255),
    (0, 172, 255), (0, 176, 255), (0, 180, 255), (0, 184, 255), (0, 188, 255),
    (0, 192, 255), (0, 196, 255), (0, 200, 255), (0, 204, 255), (0, 208, 255),
    (0, 212, 255), (0, 216, 255), (0, 220, 255), (0, 224, 255), (0, 228, 255),
    (0, 232, 255), (0, 236, 255), (0, 240, 255), (0, 244, 255), (0, 248, 255),
    (0, 252, 255), (2, 255, 254), (6, 255, 250), (10, 255, 246), (14, 255, 242),
    (18, 255, 238), (22, 255, 234), (26, 255, 230), (30, 255, 226), (34, 255, 222),
    (38, 255, 218), (42, 255, 214), (46, 255, 210), (50, 255, 206), (54, 255, 202),
    (58, 255, 198), (62, 255, 194), (66, 255, 190), (70, 255, 186), (74, 255, 182),
    (78, 255, 178), (82, 255, 174), (86, 255, 170), (90, 255, 166), (94, 255, 162),
    (98, 255, 158), (102, 255, 154), (106, 255, 150), (110, 255, 146), (114, 255, 142),
    (118, 255, 138), (122, 255, 134), (126, 255, 130), (130, 255, 126), (134, 255, 122),
    (138, 255, 118), (142, 255, 114), (146, 255, 110), (150, 255, 106), (154, 255, 102),
    (158, 255, 98), (162, 255, 94), (166, 255, 90), (170, 255, 86), (174, 255, 82),
    (178, 255, 78), (182, 255, 74), (186, 255, 70), (190, 255, 66), (194, 255, 62),
    (198, 255, 58), (202, 255, 54), (206, 255, 50), (210, 255, 46), (214, 255, 42),
    (218, 255, 38), (222, 255, 34), (226, 255, 30), (230, 255, 26), (234, 255, 22),
    (238, 255, 18), (242, 255, 14), (246, 255, 10), (250, 255, 6), (254, 255, 1),
    (255, 252, 0), (255, 248, 0), (255, 244, 0), (255, 240, 0), (255, 236, 0),
    (255, 232, 0), (255, 228, 0), (255, 224, 0), (255, 220, 0), (255, 216, 0),
    (255, 212, 0), (255, 208, 0), (255, 204, 0), (255, 200, 0), (255, 196, 0),
    (255, 192, 0), (255, 188, 0), (255, 184, 0), (255, 180, 0), (255, 176, 0),
    (255, 172, 0), (255, 168, 0), (255, 164, 0), (255, 160, 0), (255, 156, 0),
    (255, 152, 0), (255, 148, 0), (255, 144, 0), (255, 140, 0), (255, 136, 0),
    (255, 132, 0), (255, 128, 0), (255, 124, 0), (255, 120, 0), (255, 116, 0),
    (255, 112, 0), (255, 108, 0), (255, 104, 0), (255, 100, 0), (255, 96, 0),
    (255, 92, 0), (255, 88, 0), (255, 84, 0), (255, 80, 0), (255, 76, 0),
    (255, 72, 0), (255, 68, 0), (255, 64, 0), (255, 60, 0), (255, 56, 0),
    (255, 52, 0), (255, 48, 0), (255, 44, 0), (255, 40, 0), (255, 36, 0),
    (255, 32, 0), (255, 28, 0), (255, 24, 0), (255, 20, 0), (255, 16, 0),
    (255, 12, 0), (255, 8, 0), (255, 4, 0), (255, 0, 0), (252, 0, 0),
    (248, 0, 0), (244, 0, 0), (240, 0, 0), (236, 0, 0), (232, 0, 0),
    (228, 0, 0), (224, 0, 0), (220, 0, 0), (216, 0, 0), (212, 0, 0),
    (208, 0, 0), (204, 0, 0), (200, 0, 0), (196, 0, 0), (192, 0, 0),
    (188, 0, 0), (184, 0, 0), (180, 0, 0), (176, 0, 0), (172, 0, 0),
    (168, 0, 0), (164, 0, 0), (160, 0, 0), (156, 0, 0), (152, 0, 0),
    (148, 0, 0), (144, 0, 0), (140, 0, 0), (136, 0, 0), (132, 0, 0),
    (128, 0, 0),
], dtype=np.uint8)


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """uint8 [...] -> RGB uint8 [..., 3]: cv2's COLORMAP_JET, level by level."""
    return _JET_RGB[np.asarray(x).astype(np.uint8)]


def visualize_depth_numpy(depth: np.ndarray, minmax=None, cmap_id=None):
    """Depth -> JET-colormapped RGB uint8 (reference: utils.py:13-35).
    Only the JET colormap is carried; `cmap_id` must be None."""
    if cmap_id is not None:
        raise NotImplementedError("visualize_depth_numpy carries only the JET colormap")
    x = np.nan_to_num(depth)
    if minmax is None:
        mi = np.min(x[x > 0]) if np.any(x > 0) else 0.0
        ma = np.max(x)
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    return jet_colormap(x), [mi, ma]
