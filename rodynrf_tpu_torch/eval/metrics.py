"""Quality metrics: PSNR, SSIM, LPIPS (when weights exist), depth
visualization (port of rodynrf_tpu/eval/metrics.py; reference
utils.py:98-151 rgb_ssim, 79-84 rgb_lpips, 13-55 visualize_depth).

numpy and scipy only. The LPIPS network is a later slice of the port
(ROADMAP.md queue 1, item 3); until then `rgb_lpips` returns None, as the JAX
package's does without weights.
"""

from __future__ import annotations

import numpy as np


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


_LPIPS_MISS_LOGGED = set()


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex"):
    """LPIPS (reference: utils.py:68-84). The port has no LPIPS network yet
    (ROADMAP.md queue 1, item 3), so there are no weights: returns None and prints
    a one-line notice once per network, as the JAX package does without
    weights."""
    if net_name not in _LPIPS_MISS_LOGGED:
        print(f"[lpips] no weights for '{net_name}' (the LPIPS network is not ported "
              "yet); scoring without lpips")
        _LPIPS_MISS_LOGGED.add(net_name)
    return None


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """uint8 [...] -> RGB uint8 [..., 3]: cv2's COLORMAP_JET (piecewise
    linear in steps of 4 levels; cv2's own table differs by one level at
    one entry)."""
    x = np.asarray(x).astype(np.int32)
    ch = [np.minimum(4 * x - 382, 1148 - 4 * x),  # red
          np.minimum(4 * x - 128, 892 - 4 * x),  # green
          np.minimum(4 * x + 128, 638 - 4 * x)]  # blue
    return np.clip(np.stack(ch, -1), 0, 255).astype(np.uint8)


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
