"""Loss functions for the joint static/dynamic/camera optimization (port of
rodynrf_tpu/train/losses.py; each matches a reference loss term, citations
into the reference train.py). Mask-based, no boolean indexing."""

from __future__ import annotations

import torch


def abs_(x):
    """|x| with the JAX package's subgradient at 0: jnp.abs passes +1 there,
    torch.abs 0. The disparity pairs take it (train/step.py `_warped_pair`):
    with contract rays two different empty rays can induce one disparity,
    and in the static pairs that tie's gradient is not 0. The other L1 terms keep
    torch.abs: the float64 parity tests find no gradient at their ties, and
    a +1 there adds float32 rounding that depends on how the rays are split
    over ranks."""
    return torch.where(x >= 0, x, -x)


def mse(a, b):
    return torch.mean((a - b) ** 2)


def masked_l1_mean(err_abs, mask, denom_extra: float = 1.0):
    """sum(|err| * mask) / (sum(mask) + 1e-8) / denom_extra (train.py:1391-1395)."""
    return torch.sum(err_abs * mask) / (torch.sum(mask) + 1e-8) / denom_extra


def skewed_entropy(mask_map):
    """Skewed binary entropy of the dynamicness map (train.py:1250-1259)."""
    m = torch.clamp(mask_map, 1e-6, 1.0 - 1e-6)
    m2 = m * m
    return torch.mean(-(m2 * torch.log(m2) + (1 - m2) * torch.log(1 - m2)))


def adaptive_order_loss(depth_d, depth_s_detached, dynamicness_detached, ray_type):
    """Depth-order consistency on static regions (train.py:1276-1292, 1666-1680)."""
    w = 1.0 - dynamicness_detached
    if ray_type == "ndc":
        err = (depth_d - depth_s_detached) ** 2
    else:  # contract
        err = (1.0 / (depth_d + 1e-6) - 1.0 / (depth_s_detached + 1e-6)) ** 2
    return torch.sum(err * w) / (torch.sum(w) + 1e-8)


def _masked_lower_median(x, valid):
    """Torch-style lower median of x [R] over each row of valid [T, R]
    (invalid entries sort to +inf; index (count-1)//2). Returns [T]."""
    big = torch.where(valid, x[None, :], torch.inf)
    srt = torch.sort(big, dim=-1).values
    count = torch.sum(valid.to(torch.int64), dim=-1)
    idx = torch.div(torch.clamp(count - 1, min=0), 2, rounding_mode="floor")
    return torch.gather(srt, 1, idx[:, None])[:, 0]


def compute_depth_loss_masked(dyn_depth, gt_depth, valid):
    """Median/MAD-normalized depth loss over each camera's subset
    (reference: train.py:797-807), batched over cameras: valid [T, R] -> [T]."""
    v = valid.to(dyn_depth.dtype)
    n = torch.clamp(torch.sum(v, dim=-1), min=1.0)
    t_d = _masked_lower_median(dyn_depth, valid)[:, None]
    s_d = (torch.sum(torch.abs(dyn_depth[None] - t_d) * v, dim=-1) / n)[:, None]
    d_norm = (dyn_depth[None] - t_d) / (s_d + 1e-10)

    t_g = _masked_lower_median(gt_depth, valid)[:, None]
    s_g = (torch.sum(torch.abs(gt_depth[None] - t_g) * v, dim=-1) / n)[:, None]
    g_norm = (gt_depth[None] - t_g) / (s_g + 1e-10)
    return torch.sum(((d_norm - g_norm) ** 2) * v, dim=-1)


def monodepth_loss(depth, target, t_ref, n_cams: int, extra_valid=None):
    """Per-camera normalized monodepth loss (reference: train.py:1635-1658,
    2096-2113): Σ_cam depth_loss(cam subset) / Σ_cam |subset|, cameras with
    ≤1 valid ray skipped."""
    cams = torch.arange(n_cams, device=depth.device)
    valid = t_ref[None, :] == cams[:, None]  # [T, R]
    if extra_valid is not None:
        valid = valid & extra_valid[None, :]
    n = torch.sum(valid.to(depth.dtype), dim=-1)
    use = n > 1.0
    losses = torch.where(use, compute_depth_loss_masked(depth, target, valid), 0.0)
    counts = torch.where(use, n, 0.0)
    return torch.sum(losses) / torch.clamp(torch.sum(counts), min=1.0)


def disp_smooth_loss(depth, depth_i_neighbor, depth_j_neighbor):
    """Disparity smoothness vs pixel neighbors (train.py:2293-2305)."""
    inv = 1.0 / torch.clamp(depth, min=1e-6)
    inv_i = 1.0 / torch.clamp(depth_i_neighbor, min=1e-6)
    inv_j = 1.0 / torch.clamp(depth_j_neighbor, min=1e-6)
    return torch.mean((inv - inv_i) ** 2) + torch.mean((inv - inv_j) ** 2)
