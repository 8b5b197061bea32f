"""Motion masks: Sampson epipolar error ∪ semantic segmentation (port of
rodynrf_tpu/preprocess/motion_masks.py; reference scripts/generate_mask.py:
29-67 uv grid and Sampson error, 150-302 the main loop). Per frame: fit a
fundamental matrix to the flow's correspondences by least median of
squares, score each pixel's Sampson error, keep the top-quantile outliers,
clean them morphologically, and unite them with a semantic mask of movable
classes when one is given.

The JAX package fits F with cv2.findFundamentalMat(x1, x2, FM_LMEDS) on the
host. The card has no cv2, so the port carries cv2's LMedS
(calib3d/src/ptsetreg.cpp, fundam.cpp) as batched tensor code that runs
where the flow is:
- cv2's number of hypotheses: RANSACUpdateNumIters(confidence 0.99, outlier
  ratio 0.45, 7 points, at most 1000 iterations) = 300;
- each hypothesis 7 distinct points drawn from an explicit, seeded
  torch.Generator (on the CPU, so that the card and the CPU draw the same
  samples), rejected as cv2's getSubset rejects them: the last point on a
  line through two others, in either image;
- the normalised 7-point solution (two-dimensional null space by SVD, the
  cubic det(λF1 + (1-λ)F2) = 0 solved as cv2's solveCubic solves it, one to
  three models, F33 = 1), all in float64;
- scored as cv2 scores them: the median (element count/2) of max(d1², d2²),
  the squared distances to the two epipolar lines, in float32; the lowest
  median wins, the first on ties;
- cv2's acceptance: at least 7 inliers within 2.5·1.4826·(1 + 5/(n-7))·
  sqrt(median); otherwise, or when no hypothesis gave a model, no F, and the
  error map is all zero.
Bit equality with cv2 is not the aim (cv2 draws from its own generator);
the tests hold the outcome.

Morphology is cv2's: opening with its 3×3 ellipse (a cross) and dilation
with its 5×5 ellipse, with cv2's border rule (erosion reads outside the
image as set, dilation as unset).
"""

from __future__ import annotations

import glob
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.imageio import (image_size, pil_resize, read_frames, read_image_rgb, resize_nearest,
                             write_png)
from ..device import check_device

FLT_EPSILON = float(np.finfo(np.float32).eps)
DBL_EPSILON = float(np.finfo(np.float64).eps)

# cv2.getStructuringElement(MORPH_ELLIPSE, (3, 3)) and (5, 5) as (dy, dx) offsets
ELLIPSE_3 = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
ELLIPSE_5 = [(-2, 0), (2, 0)] + [(dy, dx) for dy in (-1, 0, 1) for dx in range(-2, 3)]
LMEDS_CHUNK = 32  # hypotheses scored at once: 32 × H·W float64 errors (133 MB at 540×960)
LMEDS_SEED = 0  # the generator of generate_motion_masks's samples


def get_uv_grid(H: int, W: int, align_corners: bool = False, device="cpu") -> torch.Tensor:
    """Pixel-centre uv grid in [-1, 1], [H, W, 2] float32 (reference:
    generate_mask.py:29-50)."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    if align_corners:
        xx, yy = 2 * xx / (W - 1) - 1, 2 * yy / (H - 1) - 1
    else:
        xx, yy = 2 * (xx + 0.5) / W - 1, 2 * (yy + 0.5) / H - 1
    return torch.stack([xx, yy], -1)


def compute_sampson_error(x1: torch.Tensor, x2: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """First-order epipolar distance of x2ᵀ F x1 (reference:
    generate_mask.py:53-67); x1, x2 [..., 2], F [3, 3]."""
    F = F.to(x1.dtype)
    h1 = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    h2 = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    d1 = h1 @ F.T
    d2 = h2 @ F
    z = (h2 * d1).sum(-1)
    return z**2 / (d1[..., 0] ** 2 + d1[..., 1] ** 2 + d2[..., 0] ** 2 + d2[..., 1] ** 2)


def lmeds_iterations(confidence: float = 0.99, outlier_ratio: float = 0.45,
                     model_points: int = 7, max_iters: int = 1000) -> int:
    """cv2's RANSACUpdateNumIters, at least 3 (the LMedS registrator's rule)."""
    num = math.log(max(1.0 - confidence, np.finfo(np.float64).tiny))
    denom = math.log(1.0 - (1.0 - outlier_ratio) ** model_points)
    n = max_iters if denom >= 0 or -num >= max_iters * (-denom) else round(num / denom)
    return max(n, 3)


def _collinear_last(p: torch.Tensor) -> torch.Tensor:
    """cv2's haveCollinearPoints(ms, 7) for each sample p [B, 7, 2]: the last
    point on a line through two of the others (or too close to one)."""
    d = p[:, :6].double() - p[:, 6:].double()  # [B, 6, 2]
    j, k = torch.tril_indices(6, 6, offset=-1, device=p.device)  # k < j
    dx1, dy1, dx2, dy2 = d[:, j, 0], d[:, j, 1], d[:, k, 0], d[:, k, 1]
    lhs = (dx2 * dy1 - dy2 * dx1).abs()
    return (lhs <= FLT_EPSILON * (dx1.abs() + dy1.abs() + dx2.abs() + dy2.abs())).any(1)


def _solve_cubic(c: torch.Tensor):
    """cv2.solveCubic of c0·x³ + c1·x² + c2·x + c3 = 0 for each row of c
    [B, 4] (float64): roots [B, 3] and their validity [B, 3]. Three real
    roots when the discriminant is positive, one otherwise; a leading
    coefficient of exactly 0 gives none."""
    a0 = c[:, 0]
    ok = a0 != 0
    inv = 1.0 / torch.where(ok, a0, torch.ones_like(a0))
    a1, a2, a3 = c[:, 1] * inv, c[:, 2] * inv, c[:, 3] * inv
    Q = (a1 * a1 - 3 * a2) * (1.0 / 9)
    R = (2 * a1 * a1 * a1 - 9 * a1 * a2 + 27 * a3) * (1.0 / 54)
    d = (a1 * a1 * (a2 * a2 - 4 * a1 * a3) + 2 * a2 * (9 * a1 * a3 - 2 * a2 * a2)
         - 27 * a3 * a3) * (1.0 / 108)
    three = d > 0
    Qs = torch.where(three, Q, torch.ones_like(Q))
    theta = torch.acos((R / torch.sqrt(Qs * Qs * Qs)).clamp(-1.0, 1.0))
    t0, t1, t2 = -2 * torch.sqrt(Qs), theta / 3, a1 / 3
    r3 = torch.stack([t0 * torch.cos(t1) - t2, t0 * torch.cos(t1 + 2 * math.pi / 3) - t2,
                      t0 * torch.cos(t1 - 2 * math.pi / 3) - t2], 1)
    e = torch.pow(torch.sqrt((-d).clamp_min(0)) + R.abs(), 1.0 / 3)
    e = torch.where(R > 0, -e, e)
    r1 = (e + Q / torch.where(e == 0, torch.ones_like(e), e)) - a1 / 3
    roots = torch.where(three[:, None], r3, torch.stack([r1, r1, r1], 1))
    valid = torch.stack([ok, ok & three, ok & three], 1)
    return roots, valid


def _seven_point(m1: torch.Tensor, m2: torch.Tensor):
    """cv2's run7Point for each sample m1, m2 [B, 7, 2] (float32 points,
    float64 arithmetic): models [B, 3, 3, 3] and their validity [B, 3]."""
    m1, m2 = m1.double(), m2.double()
    c1, c2 = m1.mean(1, keepdim=True), m2.mean(1, keepdim=True)
    s1 = torch.linalg.vector_norm(m1 - c1, dim=-1).mean(1)
    s2 = torch.linalg.vector_norm(m2 - c2, dim=-1).mean(1)
    ok = (s1 >= FLT_EPSILON) & (s2 >= FLT_EPSILON)
    s1 = math.sqrt(2.0) / torch.where(ok, s1, torch.ones_like(s1))
    s2 = math.sqrt(2.0) / torch.where(ok, s2, torch.ones_like(s2))
    p = (m1 - c1) * s1[:, None, None]
    q = (m2 - c2) * s2[:, None, None]
    x0, y0, x1, y1 = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], -1)
    Vh = torch.linalg.svd(A, full_matrices=True).Vh  # [B, 9, 9]
    f2 = Vh[:, 8]
    f1 = Vh[:, 7] - f2

    def det_terms(a, b):  # coefficients as in run7Point
        t0 = b[:, 4] * b[:, 8] - b[:, 5] * b[:, 7]
        t1 = b[:, 3] * b[:, 8] - b[:, 5] * b[:, 6]
        t2 = b[:, 3] * b[:, 7] - b[:, 4] * b[:, 6]
        own = b[:, 0] * t0 - b[:, 1] * t1 + b[:, 2] * t2
        mixed = (a[:, 0] * t0 - a[:, 1] * t1 + a[:, 2] * t2
                 - a[:, 3] * (b[:, 1] * b[:, 8] - b[:, 2] * b[:, 7])
                 + a[:, 4] * (b[:, 0] * b[:, 8] - b[:, 2] * b[:, 6])
                 - a[:, 5] * (b[:, 0] * b[:, 7] - b[:, 1] * b[:, 6])
                 + a[:, 6] * (b[:, 1] * b[:, 5] - b[:, 2] * b[:, 4])
                 - a[:, 7] * (b[:, 0] * b[:, 5] - b[:, 2] * b[:, 3])
                 + a[:, 8] * (b[:, 0] * b[:, 4] - b[:, 1] * b[:, 3]))
        return own, mixed

    c3, c2_ = det_terms(f1, f2)
    c0, c1_ = det_terms(f2, f1)
    roots, valid = _solve_cubic(torch.stack([c0, c1_, c2_, c3], 1))
    valid = valid & ok[:, None]

    s = f1[:, None, 8] * roots + f2[:, None, 8]  # [B, 3]
    big = s.abs() > DBL_EPSILON
    mu = torch.where(big, 1.0 / torch.where(big, s, torch.ones_like(s)), torch.ones_like(s))
    lam = roots * mu
    Fn = f1[:, None, :] * lam[..., None] + f2[:, None, :] * mu[..., None]  # [B, 3, 9]
    Fn = torch.cat([Fn[..., :8], big.to(Fn.dtype)[..., None]], -1).reshape(-1, 3, 3, 3)

    def T(c, s):
        t = torch.zeros(c.shape[0], 3, 3, dtype=torch.float64, device=c.device)
        t[:, 0, 0] = t[:, 1, 1] = s
        t[:, 0, 2], t[:, 1, 2], t[:, 2, 2] = -s * c[:, 0, 0], -s * c[:, 0, 1], 1.0
        return t

    T1, T2 = T(c1, s1), T(c2, s2)
    Fd = T2.transpose(1, 2)[:, None] @ Fn @ T1[:, None]  # de-normalise
    f33 = Fd[..., 2, 2]
    scale = torch.where(f33.abs() > FLT_EPSILON, 1.0 / torch.where(f33 == 0, 1.0, f33), 1.0)
    return Fd * scale[..., None, None], valid


def _fm_error(x1: torch.Tensor, x2: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """cv2's FMEstimatorCallback::computeError for models F [K, 3, 3] on all
    points x1, x2 [N, 2]: max of the squared distances of x2 to F·x1's line
    and of x1 to Fᵀ·x2's line, float64 arithmetic stored as float32 [K, N]."""
    u1, v1 = x1[:, 0].double(), x1[:, 1].double()
    u2, v2 = x2[:, 0].double(), x2[:, 1].double()
    f = F.reshape(-1, 9, 1)
    a = f[:, 0] * u1 + f[:, 1] * v1 + f[:, 2]
    b = f[:, 3] * u1 + f[:, 4] * v1 + f[:, 5]
    c = f[:, 6] * u1 + f[:, 7] * v1 + f[:, 8]
    e2 = (u2 * a + v2 * b + c) ** 2 / (a * a + b * b)
    a = f[:, 0] * u2 + f[:, 3] * v2 + f[:, 6]
    b = f[:, 1] * u2 + f[:, 4] * v2 + f[:, 7]
    c = f[:, 2] * u2 + f[:, 5] * v2 + f[:, 8]
    e1 = (u1 * a + v1 * b + c) ** 2 / (a * a + b * b)
    return torch.maximum(e1, e2).float()


def find_fundamental_lmeds(x1: torch.Tensor, x2: torch.Tensor,
                           generator: torch.Generator) -> Optional[torch.Tensor]:
    """cv2.findFundamentalMat(x1, x2, FM_LMEDS) with cv2's defaults on the
    tensors' device: x1, x2 [N, 2] float32 -> F [3, 3] float64 with F33 = 1,
    or None when no model is accepted. `generator` (a CPU generator) draws
    the 7-point samples."""
    n = x1.shape[0]
    if n < 7:
        return None
    iters = lmeds_iterations()
    # cv2 draws a subset again when it is rejected; drawing 4x and keeping
    # the first `iters` acceptable ones has the same distribution
    idx = torch.randint(0, n, (4 * iters, 7), generator=generator).to(x1.device)
    srt = idx.sort(1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
    p1, p2 = x1[idx], x2[idx]
    keep = distinct & ~_collinear_last(p1) & ~_collinear_last(p2)
    order = torch.nonzero(keep).flatten()[:iters]
    if order.numel() == 0:
        return None
    models, valid = _seven_point(p1[order], p2[order])
    models, valid = models.reshape(-1, 3, 3), valid.reshape(-1)
    medians = torch.full((models.shape[0],), math.inf, dtype=torch.float32, device=x1.device)
    for s in range(0, models.shape[0], LMEDS_CHUNK):
        err = _fm_error(x1, x2, models[s:s + LMEDS_CHUNK])
        medians[s:s + LMEDS_CHUNK] = err.kthvalue(n // 2 + 1, dim=1).values
    medians = torch.where(valid & ~torch.isnan(medians), medians, math.inf)
    best = int(torch.argmin(medians))
    min_median = float(medians[best])
    if not math.isfinite(min_median):
        return None
    sigma = max(2.5 * 1.4826 * (1 + 5.0 / (n - 7)) * math.sqrt(min_median), 0.001)
    err = _fm_error(x1, x2, models[best:best + 1])[0]
    if int((err <= np.float32(sigma * sigma)).sum()) < 7:
        return None
    return models[best]


def epipolar_fit(flow: torch.Tensor, H: int, W: int, generator: torch.Generator):
    """One flow field [H, W, 2] -> (the per-pixel Sampson error scaled by
    ((H+W)/2)², [H, W] float32; whether LMedS accepted an F) (reference:
    generate_mask.py:195-224): flow in uv units, an all-zero map when no F
    was accepted."""
    x1 = get_uv_grid(H, W, device=flow.device).reshape(-1, 2)
    nflow = torch.stack([2.0 * flow[..., 0] / (W - 1), 2.0 * flow[..., 1] / (H - 1)],
                        -1).reshape(-1, 2)
    x2 = x1 + nflow
    F = find_fundamental_lmeds(x1, x2, generator)
    if F is None:
        return torch.zeros(H, W, dtype=torch.float32, device=flow.device), False
    err = compute_sampson_error(x1, x2, F.float()).reshape(H, W)
    return err * ((H + W) / 2) ** 2, True


def epipolar_error_map(flow: torch.Tensor, H: int, W: int,
                       generator: torch.Generator) -> torch.Tensor:
    """The error map of `epipolar_fit` alone."""
    return epipolar_fit(flow, H, W, generator)[0]


def _morph(mask: torch.Tensor, offsets, erode: bool) -> torch.Tensor:
    """Binary erosion (min) or dilation (max) of a bool [H, W] mask over the
    offsets; outside the image reads as set for erosion, unset for
    dilation (cv2's default border values)."""
    H, W = mask.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    padded = torch.full((H + 2 * r, W + 2 * r), erode, dtype=torch.bool, device=mask.device)
    padded[r:r + H, r:r + W] = mask
    out = torch.full_like(mask, erode)
    for dy, dx in offsets:
        s = padded[r + dy:r + dy + H, r + dx:r + dx + W]
        out = out & s if erode else out | s
    return out


def binary_opening_disk1(mask: torch.Tensor) -> torch.Tensor:
    """cv2.morphologyEx(mask, MORPH_OPEN, 3×3 ellipse) of a bool mask."""
    return _morph(_morph(mask, ELLIPSE_3, True), ELLIPSE_3, False)


def dilation_disk2(mask: torch.Tensor) -> torch.Tensor:
    """cv2.dilate(mask, 5×5 ellipse) of a bool mask, as float32."""
    return _morph(mask, ELLIPSE_5, False).float()


def motion_mask_for_frame(err_maps: List[torch.Tensor], H: int, W: int,
                          semantic_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fuse the error maps and an optional semantic mask into the final
    motion mask, float32 [H, W] of 0/1 (reference: generate_mask.py:
    258-276)."""
    err = torch.stack(err_maps, 0).amax(0)
    thresh = torch.quantile(err.reshape(-1), 0.8)
    err = torch.where(err <= thresh, torch.zeros_like(err), err)
    mask = binary_opening_disk1(err > (H * W / 8100.0))
    if semantic_mask is not None:
        mask = mask | (semantic_mask > 0.5)
    return dilation_disk2(mask)


def run_semantic_segmentation(img, model=None) -> Optional[np.ndarray]:
    """The mask of movable classes (person, vehicles, accessories, animals,
    sports; reference: generate_mask.py:70-121) in a frame (a path, or its
    [H, W, 3] uint8 pixels) from a Mask-RCNN `model` (a torchvision
    detection model in eval mode), or None without one. The repository
    carries no Mask-RCNN weights and the card's machine has no torchvision,
    so the command line passes none and its masks come from the epipolar
    error alone, as the JAX package's do without torchvision."""
    if model is None:
        return None
    if isinstance(img, str):
        img = read_image_rgb(img, "cpu")
    H, W = img.shape[:2]
    int_h, int_w = (576, 1024) if W > H else (1024, 576)
    img = pil_resize(img, (int_w, int_h), "lanczos")
    tensor = torch.from_numpy(img).permute(2, 0, 1).float() / 255.0
    with torch.no_grad():
        pred = model([tensor])[0]
    movable = torch.zeros(int_h, int_w)

    def movable_label(label):
        return label == 1 or 2 <= label <= 9 or 16 <= label <= 43

    for i in range(pred["masks"].shape[0]):
        if float(pred["scores"][i]) > 0.5 and movable_label(int(pred["labels"][i])):
            movable[pred["masks"][i, 0] > 0.5] = 1.0
    return movable.numpy()


def generate_motion_masks(datadir: str, zfill: int = 5, out_dir: str = "epipolar_error_png",
                          device="cuda", model=None) -> dict:
    """Read flow/%0Nd_{fwd,bwd}.npz, write <out_dir>/%0Nd.png for every frame
    (reference: generate_mask.py:150-302), on the card unless `device` is
    the CPU; refuses without a card. The LMedS samples of all frames come
    from one CPU generator seeded with LMEDS_SEED. With a Mask-RCNN `model`
    the frames decode as one batch on the device (without one only their
    size is read, from the first frame's header). Returns the seconds per
    frame, the masks' mean shares and, per error map, whether LMedS
    accepted an F."""
    dev = check_device(device)
    images = sorted(glob.glob(os.path.join(datadir, "images", "*")))
    W, H = image_size(images[0])
    frames = read_frames(images, dev) if model is not None else None
    os.makedirs(os.path.join(datadir, out_dir), exist_ok=True)
    gen = torch.Generator().manual_seed(LMEDS_SEED)
    frame_s, shares, f_found = [], [], []
    for idx in range(len(images)):
        t0 = time.perf_counter()
        err_maps = []
        for kind, ok in (("bwd", idx - 1 >= 0), ("fwd", idx + 1 < len(images))):
            if ok:
                data = np.load(os.path.join(datadir, "flow", f"{idx:0{zfill}d}_{kind}.npz"))
                flow = torch.from_numpy(np.asarray(data["flow"], np.float32)).to(dev)
                err, found = epipolar_fit(flow, H, W, gen)
                err_maps.append(err)
                f_found.append(found)
        semantic = (run_semantic_segmentation(frames[idx].cpu().numpy(), model)
                    if frames is not None else None)
        if semantic is None and idx == 0:
            print("motion masks: no Mask-RCNN model (no weights in the repository); the "
                  "masks come from the epipolar error alone")
        elif semantic is not None:
            semantic = torch.from_numpy(resize_nearest(semantic, (W, H))).to(dev)
        mask = motion_mask_for_frame(err_maps, H, W, semantic).cpu().numpy()
        write_png(os.path.join(datadir, out_dir, f"{idx:0{zfill}d}.png"),
                  (mask * 255).astype(np.uint8))
        frame_s.append(time.perf_counter() - t0)
        shares.append(float(mask.mean()))
    return {"frame_s": frame_s, "mask_share": shares, "f_found": f_found}
