"""Monocular-video dataset loaders: Nvidia dynamic scenes and DAVIS (port of
rodynrf_tpu/data/video_dataset.py; reference dataLoader/nvidia.py:210-488,
dataLoader/davis.py:210-486 — the two differ only in sidecar file naming:
disp dir `disp/%03d.npy` vs `dpt/%05d.npy` and 3- vs 5-digit flow names).
Loads:

  images/*                       RGB frames
  <mask_dir>/*.png               motion masks (motion_masks | epipolar_error_png)
  flow/%0Nd_{fwd,bwd}.npz        RAFT flow + fwd/bwd-consistency masks
  <disp_dir>/%0Nd.npy            DPT monocular disparity
  poses_bounds.npy               optional GT poses (LLFF layout)

into a :class:`SceneData` of host numpy arrays. The frames and masks of a
scene are decoded as one batch on the loader's device (PNG on the host,
JPEG by data/jpeg.py's kernels on the card or their plain versions on the
CPU) and resized on the host by data/imageio.py (PIL's LANCZOS for frames,
BILINEAR for masks; cv2's INTER_LINEAR for disparity and flow, INTER_NEAREST
for flow masks), so no image library is needed.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .imageio import image_size, pil_resize, read_frames, resize_linear, resize_nearest
from ..device import check_device
from .llff import center_poses, resize_flow
from .scene import SceneData, default_bbox


def _resized(img, wh, filt: str) -> np.ndarray:
    """A decoded frame (a uint8 tensor) on the host at wh, through PIL's
    filter when its size differs, in [0, 1]."""
    img = img.cpu().numpy()
    if img.shape[1::-1] != tuple(wh):
        img = pil_resize(img, wh, filt)
    return img.astype(np.float32) / 255.0


def load_video_scene(
    datadir: str,
    *,
    downsample: float = 2.0,
    use_disp: bool = True,
    use_foreground_mask: str = "motion_masks",
    with_gt_poses: bool = False,
    ray_type: str = "ndc",
    disp_dir: str = "disp",
    zfill: int = 3,
    device="cuda",
) -> SceneData:
    """Load an Nvidia-layout scene. For DAVIS pass disp_dir='dpt', zfill=5.
    The frames decode on `device`: the card unless the caller asks for the
    CPU (RuntimeError without a card)."""
    device = check_device(device)
    image_paths = sorted(glob.glob(os.path.join(datadir, "images/*")))
    if not image_paths:
        raise FileNotFoundError(f"no images under {datadir}/images")
    mask_paths = sorted(glob.glob(os.path.join(datadir, use_foreground_mask, "*.png")))

    W0, H0 = image_size(image_paths[0])
    W, H = int(W0 / downsample), int(H0 / downsample)
    wh = (W, H)
    T = len(image_paths)

    focal = (max(H0, W0) / 2 * np.sqrt(3.0)) / downsample  # (nvidia.py:279-282)
    poses = None

    if with_gt_poses:
        poses_bounds = np.load(os.path.join(datadir, "poses_bounds.npy"))
        pb = poses_bounds[:, :15].reshape(-1, 3, 5)
        near_fars = poses_bounds[:, -2:]
        # original intrinsics, rescaled to training resolution (nvidia.py:289-298)
        H_orig, W_orig, focal_orig = pb[0, :, -1]
        W, H = int(W_orig / downsample), int(H_orig / downsample)
        wh = (W, H)
        focal = focal_orig * W / W_orig
        # "down right back" -> "right up back" (nvidia.py:303-305)
        p = np.concatenate([pb[..., 1:2], -pb[..., :1], pb[..., 2:4]], -1)
        p, _ = center_poses(p, np.eye(4))
        near_original = near_fars.min()
        if ray_type == "ndc":
            scale_factor = near_original * 0.75
            near_fars = near_fars / scale_factor
        else:
            scale_factor = np.abs(p[..., 3]).max() * 2.0
        p[..., 3] /= scale_factor
        # final axis flip (nvidia.py:339-341)
        p = p.copy()
        p[:, 0] = -p[:, 0]
        poses = p.astype(np.float32)

    rgbs = np.zeros((T, H, W, 3), np.float32)
    fg = np.zeros((T, H, W), np.float32)
    flows_f = np.zeros((T, H, W, 2), np.float32)
    masks_f = np.zeros((T, H, W), np.float32)
    flows_b = np.zeros((T, H, W, 2), np.float32)
    masks_b = np.zeros((T, H, W), np.float32)
    disps = np.zeros((T, H, W), np.float32)

    frames = read_frames(image_paths, device)
    masks = read_frames(mask_paths[:T], device)
    for idx in range(T):
        rgbs[idx] = _resized(frames[idx], wh, "lanczos")
        if idx < len(masks):
            # PIL resizes each channel alone, and the loader keeps the first
            fg[idx] = _resized(masks[idx][..., :1], wh, "bilinear")[..., 0]

        if use_disp:
            disp_path = os.path.join(datadir, disp_dir, str(idx).zfill(zfill) + ".npy")
            disps[idx] = resize_linear(np.load(disp_path), wh)

        if idx < T - 1:  # forward flow (last frame has none, nvidia.py:389-392)
            data = np.load(os.path.join(datadir, "flow", str(idx).zfill(zfill) + "_fwd.npz"))
            flows_f[idx] = resize_flow(data["flow"], H, W)
            masks_f[idx] = resize_nearest(np.float32(data["mask"]), wh)
        if idx > 0:  # backward flow
            data = np.load(os.path.join(datadir, "flow", str(idx).zfill(zfill) + "_bwd.npz"))
            flows_b[idx] = resize_flow(data["flow"], H, W)
            masks_b[idx] = resize_nearest(np.float32(data["mask"]), wh)

    ts = (np.arange(T, dtype=np.float32) / (T - 1) * 2.0 - 1.0 if T > 1
          else np.zeros(1, np.float32))
    ts_full = np.repeat(ts, H * W)

    near_far = (0.0, 256.0) if ray_type == "contract" else (0.0, 1.0)  # (nvidia.py:246-251)

    return SceneData(
        rgbs=rgbs.reshape(-1, 3),
        ts=ts_full,
        flows_f=flows_f.reshape(-1, 2),
        flow_masks_f=masks_f.reshape(-1),
        flows_b=flows_b.reshape(-1, 2),
        flow_masks_b=masks_b.reshape(-1),
        disps=disps.reshape(-1),
        fg_masks=fg.reshape(-1),
        img_wh=wh,
        n_frames=T,
        scene_bbox=default_bbox(ray_type),
        near_far=near_far,
        focal=float(focal),
        poses=poses,
        white_bg=False,
        rgbs_stack=rgbs,
    )


def load_nvidia_scene(datadir, **kw) -> SceneData:
    return load_video_scene(datadir, disp_dir="disp", zfill=3, **kw)


def load_davis_scene(datadir, **kw) -> SceneData:
    return load_video_scene(datadir, disp_dir="dpt", zfill=5, **kw)


DATASET_LOADERS = {
    "nvidia": load_nvidia_scene,
    "davis": load_davis_scene,
}


def load_scene(args, device="cuda") -> SceneData:
    """Dataset dispatch mirroring the reference registry
    (reference: dataLoader/__init__.py:3-6); the frames decode on `device`."""
    if args.dataset_name == "synthetic":
        from .synthetic import make_synthetic_scene

        return make_synthetic_scene(T=args.N_voxel_t, ray_type=args.ray_type)
    loader = DATASET_LOADERS[args.dataset_name]
    return loader(
        args.datadir,
        downsample=args.downsample_train,
        use_disp=bool(args.use_disp),
        use_foreground_mask=args.use_foreground_mask,
        with_gt_poses=bool(args.with_GT_poses),
        ray_type=args.ray_type,
        device=device,
    )
