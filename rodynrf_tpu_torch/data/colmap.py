"""COLMAP sparse-model readers + transforms.json converter (port of
rodynrf_tpu/data/colmap.py, numpy only; reference:
scripts/colmap_utils.py:76-367 binary/text model parsers,
dataLoader/colmap2nerf.py instant-ngp-style converter). Implemented from
the public COLMAP binary format specification.
"""

from __future__ import annotations

import json
import math
import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# camera model id -> (name, #params), per COLMAP's camera_models.h
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ImagePose:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path: str) -> Dict[int, ImagePose]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(n_pts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].view(np.int64)[...]
            images[img_id] = ImagePose(
                img_id, qvec, tvec, cam_id, name.decode(), xys, ids.copy()
            )
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pt_id = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(-1, 2)
            points[pt_id] = Point3D(pt_id, xyz, rgb, err, track[:, 0].copy(), track[:, 1].copy())
    return points


def read_model(sparse_dir: str):
    """Read a COLMAP sparse model directory (binary format)."""
    cameras = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    pts_path = os.path.join(sparse_dir, "points3D.bin")
    points = read_points3d_binary(pts_path) if os.path.exists(pts_path) else {}
    return cameras, images, points


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def colmap_to_transforms(sparse_dir: str, out_path: str | None = None) -> dict:
    """Sparse model -> instant-ngp-style transforms.json
    (equivalent of reference dataLoader/colmap2nerf.py's output stage)."""
    cameras, images, _ = read_model(sparse_dir)
    cam = next(iter(cameras.values()))
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy = cam.params[0], cam.params[1]
        cx, cy = cam.params[2], cam.params[3]

    frames = []
    for img in sorted(images.values(), key=lambda im: im.name):
        R = qvec2rotmat(img.qvec)
        t = img.tvec.reshape(3, 1)
        w2c = np.concatenate([np.concatenate([R, t], 1), [[0, 0, 0, 1]]], 0)
        c2w = np.linalg.inv(w2c)
        # COLMAP camera (x right, y down, z forward) -> NeRF (x right, y up, z back)
        c2w[0:3, 1:3] *= -1
        frames.append({"file_path": f"./images/{img.name}", "transform_matrix": c2w.tolist()})

    out = {
        "camera_angle_x": 2 * math.atan(cam.width / (2 * fx)),
        "camera_angle_y": 2 * math.atan(cam.height / (2 * fy)),
        "fl_x": fx,
        "fl_y": fy,
        "cx": cx,
        "cy": cy,
        "w": cam.width,
        "h": cam.height,
        "frames": frames,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def colmap_to_poses_bounds(sparse_dir: str, out_path: str | None = None) -> np.ndarray:
    """Sparse model -> LLFF poses_bounds.npy [N, 17]: the format the
    Nvidia loader ingests (nvidia.py:256-318). Near/far from per-image
    point-depth percentiles."""
    cameras, images, points = read_model(sparse_dir)
    cam = next(iter(cameras.values()))
    if cam.model == "SIMPLE_PINHOLE":
        f = cam.params[0]
    else:
        f = cam.params[0]

    rows = []
    for img in sorted(images.values(), key=lambda im: im.name):
        R = qvec2rotmat(img.qvec)
        t = img.tvec
        # world->cam to cam->world
        c2w_R = R.T
        c2w_t = -R.T @ t
        # LLFF convention: "down right back" columns
        m = np.concatenate([c2w_R, c2w_t[:, None]], 1)  # x right, y down, z fwd (opencv)
        m = np.concatenate([m[:, 1:2], m[:, 0:1], -m[:, 2:3], m[:, 3:4]], 1)
        hwf = np.array([cam.height, cam.width, f])[:, None]
        # depths of visible points
        depths = []
        for pid in img.point3D_ids:
            if pid != -1 and pid in points:
                depths.append((R @ points[pid].xyz + t)[2])
        if depths:
            near, far = np.percentile(depths, 0.5), np.percentile(depths, 99.5)
        else:
            near, far = 0.1, 100.0
        rows.append(np.concatenate([np.concatenate([m, hwf], 1).ravel(), [near, far]]))
    out = np.stack(rows)
    if out_path:
        np.save(out_path, out)
    return out
