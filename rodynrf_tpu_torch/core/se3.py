"""Camera pose math (port of the parts of rodynrf_tpu/core/se3.py that the
train step and the CLI call): 6D-rotation poses (reference camera.py:8-15),
[R|t] algebra and the Procrustes camera alignment of the CLI's pose
diagnostics (camera.py:18-70, 274-297, 366-394)."""

from __future__ import annotations

import torch


def pose_to_mtx(pose9: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt 2-vector (6D) rotation + translation -> ``[..., 3, 4]``.

    ``pose9[..., 0:3]`` and ``[..., 3:6]`` span the rotation; ``[..., 6:9]``
    is the translation column. Columns of the output are (b1, b2, b3, t).
    """
    b1 = pose9[..., 0:3]
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = pose9[..., 3:6] - torch.sum(b1 * pose9[..., 3:6], dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3, pose9[..., 6:9]], dim=-1)


# ---------------------------------------------------------------------------
# [R|t] pose algebra and the camera-alignment diagnostics of the CLI
# (reference: camera.py:18-70, 274-297, 366-394; train.py:740-756)
# ---------------------------------------------------------------------------

def make_pose(R=None, t=None) -> torch.Tensor:
    if R is None:
        t = torch.as_tensor(t, dtype=torch.float32)
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(*t.shape[:-1], 3, 3)
    elif t is None:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    R = torch.as_tensor(R, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32)
    return torch.cat([R, t[..., None]], dim=-1)


def pose_invert(pose: torch.Tensor) -> torch.Tensor:
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return make_pose(R_inv, (-R_inv @ t)[..., 0])


def to_hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return to_hom(X) @ pose_invert(pose).transpose(-1, -2)


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def procrustes_analysis(X0: torch.Tensor, X1: torch.Tensor) -> dict:
    """Similarity (sim3) alignment of point sets ``X1`` to ``X0`` ([N, 3]).
    Returns {t0, t1, s0, s1, R} (reference: camera.py:376-394); the SVD runs
    in float64."""
    t0 = X0.mean(dim=0, keepdim=True)
    t1 = X1.mean(dim=0, keepdim=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c ** 2).sum(dim=-1).mean())
    M = (X0c / s0).T @ (X1c / s1)
    U, _, Vt = torch.linalg.svd(M.double(), full_matrices=False)
    R = (U @ Vt).to(X0.dtype)
    # reflection fix: flip the last row of R if det < 0
    if torch.linalg.det(R) < 0:
        R = torch.cat([R[:2], -R[2:]], 0)
    return {"t0": t0[0], "t1": t1[0], "s0": s0, "s1": s1, "R": R}


def prealign_cameras(pose_in: torch.Tensor, pose_GT: torch.Tensor):
    """Procrustes-align predicted camera centers to GT (reference:
    train.py:740-756). Returns (aligned poses [N, 3, 4], sim3)."""
    center = torch.zeros((1, 1, 3), dtype=pose_in.dtype, device=pose_in.device)
    center_pred = cam2world(center, pose_in)[:, 0]
    center_GT = cam2world(center, pose_GT)[:, 0]
    sim3 = procrustes_analysis(center_GT, center_pred)
    center_aligned = ((center_pred - sim3["t1"]) / sim3["s1"] @ sim3["R"].T * sim3["s0"]
                      + sim3["t0"])
    R_aligned = pose_in[..., :3] @ sim3["R"].T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return make_pose(R_aligned, t_aligned), sim3


def evaluate_camera_alignment(pose_aligned: torch.Tensor, pose_GT: torch.Tensor):
    """(rotation error [N] in radians, translation error [N])."""
    R_aligned, t_aligned = pose_aligned[..., :3], pose_aligned[..., 3:]
    R_GT, t_GT = pose_GT[..., :3], pose_GT[..., 3:]
    R_error = rotation_distance(R_aligned, R_GT)
    t_error = torch.linalg.norm((t_aligned - t_GT)[..., 0], dim=-1)
    return R_error, t_error
