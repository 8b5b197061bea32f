"""Camera pose math (port of rodynrf_tpu/core/se3.py): 6D-rotation poses
(reference camera.py:8-15), [R|t] algebra (18-70), the Lie exp/log maps
(73-164) and quaternions (167-266), world/camera/image transforms
(274-297), the Procrustes camera alignment of the CLI's pose diagnostics
(366-394) and the novel-view helpers (300-363, 397-407). Poses are
[..., 3, 4] matrices [R | t] mapping world -> camera. Matmuls are full
float32 on the card (the package turns TF32 off)."""

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


def mtx_to_pose(mtx: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pose_to_mtx` (columns 0, 1 and t)."""
    return torch.cat([mtx[..., :, 0], mtx[..., :, 1], mtx[..., :, 3]], dim=-1)


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


def pose_compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b ∘ pose_a(x)."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return make_pose(R_b @ R_a, (R_b @ t_a + t_b)[..., 0])


def pose_compose(pose_list) -> torch.Tensor:
    out = pose_list[0]
    for p in pose_list[1:]:
        out = pose_compose_pair(out, p)
    return out


# ---------------------------------------------------------------------------
# Lie algebra: the closed-form exp/log maps with Taylor branches near 0 (the
# reference uses 10-term Taylor series)
# ---------------------------------------------------------------------------

def skew(w: torch.Tensor) -> torch.Tensor:
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([zeros, -w2, w1], dim=-1),
            torch.stack([w2, zeros, -w0], dim=-1),
            torch.stack([-w1, w0, zeros], dim=-1),
        ],
        dim=-2,
    )


def _sinc_A(theta):
    """sin(x)/x, Taylor-safe at 0."""
    small = theta * theta < 1e-8
    return torch.where(small, 1.0 - theta ** 2 / 6.0,
                       torch.sin(theta) / torch.where(small, 1.0, theta))


def _sinc_B(theta):
    """(1-cos(x))/x^2, Taylor-safe at 0."""
    small = theta * theta < 1e-8
    t2 = torch.where(small, 1.0, theta * theta)
    return torch.where(small, 0.5 - theta ** 2 / 24.0, (1.0 - torch.cos(theta)) / t2)


def _sinc_C(theta):
    """(x-sin(x))/x^3, Taylor-safe at 0."""
    small = theta * theta < 1e-8
    t3 = torch.where(small, 1.0, theta ** 3)
    return torch.where(small, 1.0 / 6.0 - theta ** 2 / 120.0, (theta - torch.sin(theta)) / t3)


def _eye(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    return _eye(w) + _sinc_A(theta) * wx + _sinc_B(theta) * (wx @ wx)


def SO3_to_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))[..., None, None]
    lnR = 1 / (2 * _sinc_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    R = _eye(w) + _sinc_A(theta) * wx + _sinc_B(theta) * (wx @ wx)
    V = _eye(w) + _sinc_B(theta) * wx + _sinc_C(theta) * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    A, B = _sinc_A(theta), _sinc_B(theta)
    invV = _eye(w) - 0.5 * wx + (1 - A / (2 * B)) / (theta ** 2 + eps) * (wx @ wx)
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (a, b, c, d) = a + bi + cj + dk
# ---------------------------------------------------------------------------

def q_to_R(q: torch.Tensor) -> torch.Tensor:
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                         2 * (qa * qc + qb * qd)], -1),
            torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                         2 * (qc * qd - qa * qb)], -1),
            torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                         1 - 2 * (qb ** 2 + qc ** 2)], -1),
        ],
        dim=-2,
    )


def R_to_q(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The sign of each vector part is sign(R_ji − R_ij), 0 where they are
    equal (as the JAX package's)."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t = R00 + R11 + R22
    qa = 0.5 * torch.sqrt(1 + t + eps)
    qb = torch.sign(R21 - R12) * 0.5 * torch.sqrt(torch.clamp(1 + R00 - R11 - R22, min=0) + eps)
    qc = torch.sign(R02 - R20) * 0.5 * torch.sqrt(torch.clamp(1 - R00 + R11 - R22, min=0) + eps)
    qd = torch.sign(R10 - R01) * 0.5 * torch.sqrt(torch.clamp(1 - R00 - R11 + R22, min=0) + eps)
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_invert(q: torch.Tensor) -> torch.Tensor:
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device) / norm2


def q_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# World/camera/image transforms
# ---------------------------------------------------------------------------

def to_hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return to_hom(X) @ pose_invert(pose).transpose(-1, -2)


def cam2img(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    return X @ intr.transpose(-1, -2)


def img2cam(X: torch.Tensor, cam_intr: torch.Tensor) -> torch.Tensor:
    """(reference: camera.py:290-291)."""
    return X @ torch.linalg.inv(cam_intr).transpose(-1, -2)


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


# ---------------------------------------------------------------------------
# Novel views and per-pixel rays (reference: camera.py:300-363, 397-407)
# ---------------------------------------------------------------------------

def angle_to_rotation_matrix(a: torch.Tensor, axis: str) -> torch.Tensor:
    """Euler rotation about a named axis (reference: camera.py:300-314)."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack(
        [
            torch.stack([torch.cos(a), -torch.sin(a), zeros], dim=-1),
            torch.stack([torch.sin(a), torch.cos(a), zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def get_novel_view_poses(pose_anchor: torch.Tensor, N: int = 60, scale: float = 1.0):
    """Circular oscillation novel-view path around `pose_anchor` [3, 4] ->
    [N, 3, 4] (reference: camera.py:397-407)."""
    theta = torch.arange(N, device=pose_anchor.device) / N * 4 * torch.pi
    R_x = angle_to_rotation_matrix(torch.arcsin(-torch.sin(theta) * 0.05 / 3), "X")
    R_y = angle_to_rotation_matrix(torch.arcsin(-torch.cos(theta) * 0.05), "Y")
    pose_rot = make_pose(R=R_y @ R_x)
    pose_shift = make_pose(t=torch.tensor([0.0, 0.0, 4.0 * scale], device=pose_anchor.device))
    pose_shift2 = make_pose(t=torch.tensor([0.0, 0.0, -4.0 * scale], device=pose_anchor.device))
    pose_oscil = pose_compose([pose_shift, pose_rot, pose_shift2])
    return pose_compose([pose_oscil, pose_anchor[None]])


def get_center_and_ray(H: int, W: int, pose: torch.Tensor, intr: torch.Tensor):
    """Camera centers and per-pixel rays in world space for a batch of poses
    (reference: camera.py:317-335): pose [B, 3, 4], intr [B, 3, 3] ->
    (center [B, H·W, 3], ray [B, H·W, 3])."""
    y = torch.arange(H, dtype=torch.float32, device=pose.device) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=pose.device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    xy = torch.stack([X, Y], -1).reshape(-1, 2)
    xy = xy[None].expand(pose.shape[0], *xy.shape)
    grid_3d = img2cam(to_hom(xy), intr)
    center_3d = cam2world(torch.zeros_like(grid_3d), pose)
    return center_3d, cam2world(grid_3d, pose) - center_3d


def get_3d_points_from_depth(center, ray, depth, multi_samples: bool = False):
    """x = c + d·v (reference: camera.py:338-343)."""
    if multi_samples:
        center, ray = center[:, :, None], ray[:, :, None]
    return center + ray * depth


def convert_ndc(center, ray, intr, near: float = 1.0):
    """Shift ray origins to the near plane and project to NDC, the +z-facing
    variant (reference: camera.py:346-363)."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = intr[:, 0, 0] / intr[:, 0, 2]
    scale_y = intr[:, 1, 1] / intr[:, 1, 2]
    cnx = scale_x[:, None] * (cx / cz)
    cny = scale_y[:, None] * (cy / cz)
    cnz = 1.0 - 2.0 * near / cz
    rnx = scale_x[:, None] * (rx / rz - cx / cz)
    rny = scale_y[:, None] * (ry / rz - cy / cz)
    rnz = 2.0 * near / cz
    return torch.stack([cnx, cny, cnz], -1), torch.stack([rnx, rny, rnz], -1)
