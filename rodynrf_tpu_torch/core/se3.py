"""6D-rotation camera poses (port of the part of rodynrf_tpu/core/se3.py the
train step calls; reference camera.py:8-15)."""

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
