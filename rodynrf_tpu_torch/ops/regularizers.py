"""Grid regularizers: total variation, density L1, line orthogonality (port of
rodynrf_tpu/ops/regularizers.py; reference utils.py:157-181,
tensoRF.py:63-98).

Line TV uses only the length axis: the reference's 2-D TVLoss on [1, C, L, 1]
lines divides 0/0 on the width axis (the JAX package's fix, kept).
"""

from __future__ import annotations

import torch


def tv_loss_plane(plane: torch.Tensor) -> torch.Tensor:
    """TV over a [C, H, W] plane: 2*(h_tv/count_h + w_tv/count_w)."""
    C, H, W = plane.shape
    h_tv = torch.sum((plane[:, 1:, :] - plane[:, :-1, :]) ** 2)
    w_tv = torch.sum((plane[:, :, 1:] - plane[:, :, :-1]) ** 2)
    return 2.0 * (h_tv / (C * (H - 1) * W) + w_tv / (C * H * (W - 1)))


def tv_loss_line(line: torch.Tensor) -> torch.Tensor:
    """TV over a [C, L] line along its length axis."""
    C, L = line.shape
    h_tv = torch.sum((line[:, 1:] - line[:, :-1]) ** 2)
    return 2.0 * h_tv / (C * (L - 1))


def tv_loss_vm(planes, lines, plane_w: float = 1e-2, line_w: float = 1e-3) -> torch.Tensor:
    """Σ_axes plane_w*TV(plane) + line_w*TV(line) (reference: tensoRF.py:100-116)."""
    total = 0.0
    for p, l in zip(planes, lines):
        total = total + plane_w * tv_loss_plane(p) + line_w * tv_loss_line(l)
    return total


def vm_outer_l1(planes, lines, feature2density) -> torch.Tensor:
    """mean |feature2density(Σ_axes plane ⊗ line)| over the dense volume
    (reference: tensoRF.py:80-98 density_L1)."""
    A = torch.einsum("cyx,cz->xyz", planes[0], lines[0])
    B = torch.einsum("czx,cy->xyz", planes[1], lines[1])
    Cc = torch.einsum("czy,cx->xyz", planes[2], lines[2])
    return torch.mean(torch.abs(feature2density(A + B + Cc)))


def line_orthogonality(lines) -> torch.Tensor:
    """Mean |off-diagonal Gram| of each line basis (reference: tensoRF.py:63-75)."""
    total = 0.0
    for line in lines:
        n_comp = line.shape[0]
        gram = line @ line.t()
        off = gram - torch.diag(torch.diag(gram))
        total = total + torch.sum(torch.abs(off)) / (n_comp * (n_comp - 1))
    return total
