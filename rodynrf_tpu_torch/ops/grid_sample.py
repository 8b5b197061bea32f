"""Axis layout shared by all VM fields and the align_corners resize of the
coarse-to-fine upsample (the parts of rodynrf_tpu/ops/grid_sample.py the
port needs; reference tensorBase.py:326-327, tensoRF.py:198-232)."""

from __future__ import annotations

import torch

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def _strided_len(n: int, stride: int) -> int:
    """Texel count of the stride-s virtual grid plane[..., ::s]."""
    return (n + stride - 1) // stride


def _interp_matrix(n_out: int, n_in: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[n_out, n_in] matrix performing 1D align_corners linear interpolation."""
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    m = torch.zeros((n_out, n_in), dtype=dtype, device=device)
    if n_out == 1:
        m[0, 0] = 1.0
        return m
    pos = torch.arange(n_out, dtype=dtype, device=device) * (n_in - 1) / (n_out - 1)
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_in - 2)
    w = pos - i0.to(dtype)
    rows = torch.arange(n_out, device=device)
    m.index_put_((rows, i0), 1.0 - w, accumulate=True)
    m.index_put_((rows, i0 + 1), w, accumulate=True)
    return m


def resize_bilinear_align_corners(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize [C, H, W] -> [C, H2, W2] with align_corners bilinear, as two
    f32 interpolation-matrix products (TF32 is off in this package)."""
    _, H, W = img.shape
    H2, W2 = out_hw
    Mh = _interp_matrix(H2, H, img.dtype, img.device)
    Mw = _interp_matrix(W2, W, img.dtype, img.device)
    return torch.matmul(torch.matmul(Mh, img), Mw.t())


def resize_line_align_corners(line: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resize [C, L] -> [C, L2] with align_corners linear."""
    Ml = _interp_matrix(out_len, line.shape[1], line.dtype, line.device)
    return torch.matmul(line, Ml.t())
