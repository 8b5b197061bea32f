"""Bilinear plane/line and trilinear volume sampling, the axis layout shared
by all VM fields, and the align_corners resize of the coarse-to-fine
upsample (port of rodynrf_tpu/ops/grid_sample.py; reference
tensorBase.py:326-327, tensoRF.py:140-232, tensorBase.py:56-73).

The samplers match PyTorch `grid_sample(..., align_corners=True,
padding_mode='zeros')`: a coordinate u in [-1, 1] maps to texel index
(u + 1) / 2 * (N - 1); out-of-range corners contribute zero. They are the
unfused samplers of the occupancy-mask build (fields/alpha_mask.py); the
train step and renderer sample through the fused tables (ops/fused_vm.py).
"""

from __future__ import annotations

import torch

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def _strided_len(n: int, stride: int) -> int:
    """Texel count of the stride-s virtual grid plane[..., ::s]."""
    return (n + stride - 1) // stride


def _lerp_weights_1d(u: torch.Tensor, n_virtual: int):
    """align_corners index math for one axis: (i0, i1 clipped into range,
    the upper-corner weight, the two corners' in-bounds masks)."""
    g = (u + 1.0) * 0.5 * (n_virtual - 1)
    i0f = torch.floor(g)
    w1 = g - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    inb0 = (i0 >= 0) & (i0 <= n_virtual - 1)
    inb1 = (i1 >= 0) & (i1 <= n_virtual - 1)
    return (torch.clamp(i0, 0, n_virtual - 1), torch.clamp(i1, 0, n_virtual - 1), w1,
            inb0, inb1)


def sample_plane(plane: torch.Tensor, xy: torch.Tensor, stride: int = 1,
                 gather_dtype=None) -> torch.Tensor:
    """Sample a [C, H, W] plane at xy [N, 2] = (x, y) in [-1, 1] -> [N, C]
    f32 (x indexes W, y indexes H). `stride` samples the virtual grid
    plane[:, ::stride, ::stride]; `gather_dtype` casts the texture before
    the gather, interpolation stays f32."""
    C, H, W = plane.shape
    Hs, Ws = _strided_len(H, stride), _strided_len(W, stride)
    x0, x1, wx, ibx0, ibx1 = _lerp_weights_1d(xy[:, 0], Ws)
    y0, y1, wy, iby0, iby1 = _lerp_weights_1d(xy[:, 1], Hs)
    if gather_dtype is not None:
        plane = plane.to(gather_dtype)
    flat = plane.reshape(C, H * W).t()  # [H*W, C] channel-last gather

    def corner(yi, xi, ib):
        vals = flat.index_select(0, yi * stride * W + xi * stride).to(xy.dtype)
        return vals * ib[:, None].to(xy.dtype)

    return (corner(y0, x0, iby0 & ibx0) * ((1 - wy) * (1 - wx))[:, None]
            + corner(y0, x1, iby0 & ibx1) * ((1 - wy) * wx)[:, None]
            + corner(y1, x0, iby1 & ibx0) * (wy * (1 - wx))[:, None]
            + corner(y1, x1, iby1 & ibx1) * (wy * wx)[:, None])


def sample_line(line: torch.Tensor, z: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Sample a [C, L] line at z [N] in [-1, 1] -> [N, C] (the reference's
    grid_sample over a [1, C, L, 1] texture, tensoRF.py:145-149)."""
    C, L = line.shape
    z0, z1, wz, ib0, ib1 = _lerp_weights_1d(z, _strided_len(L, stride))
    flat = line.t()
    v0 = flat.index_select(0, z0 * stride) * ib0[:, None].to(z.dtype)
    v1 = flat.index_select(0, z1 * stride) * ib1[:, None].to(z.dtype)
    return v0 * (1 - wz[:, None]) + v1 * wz[:, None]


def sample_vm(planes, lines, xyz: torch.Tensor, strides=(1,), gather_dtype=None) -> torch.Tensor:
    """VM (plane ⊙ line) features at xyz [N, 3] in [-1, 1] -> [N, Σ C_i ·
    len(strides)], channels stride-major then axis-major (the reference's
    cat order, tensoRF.py:670-721)."""
    feats = []
    for s in strides:
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = sample_plane(planes[i], xyz[:, (m0, m1)], stride=s, gather_dtype=gather_dtype)
            feats.append(p * sample_line(lines[i], xyz[:, VEC_MODE[i]], stride=s))
    return torch.cat(feats, dim=-1)


def sample_vm_sum(planes, lines, xyz: torch.Tensor, gather_dtype=None) -> torch.Tensor:
    """Σ_axes Σ_channels plane ⊙ line, the static density (reference:
    tensoRF.py:118-154). Returns [N]."""
    total = torch.zeros(xyz.shape[0], dtype=xyz.dtype, device=xyz.device)
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        p = sample_plane(planes[i], xyz[:, (m0, m1)], gather_dtype=gather_dtype)
        total = total + torch.sum(p * sample_line(lines[i], xyz[:, VEC_MODE[i]]), dim=-1)
    return total


def vm_axis_sum(plane, line, xy, z, strides=(1,)) -> torch.Tensor:
    """Σ_strides Σ_c bilerp(plane) ⊙ lerp(line) for one VM axis -> [N]."""
    total = 0.0
    for s in strides:
        total = total + torch.sum(sample_plane(plane, xy, stride=s) * sample_line(line, z, stride=s),
                                  dim=-1)
    return total


def sample_vm_sum_fused(planes, lines, xyz: torch.Tensor, strides=(1,)) -> torch.Tensor:
    """Multiscale Σ-product over all 3 VM axes -> [N]."""
    total = torch.zeros(xyz.shape[0], dtype=xyz.dtype, device=xyz.device)
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        total = total + vm_axis_sum(planes[i], lines[i], xyz[:, (m0, m1)], xyz[:, VEC_MODE[i]],
                                    strides)
    return total


def sample_grid3d(vol: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a [D, H, W, C] volume at xyz [N, 3] = (x, y, z) in
    [-1, 1] -> [N, C] in xyz's dtype; x indexes W, y H, z D, align_corners,
    per-corner zero padding (reference: tensorBase.py:56-64)."""
    D, H, W, C = vol.shape
    x0, x1, wx, ibx0, ibx1 = _lerp_weights_1d(xyz[:, 0], W)
    y0, y1, wy, iby0, iby1 = _lerp_weights_1d(xyz[:, 1], H)
    z0, z1, wz, ibz0, ibz1 = _lerp_weights_1d(xyz[:, 2], D)
    flat = vol.reshape(D * H * W, C)

    def corner(zi, yi, xi, ib, w):
        vals = flat.index_select(0, (zi * H + yi) * W + xi).to(xyz.dtype)
        return vals * (ib.to(xyz.dtype) * w)[:, None]

    return (corner(z0, y0, x0, ibz0 & iby0 & ibx0, (1 - wz) * (1 - wy) * (1 - wx))
            + corner(z0, y0, x1, ibz0 & iby0 & ibx1, (1 - wz) * (1 - wy) * wx)
            + corner(z0, y1, x0, ibz0 & iby1 & ibx0, (1 - wz) * wy * (1 - wx))
            + corner(z0, y1, x1, ibz0 & iby1 & ibx1, (1 - wz) * wy * wx)
            + corner(z1, y0, x0, ibz1 & iby0 & ibx0, wz * (1 - wy) * (1 - wx))
            + corner(z1, y0, x1, ibz1 & iby0 & ibx1, wz * (1 - wy) * wx)
            + corner(z1, y1, x0, ibz1 & iby1 & ibx0, wz * wy * (1 - wx))
            + corner(z1, y1, x1, ibz1 & iby1 & ibx1, wz * wy * wx))


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
