"""Alpha-grid occupancy mask with a time axis (port of
rodynrf_tpu/fields/alpha_mask.py; reference models/tensorBase.py:42-78
sample_alpha, 564-589 getDenseAlpha, 591-629 updateAlphaMask).

The volume is stored dense [D, H, W, T] as uint8 {0, 1}. Two tests read it:
- `AlphaGridMask.sample_alpha`, the reference's trilinear sample of space
  plus the nearest time slice, on the mask as built (the eval renderer's
  dense early-out);
- `occupancy_nearest`, one gathered byte per sample on the volume
  pre-dilated by `dilate_occupancy` (the train step's and the compact
  renderer's selector), which keeps a superset of the trilinear test's
  samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.grid_sample import sample_grid3d, sample_vm_sum
from .dynamic import density_feature, normalize_coord, warp_coordinate
from .static import feature2density


class AlphaGridMask(NamedTuple):
    aabb: torch.Tensor  # [2, 3] f32
    alpha_volume: torch.Tensor  # [D, H, W, T] uint8 {0, 1}

    @property
    def t_size(self) -> int:
        return self.alpha_volume.shape[-1]

    def to(self, device) -> "AlphaGridMask":
        return AlphaGridMask(self.aabb.to(device), self.alpha_volume.to(device))

    def sample_alpha(self, xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """xyz [N, 3] world coords, t [N] in [-1, 1] -> alpha [N]: trilinear in
        space, nearest time slice (reference: tensorBase.py:56-73)."""
        vals = sample_grid3d(self.alpha_volume, normalize_coord(xyz, self.aabb))  # [N, T]
        t_int = torch.round((t + 1.0) / 2.0 * (self.t_size - 1)).long()
        return torch.gather(vals, 1, t_int.clamp(0, self.t_size - 1)[:, None])[:, 0]


def max_pool3d_same(vol: torch.Tensor, k: int = 3) -> torch.Tensor:
    """3D max pool, stride 1, same padding, over the spatial axes of a
    floating [D, H, W, T] volume (reference: tensorBase.py:599-600
    F.max_pool3d(ks=3, pad=1, stride=1)); T rides as channels."""
    pooled = torch.nn.functional.max_pool3d(vol.permute(3, 0, 1, 2), k, stride=1,
                                            padding=k // 2)
    return pooled.permute(1, 2, 3, 0)


def dilate_occupancy(alpha_volume: torch.Tensor) -> torch.Tensor:
    """One extra spatial 3³ max-pool over a {0, 1} [D, H, W, T] volume.

    Trilinear > 0 at x means some corner c of x's cell is occupied; the
    nearest voxel n is a corner of that cell too, so |n - c| <= 1 per axis
    and the dilated volume has vol_d[n] >= vol[c] = 1: the nearest-voxel
    test on the dilated volume keeps a superset of the trilinear test's
    samples."""
    return (max_pool3d_same(alpha_volume.float(), 3) > 0.5).to(torch.uint8)


def occupancy_nearest(alpha_volume: torch.Tensor, mask_aabb: torch.Tensor, xyz: torch.Tensor,
                      t: torch.Tensor, shape=None) -> torch.Tensor:
    """Nearest-voxel occupancy bit at (xyz, t): one gathered byte per sample.

    alpha_volume: [D, H, W, T] uint8 (pre-dilated), or flat [D·H·W·T] with
    the dims in `shape` (the train step keeps it flat); xyz [N, 3] world;
    t [N] in [-1, 1]. Returns bool [N]. Out-of-aabb samples test
    unoccupied: the support g in (-1, n) is the zero-padded trilinear's, and
    the clipped-round nearest voxel lies within one cell of every corner
    such a sample can touch, which the pre-dilation covers."""
    if alpha_volume.dim() == 1:
        D, H, W, T = shape
        flat_vol = alpha_volume
    else:
        D, H, W, T = alpha_volume.shape
        flat_vol = alpha_volume.reshape(-1)
    xyz_n = normalize_coord(xyz, mask_aabb)

    def near(u, n):
        g = (u + 1.0) * 0.5 * (n - 1)
        return torch.clamp(torch.round(g), 0, n - 1).long(), (g > -1.0) & (g < float(n))

    gx, ibx = near(xyz_n[:, 0], W)
    gy, iby = near(xyz_n[:, 1], H)
    gz, ibz = near(xyz_n[:, 2], D)
    t_int = torch.clamp(torch.round((t + 1.0) / 2.0 * (T - 1)).long(), 0, T - 1)
    idx = ((gz * H + gy) * W + gx) * T + t_int
    return (flat_vol.index_select(0, idx) > 0) & ibx & iby & ibz


def update_alpha_mask(alpha: torch.Tensor, aabb: torch.Tensor, thres: float):
    """Dense alpha [X, Y, Z, T] -> (AlphaGridMask, shrunken aabb) (reference:
    tensorBase.py:591-629). The axes go X,Y,Z -> Z,Y,X (the reference's
    grid_sample layout, alpha.transpose(0, 2)), then max-pool and threshold
    to uint8; the new aabb bounds the union of the per-time occupied
    voxels."""
    gs = alpha.shape[:3]
    vol = max_pool3d_same(torch.clamp(alpha, 0, 1).permute(2, 1, 0, 3), 3)
    vol = (vol >= thres).to(torch.uint8)

    lin = [torch.linspace(float(aabb[0, i]), float(aabb[1, i]), gs[i], dtype=aabb.dtype,
                          device=aabb.device) for i in range(3)]
    grid = torch.stack(torch.meshgrid(*lin, indexing="ij"), -1)  # [X, Y, Z, 3]
    occupied = torch.any(vol.permute(2, 1, 0, 3) > 0, dim=-1)[..., None]  # [X, Y, Z, 1]
    inf = torch.full_like(grid, float("inf"))
    xyz_min = torch.where(occupied, grid, inf).reshape(-1, 3).amin(0)
    xyz_max = torch.where(occupied, grid, -inf).reshape(-1, 3).amax(0)
    return AlphaGridMask(aabb=aabb, alpha_volume=vol), torch.stack([xyz_min, xyz_max])


def pack_alpha(mask: AlphaGridMask):
    """Bit-packed serialization (reference: tensorBase.py:465-469)."""
    vol = mask.alpha_volume.detach().cpu().numpy() > 0
    return {
        "alphaMask.shape": vol.shape,
        "alphaMask.mask": np.packbits(vol.reshape(-1)),
        "alphaMask.aabb": mask.aabb.detach().cpu().float().numpy(),
    }


def unpack_alpha(d) -> AlphaGridMask:
    """The inverse of pack_alpha, on the CPU (uint8 {0, 1} volume)."""
    shape = tuple(int(s) for s in d["alphaMask.shape"])
    length = int(np.prod(shape))
    vol = np.unpackbits(np.asarray(d["alphaMask.mask"]))[:length].reshape(shape)
    return AlphaGridMask(aabb=torch.as_tensor(np.asarray(d["alphaMask.aabb"], np.float32)),
                         alpha_volume=torch.from_numpy(np.ascontiguousarray(vol)))


def load_alpha_npz(path: str) -> AlphaGridMask:
    """Load a standalone packed-mask .npz (the keys of scripts/export_alpha.py:
    '.' replaced with '_')."""
    with np.load(path, allow_pickle=False) as f:
        return unpack_alpha({
            "alphaMask.shape": f["alphaMask_shape"],
            "alphaMask.mask": f["alphaMask_mask"],
            "alphaMask.aabb": f["alphaMask_aabb"],
        })


def dual_dense_alpha(params, static_cfg, dynamic_cfg, aabb, t_values, grid_size,
                     chunk: int = 262144) -> torch.Tensor:
    """[X, Y, Z, T] dense alpha = max over the two fields, per time slice, on
    the device of the parameters.

    The reference's getDenseAlpha (tensorBase.py:564-589) is single-field;
    for the dual model a sample is skippable only where both fields are
    transparent, so the volume takes max(alpha_static, alpha_dynamic(t)).
    The fields are sampled through the unfused f32 samplers, in chunks of
    `chunk` points."""
    aabb_np = np.asarray(aabb, np.float32)
    axes = [np.linspace(0, 1, g, dtype=np.float32) for g in grid_size]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pts = aabb_np[0] * (1 - pts) + aabb_np[1] * pts
    step_s = static_cfg.step_size(aabb_np)
    step_d = dynamic_cfg.step_size(aabb_np)
    dev = params["static"]["density_plane"][0].device
    aabb_t = torch.as_tensor(aabb_np, device=dev)
    pts_t = torch.from_numpy(pts).to(dev)
    st, dn = params["static"], params["dynamic"]
    out = torch.empty((pts.shape[0], len(t_values)), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for s in range(0, pts.shape[0], chunk):
            xyz = pts_t[s:s + chunk]
            xyz_n = normalize_coord(xyz, aabb_t)
            feat = sample_vm_sum(st["density_plane"], st["density_line"], xyz_n)
            a_s = 1.0 - torch.exp(-feature2density(feat, static_cfg) * step_s)
            for ti, tv in enumerate(t_values):
                t = torch.full((xyz.shape[0],), float(tv), dtype=torch.float32, device=dev)
                xyz_p = warp_coordinate(dn, xyz, t, aabb_t)
                feat_d = density_feature(dn, dynamic_cfg, xyz_n, t,
                                         normalize_coord(xyz_p, aabb_t))
                a_d = 1.0 - torch.exp(-feature2density(feat_d, dynamic_cfg) * step_d)
                out[s:s + chunk, ti] = torch.maximum(a_s, a_d)
    return out.reshape(tuple(grid_size) + (len(t_values),))


def build_dual_alpha_mask(params, static_cfg, dynamic_cfg, aabb, n_frames: int, thres: float,
                          max_dim: int = 192) -> AlphaGridMask:
    """Dense dual-field alpha at the current grid (capped at max_dim per
    axis) -> thresholded AlphaGridMask on the parameters' device (reference
    updateAlphaMask contract, tensorBase.py:591-629; the aabb is not shrunk:
    the dual model's static scene fills the NDC box)."""
    gs = [min(int(g), max_dim) for g in dynamic_cfg.grid_size]
    alpha = dual_dense_alpha(params, static_cfg, dynamic_cfg, aabb,
                             np.linspace(-1.0, 1.0, n_frames), gs)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=alpha.device)
    mask, _ = update_alpha_mask(alpha, aabb_t, thres)
    return mask
