"""Static VM-decomposed tensorial radiance field (port of
rodynrf_tpu/fields/static.py; reference models/tensoRF.py:11-274).

params = {
  'density_plane': [3 x (C_i, H, W)], 'density_line': [3 x (C_i, L)],
  'app_plane':     [3 x (C_i, H, W)], 'app_line':     [3 x (C_i, L)],
  'basis_mat':     (sum(app_n_comp), app_dim),
  'shading':       shading-MLP params,
}
"""

from __future__ import annotations

import torch

from ..ops.fused_vm import pack_vm, sample_vm_fused
from ..ops.grid_sample import (
    MAT_MODE,
    VEC_MODE,
    resize_bilinear_align_corners,
    resize_line_align_corners,
    sample_vm,
    sample_vm_sum,
)
from ..ops.regularizers import line_orthogonality, tv_loss_vm, vm_outer_l1
from .config import FieldConfig
from .mlps import init_shading, uniform

VM_SCALE = 0.1  # init scale (reference: tensoRF.py:17-21)


def init_vm(gen: torch.Generator, n_comp, grid_size, scale=VM_SCALE):
    """Init one plane/line stack (reference: tensoRF.py:26-47 init_one_svd)."""
    planes, lines = [], []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        planes.append(scale * torch.randn(
            (n_comp[i], grid_size[m1], grid_size[m0]), generator=gen))
        lines.append(scale * torch.randn((n_comp[i], grid_size[VEC_MODE[i]]), generator=gen))
    return planes, lines


def init_static_field(gen: torch.Generator, cfg: FieldConfig):
    density_plane, density_line = init_vm(gen, cfg.density_n_comp, cfg.grid_size)
    app_plane, app_line = init_vm(gen, cfg.app_n_comp, cfg.grid_size)
    bound = 1.0 / sum(cfg.app_n_comp) ** 0.5
    return {
        "density_plane": density_plane,
        "density_line": density_line,
        "app_plane": app_plane,
        "app_line": app_line,
        "basis_mat": uniform(gen, (sum(cfg.app_n_comp), cfg.app_dim), -bound, bound),
        "shading": init_shading(
            gen, cfg.shading_mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe, cfg.featureC
        ),
    }


def density_feature(params, xyz_n: torch.Tensor, gather_dtype=None) -> torch.Tensor:
    """Σ plane⊙line density through the unfused sampler (reference:
    tensoRF.py:118-154). xyz_n [N, 3] -> [N]."""
    return sample_vm_sum(params["density_plane"], params["density_line"], xyz_n,
                         gather_dtype=gather_dtype)


def app_feature(params, xyz_n: torch.Tensor, gather_dtype=None) -> torch.Tensor:
    """Appearance features through the unfused sampler and the basis matrix
    (reference: tensoRF.py:156-196). xyz_n [N, 3] -> [N, app_dim]."""
    feats = sample_vm(params["app_plane"], params["app_line"], xyz_n, strides=(1,),
                      gather_dtype=gather_dtype)
    return feats @ params["basis_mat"]


def pack_tables(params, cfg: FieldConfig):
    """Fused gather tables for the static field, in the config's gather
    dtype (one stride, so the layout is always strided). Density and
    appearance share one corner-packed table per orientation; with
    appearance compaction (cfg.app_frac > 0) they pack apart as {"db",
    "app"}: density rows are gathered for every sample, appearance rows
    only for the per-ray top-K bucket (render/pipeline.py)."""
    density = (params["density_plane"], params["density_line"])
    app = (params["app_plane"], params["app_line"])
    if cfg.app_frac > 0.0:
        return {"db": pack_vm([density], strides=(1,), gather_dtype=cfg.gather_dtype),
                "app": pack_vm([app], strides=(1,), gather_dtype=cfg.gather_dtype)}
    return pack_vm([density, app], strides=(1,), gather_dtype=cfg.gather_dtype)


def _sigma_sum(params, dens_f):
    """Σ_axes Σ_c with the per-axis add order of the reference sampler."""
    sigma = torch.zeros(dens_f.shape[0], dtype=dens_f.dtype, device=dens_f.device)
    c0 = 0
    for p in params["density_plane"]:
        c = p.shape[0]
        sigma = sigma + torch.sum(dens_f[:, c0:c0 + c], dim=-1)
        c0 += c
    return sigma


def all_features_fused(params, cfg: FieldConfig, xyz_n, packed=None):
    """Density (Σ plane⊙line) and appearance features in one fused gather
    (reference semantics tensoRF.py:118-196), or in two when the pack is
    split. Returns (sigma_feat [N], app [N, app_dim])."""
    if packed is None:
        packed = pack_tables(params, cfg)
    if isinstance(packed, dict):  # split (compaction) pack, dense evaluation
        return density_fused(params, cfg, xyz_n, packed), app_fused(params, cfg, xyz_n, packed)
    dens_f, app_f = sample_vm_fused(packed, xyz_n)
    return _sigma_sum(params, dens_f), app_f @ params["basis_mat"]


def density_fused(params, cfg: FieldConfig, xyz_n, packed):
    """Phase 1 of the compacted static evaluation: the density feature of
    every sample from the split pack's "db" tables. Returns [N]."""
    (dens_f,) = sample_vm_fused(packed["db"], xyz_n)
    return _sigma_sum(params, dens_f)


def app_fused(params, cfg: FieldConfig, xyz_n, packed):
    """Phase 2 of the compacted static evaluation: appearance features at
    the (compacted) coordinates [M, 3] -> [M, app_dim]."""
    (app_f,) = sample_vm_fused(packed["app"], xyz_n)
    return app_f @ params["basis_mat"]


def feature2density(feat: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """(reference: tensorBase.py:678-682)."""
    if cfg.fea2dense_act == "softplus":
        return torch.nn.functional.softplus(feat + cfg.density_shift)
    if cfg.fea2dense_act == "relu":
        return torch.relu(feat)
    raise ValueError(cfg.fea2dense_act)


def density_l1(params, cfg: FieldConfig) -> torch.Tensor:
    """(reference: tensoRF.py:80-98)."""
    return vm_outer_l1(
        params["density_plane"], params["density_line"], lambda f: feature2density(f, cfg)
    )


def tv_density(params) -> torch.Tensor:
    return tv_loss_vm(params["density_plane"], params["density_line"])


def tv_app(params) -> torch.Tensor:
    return tv_loss_vm(params["app_plane"], params["app_line"])


def vector_comp_diffs(params) -> torch.Tensor:
    """(reference: tensoRF.py:63-78)."""
    return line_orthogonality(params["density_line"]) + line_orthogonality(params["app_line"])


def upsample_vm(planes, lines, res_target):
    """align_corners bilinear grid upsample (reference: tensoRF.py:198-220)."""
    new_planes, new_lines = [], []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        new_planes.append(
            resize_bilinear_align_corners(planes[i], (res_target[m1], res_target[m0]))
        )
        new_lines.append(resize_line_align_corners(lines[i], res_target[VEC_MODE[i]]))
    return new_planes, new_lines


def upsample_static_field(params, res_target):
    """(reference: tensoRF.py:222-232). Returns a new tree: planes and lines
    resized, every other leaf the same tensor."""
    out = dict(params)
    out["density_plane"], out["density_line"] = upsample_vm(
        params["density_plane"], params["density_line"], res_target
    )
    out["app_plane"], out["app_line"] = upsample_vm(
        params["app_plane"], params["app_line"], res_target
    )
    return out
