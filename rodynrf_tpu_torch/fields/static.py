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
from ..ops.grid_sample import MAT_MODE, VEC_MODE
from ..ops.regularizers import tv_loss_vm, vm_outer_l1
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


def pack_tables(params, cfg: FieldConfig):
    """Fused gather tables for the static field: density and appearance
    grids share one corner-packed table per orientation (one stride)."""
    return pack_vm(
        [
            (params["density_plane"], params["density_line"]),
            (params["app_plane"], params["app_line"]),
        ],
        strides=(1,),
    )


def all_features_fused(params, cfg: FieldConfig, xyz_n, packed=None):
    """Density (Σ plane⊙line) and appearance features in one fused gather
    (reference semantics tensoRF.py:118-196). Returns (sigma_feat [N],
    app [N, app_dim])."""
    if packed is None:
        packed = pack_tables(params, cfg)
    dens_f, app_f = sample_vm_fused(packed, xyz_n)
    # Σ_axes Σ_c with the per-axis add order of the reference sampler
    sigma = torch.zeros(xyz_n.shape[0], dtype=xyz_n.dtype, device=xyz_n.device)
    c0 = 0
    for p in params["density_plane"]:
        c = p.shape[0]
        sigma = sigma + torch.sum(dens_f[:, c0:c0 + c], dim=-1)
        c0 += c
    return sigma, app_f @ params["basis_mat"]


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


