"""Dynamic (time-conditioned, deformation-warped) tensorial radiance field
(port of rodynrf_tpu/fields/dynamic.py; reference models/tensoRF.py:277-892).

Adds to the static field a deformation ("warp") MLP, multiscale (stride
1/2/4) density/appearance/blending grids, MLP heads for density and
blending, and a scene-flow MLP. The warp is evaluated once per sample and
shared by every grid (the reference re-evaluates it per grid with identical
inputs).
"""

from __future__ import annotations

import torch

from ..core.encoding import positional_encoding
from ..ops.fused_vm import (
    EVAL_MERGED_BYTES_LIMIT,
    MERGED_BYTES_LIMIT,
    pack_vm,
    sample_vm_fused,
)
from ..ops.grid_sample import sample_vm
from ..ops.regularizers import tv_loss_vm, vm_outer_l1
from .config import FieldConfig
from .mlps import init_shading, linear, linear_init, mlp_apply, mlp_init, uniform
from .static import feature2density, init_vm, upsample_vm

MULTISCALE_STRIDES = (1, 2, 4)


def normalize_coord(xyz, aabb):
    """aabb box -> [-1, 1]^3 (reference: tensorBase.py:425-428)."""
    inv_size = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv_size - 1.0


def unnormalize_coord(xyz_n, aabb):
    """[-1, 1]^3 -> aabb box (reference: tensorBase.py:430-433)."""
    inv_size = 2.0 / (aabb[1] - aabb[0])
    return (xyz_n + 1.0) / inv_size + aabb[0]


def init_dynamic_field(gen: torch.Generator, cfg: FieldConfig):
    density_plane, density_line = init_vm(gen, cfg.density_n_comp, cfg.grid_size)
    blending_plane, blending_line = init_vm(gen, cfg.density_n_comp, cfg.grid_size)
    app_plane, app_line = init_vm(gen, cfg.app_n_comp, cfg.grid_size)
    n_app_in = sum(cfg.app_n_comp) * len(MULTISCALE_STRIDES)
    bound = 1.0 / n_app_in ** 0.5
    head_in = sum(cfg.density_n_comp) * len(MULTISCALE_STRIDES) + 3 + 10 * 2 * 3 + 1 + 8 * 2 * 1
    return {
        "density_plane": density_plane,
        "density_line": density_line,
        "blending_plane": blending_plane,
        "blending_line": blending_line,
        "app_plane": app_plane,
        "app_line": app_line,
        "basis_mat": uniform(gen, (n_app_in, cfg.app_dim), -bound, bound),
        # warp MLP (reference: tensoRF.py:283-287)
        "warp_t1": linear_init(gen, 1 + 8 * 2 * 1, 64),
        "warp_t2": linear_init(gen, 64, 30),
        "warp_xyz": mlp_init(gen, [3 + 10 * 2 * 3 + 30, 64, 64, 3]),
        # density / blending heads (reference: tensoRF.py:289-297)
        "density_head": mlp_init(gen, [head_in, 64, 1]),
        "blending_head": mlp_init(gen, [head_in, 64, 1]),
        # scene flow MLP (reference: tensoRF.py:299-313)
        "scene_flow": mlp_init(gen, [4 * 2 * 4 + 4, 64, 64, 64, 6]),
        "shading": init_shading(
            gen, cfg.shading_mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe, cfg.featureC
        ),
    }


def warp_coordinate(params, xyz_unnorm: torch.Tensor, t: torch.Tensor, aabb) -> torch.Tensor:
    """Deformation warp (reference: tensoRF.py:521-541): xyz [N, 3] in scene
    units, t [N] in [-1, 1] -> warped (unnormalized) xyz + Δ."""
    t_in = torch.cat([t[:, None], positional_encoding(t[:, None], 8)], -1)
    t_code = linear(params["warp_t2"], torch.relu(linear(params["warp_t1"], t_in)))
    xyz_n = normalize_coord(xyz_unnorm, aabb)
    xyz_in = torch.cat([xyz_n, positional_encoding(xyz_n, 10), t_code], -1)
    return xyz_unnorm + mlp_apply(params["warp_xyz"], xyz_in)


def _head_inputs(vm_feats, xyz_n, t):
    return torch.cat(
        [vm_feats, xyz_n, positional_encoding(xyz_n, 10), t[:, None],
         positional_encoding(t[:, None], 8)],
        -1,
    )


def density_feature(params, cfg: FieldConfig, xyz_n, t, xyz_warped_n) -> torch.Tensor:
    """Multiscale density through the unfused sampler + the density head
    (reference: tensoRF.py:646-732). xyz_n: normalized query coords [N, 3];
    xyz_warped_n: normalized warped coords; t [N]. Returns [N]."""
    feats = sample_vm(params["density_plane"], params["density_line"], xyz_warped_n,
                      strides=MULTISCALE_STRIDES, gather_dtype=cfg.gather_dtype)
    return mlp_apply(params["density_head"], _head_inputs(feats, xyz_n, t))[..., 0]


def blending_feature(params, cfg: FieldConfig, xyz_n, t, xyz_warped_n) -> torch.Tensor:
    """Multiscale blending through the unfused sampler + the blending head
    (reference: tensoRF.py:543-629). Returns the raw (pre-sigmoid) [N]."""
    feats = sample_vm(params["blending_plane"], params["blending_line"], xyz_warped_n,
                      strides=MULTISCALE_STRIDES, gather_dtype=cfg.gather_dtype)
    return mlp_apply(params["blending_head"], _head_inputs(feats, xyz_n, t))[..., 0]


def app_feature(params, cfg: FieldConfig, xyz_warped_n) -> torch.Tensor:
    """Multiscale appearance through the unfused sampler and the basis matrix
    (reference: tensoRF.py:734-811). Returns [N, app_dim]."""
    feats = sample_vm(params["app_plane"], params["app_line"], xyz_warped_n,
                      strides=MULTISCALE_STRIDES, gather_dtype=cfg.gather_dtype)
    return feats @ params["basis_mat"]


def pack_tables(params, cfg: FieldConfig, eval_mode: bool = False):
    """Fused gather tables for the dynamic field's three grids (density,
    blending, appearance share the warped sample coordinates), in the
    config's gather dtype and layout ('auto' picks by table bytes; with
    `eval_mode`, the render path's larger budget). Build once per step (or
    per rendered frame) and share across passes.

    With appearance compaction (cfg.app_frac > 0) the density + blending
    grids and the appearance grid pack apart as {"db", "app"}, each taking
    its own layout: the narrow density + blending rows are gathered for
    every sample, the wide appearance rows only for the per-ray top-K
    bucket (render/pipeline.py)."""
    density = (params["density_plane"], params["density_line"])
    blending = (params["blending_plane"], params["blending_line"])
    app = (params["app_plane"], params["app_line"])

    def pack(grids):
        return pack_vm(
            grids,
            strides=MULTISCALE_STRIDES,
            gather_dtype=cfg.gather_dtype,
            layout=cfg.vm_layout,
            merged_bytes_limit=EVAL_MERGED_BYTES_LIMIT if eval_mode else MERGED_BYTES_LIMIT,
        )

    if cfg.app_frac > 0.0:
        return {"db": pack([density, blending]), "app": pack([app])}
    return pack([density, blending, app])


def all_features_fused(params, cfg: FieldConfig, xyz_n, t, xyz_warped_n, packed=None):
    """Density, blending and appearance features from one fused gather per
    orientation (two with a split pack). Returns (sigma_raw [N],
    blending_raw [N], app [N, app_dim])."""
    if packed is None:
        packed = pack_tables(params, cfg)
    if isinstance(packed, dict):  # split (compaction) pack, dense evaluation
        sigma, blend = density_blend_fused(params, cfg, xyz_n, t, xyz_warped_n, packed)
        return sigma, blend, app_fused(params, cfg, xyz_warped_n, packed)
    dens_f, blend_f, app_f = sample_vm_fused(packed, xyz_warped_n)
    sigma = mlp_apply(params["density_head"], _head_inputs(dens_f, xyz_n, t))[..., 0]
    blend = mlp_apply(params["blending_head"], _head_inputs(blend_f, xyz_n, t))[..., 0]
    return sigma, blend, app_f @ params["basis_mat"]


def density_blend_fused(params, cfg: FieldConfig, xyz_n, t, xyz_warped_n, packed):
    """Phase 1 of the compacted evaluation: density and blending of every
    sample from the split pack's "db" tables. Returns (sigma_raw [N],
    blending_raw [N])."""
    dens_f, blend_f = sample_vm_fused(packed["db"], xyz_warped_n)
    sigma = mlp_apply(params["density_head"], _head_inputs(dens_f, xyz_n, t))[..., 0]
    blend = mlp_apply(params["blending_head"], _head_inputs(blend_f, xyz_n, t))[..., 0]
    return sigma, blend


def app_fused(params, cfg: FieldConfig, xyz_warped_n, packed):
    """Phase 2 of the compacted evaluation: appearance features at the
    (compacted) warped coordinates [M, 3] -> [M, app_dim]."""
    (app_f,) = sample_vm_fused(packed["app"], xyz_warped_n)
    return app_f @ params["basis_mat"]


def _flow_inputs(pts_n, tt):
    return torch.cat([pts_n, positional_encoding(pts_n, 4), tt, positional_encoding(tt, 4)], -1)


def scene_flow(params, xyz_unnorm: torch.Tensor, t: torch.Tensor, aabb):
    """Forward/backward scene flow (reference: tensoRF.py:446-462).
    xyz_unnorm [R, S, 3]; t [R]. Returns (flow_f, flow_b), each [R, S, 3]."""
    R, S, _ = xyz_unnorm.shape
    pts_n = normalize_coord(xyz_unnorm.reshape(-1, 3), aabb)
    tt = t[:, None].expand(R, S).reshape(-1, 1)
    sf = mlp_apply(params["scene_flow"], _flow_inputs(pts_n, tt)).reshape(R, S, 6)
    return sf[..., 0:3], sf[..., 3:6]


def scene_flow_point(params, pts_map: torch.Tensor, t: torch.Tensor, aabb):
    """Scene flow at rendered surface points (reference: tensoRF.py:506-519).
    pts_map [R, 3]; t [R]. Returns (pts+f, pts+b, f, b)."""
    pts_n = normalize_coord(pts_map, aabb)
    sf = mlp_apply(params["scene_flow"], _flow_inputs(pts_n, t[..., None]))
    f, b = sf[..., 0:3], sf[..., 3:6]
    return pts_map + f, pts_map + b, f, b


def density_l1(params, cfg: FieldConfig) -> torch.Tensor:
    return vm_outer_l1(
        params["density_plane"], params["density_line"], lambda f: feature2density(f, cfg)
    )


def blending_l1(params, cfg: FieldConfig) -> torch.Tensor:
    """(reference: tensoRF.py:398-416)."""
    return vm_outer_l1(
        params["blending_plane"], params["blending_line"], lambda f: feature2density(f, cfg)
    )


def tv_density(params) -> torch.Tensor:
    return tv_loss_vm(params["density_plane"], params["density_line"])


def tv_blending(params) -> torch.Tensor:
    return tv_loss_vm(params["blending_plane"], params["blending_line"])


def tv_app(params) -> torch.Tensor:
    return tv_loss_vm(params["app_plane"], params["app_line"])


def upsample_dynamic_field(params, res_target):
    """(reference: tensoRF.py:837-850). Returns a new tree: planes and lines
    resized, every other leaf the same tensor."""
    out = dict(params)
    for name in ("density", "blending", "app"):
        out[f"{name}_plane"], out[f"{name}_line"] = upsample_vm(
            params[f"{name}_plane"], params[f"{name}_line"], res_target
        )
    return out
