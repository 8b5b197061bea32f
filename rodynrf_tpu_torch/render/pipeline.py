"""Field evaluation over one batch of rays, dense branch (port of
rodynrf_tpu/render/pipeline.py; reference models/tensorBase.py:704-850).

Everything is dense over [rays, samples] with where-masking instead of the
reference's boolean gathers. The compacted and flat-bucket branches of the
JAX package are later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..fields import dynamic as dyn
from ..fields import static as stat
from ..fields.config import FieldConfig
from ..fields.mlps import apply_shading
from ..fields.static import feature2density
from ..ops.compositing import raw2alpha


class FieldEval(NamedTuple):
    """Per-sample field outputs (mirrors tensorBase.py:839-850 return)."""

    blending: Optional[torch.Tensor]  # [R, S] or None (static field)
    pts_ref: torch.Tensor  # [R, S, 3] sampled points (input space)
    weights: torch.Tensor  # [R, S]
    xyz_prime: Optional[torch.Tensor]  # [R, S, 3] warped points or None
    rgb: torch.Tensor  # [R, S, 3]
    sigma: torch.Tensor  # [R, S]
    z_vals: torch.Tensor  # [R, S]
    dists: torch.Tensor  # [R, S] (already × distance_scale)

    def detach(self) -> "FieldEval":
        return FieldEval(*(None if v is None else v.detach() for v in self))


def _dists_and_viewdirs(rays, z_vals, ray_type):
    """(reference: tensorBase.py:717-739)."""
    viewdirs = rays[:, 3:6]
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], -1)
    if ray_type in ("ndc", "contract"):
        norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
        dists = dists * norm
        viewdirs = viewdirs / norm
    return dists, viewdirs


def eval_static_field(params, cfg: FieldConfig, aabb, rays, ts, xyz, z_vals, ray_valid,
                      ray_type: str = "ndc", packed=None) -> FieldEval:
    """Static field forward over [R, S] samples. packed: prebuilt gather
    tables (stat.pack_tables), hoisted out of per-pass code."""
    R, S, _ = xyz.shape
    dists, viewdirs = _dists_and_viewdirs(rays, z_vals, ray_type)
    flat = dyn.normalize_coord(xyz, aabb).reshape(-1, 3)
    if packed is None:
        packed = stat.pack_tables(params, cfg)
    sigma_feat, app_feats = stat.all_features_fused(params, cfg, flat, packed=packed)
    sigma = torch.where(ray_valid, feature2density(sigma_feat.reshape(R, S), cfg), 0.0)
    dists = dists * cfg.distance_scale
    _, weight, _ = raw2alpha(sigma, dists)

    vd = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    t_in = ts[:, None].expand(R, S).reshape(-1, 1)
    rgb_raw = apply_shading(
        params["shading"], cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe,
        flat, vd, app_feats, t_in,
    ).reshape(R, S, 3)
    rgb = torch.where((weight > cfg.ray_march_weight_thres)[..., None], rgb_raw, 0.0)
    return FieldEval(blending=None, pts_ref=xyz, weights=weight, xyz_prime=None,
                     rgb=rgb, sigma=sigma, z_vals=z_vals, dists=dists)


def eval_dynamic_field(params, cfg: FieldConfig, aabb, rays, ts, xyz, z_vals, ray_valid,
                       ray_type: str = "ndc", packed=None) -> FieldEval:
    """Dynamic field forward over [R, S] samples. The deformation warp is
    evaluated once and shared by the density, blending and appearance
    gathers."""
    R, S, _ = xyz.shape
    dists, viewdirs = _dists_and_viewdirs(rays, z_vals, ray_type)
    xyz_flat = xyz.reshape(-1, 3)
    flat_n = dyn.normalize_coord(xyz_flat, aabb)
    t_flat = ts[:, None].expand(R, S).reshape(-1)

    xyz_prime = dyn.warp_coordinate(params, xyz_flat, t_flat, aabb)
    xyz_prime_n = dyn.normalize_coord(xyz_prime, aabb)
    if packed is None:
        packed = dyn.pack_tables(params, cfg)
    sigma_feat, blend_feat, app_feats = dyn.all_features_fused(
        params, cfg, flat_n, t_flat, xyz_prime_n, packed=packed
    )
    sigma = torch.where(ray_valid, feature2density(sigma_feat.reshape(R, S), cfg), 0.0)
    dists = dists * cfg.distance_scale
    _, weight, _ = raw2alpha(sigma, dists)

    vd = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    rgb_raw = apply_shading(
        params["shading"], cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe,
        flat_n, vd, app_feats, t_flat[:, None],
    ).reshape(R, S, 3)
    rgb = torch.where((weight > cfg.ray_march_weight_thres)[..., None], rgb_raw, 0.0)
    blending = torch.where(ray_valid, torch.sigmoid(blend_feat.reshape(R, S)), 0.0)
    return FieldEval(blending=blending, pts_ref=xyz, weights=weight,
                     xyz_prime=xyz_prime.reshape(R, S, 3), rgb=rgb, sigma=sigma,
                     z_vals=z_vals, dists=dists)
