"""Field evaluation over one batch of rays (port of
rodynrf_tpu/render/pipeline.py; reference models/tensorBase.py:704-850).

Three branches, all with static shapes between probes:
- dense: every [rays, samples] sample, where-masked by ray_valid instead of
  the reference's boolean gathers;
- appearance top-K (cfg.app_frac > 0 with a split pack): density (and
  blending) on every sample, then the appearance gather and shading MLP on
  the K highest-weight samples of each ray only (ops/compaction.py), with
  the reference's `weight > thres` zeroing in compacted space
  (tensorBase.py:774-804);
- flat bucket (flat_n > 0): the per-sample work runs on a flat [flat_n]
  bucket of the ray_valid samples, scattered back dense with a coverage
  channel (the train step's flat compaction, StepStatics.compact_flat).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..fields import dynamic as dyn
from ..fields import static as stat
from ..fields.config import FieldConfig
from ..fields.mlps import apply_shading
from ..fields.static import feature2density
from ..ops.compaction import compact_rows, expand_rows, topk_select
from ..ops.compositing import raw2alpha
from ..utils.profiling import span


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


def _flat_index(ray_valid: torch.Tensor, N: int, base: Optional[torch.Tensor] = None):
    """Flat slot table over the occupied samples of a [R, S] mask: slot n ->
    row-major dense position idx_flat[n] in [0, R·S), the sentinel R·S for
    unused slots (gathers clamp it, the payload scatter drops it). Occupied
    samples past the N-th drop too. A cumsum and one scatter into an [N + 1]
    buffer whose last slot takes every dropped write: static shapes, no
    host sync. Returns (idx_flat, idx_safe, ray id of each slot).

    base [R] (data parallelism over rays, train/step._flat_args): these rows
    are one rank's part of a larger batch, and base[r] is added to row r's
    sample positions to give their place in the whole batch's row-major
    order; a sample is kept when that place is below N, so the ranks
    together keep the whole batch's first N. The kept samples are a prefix
    of the rows' own order, so min(N, R·S) slots hold them."""
    R, S = ray_valid.shape
    RS = R * S
    occf = ray_valid.reshape(-1)
    pos = torch.cumsum(occf.to(torch.int64), 0) - 1
    if base is None:
        keep = occf & (pos < N)
    else:
        keep = occf & (pos + base[:, None].expand(R, S).reshape(-1) < N)
        N = min(N, RS)
    src = torch.where(keep, pos, N)
    idx_flat = torch.full((N + 1,), RS, dtype=torch.int64, device=occf.device)
    idx_flat.scatter_(0, src, torch.arange(RS, dtype=torch.int64, device=occf.device))
    idx_flat = idx_flat[:N]
    idx_safe = torch.clamp(idx_flat, max=RS - 1)
    return idx_flat, idx_safe, torch.div(idx_safe, S, rounding_mode="floor")


def _scatter_payload(idx_flat, parts, RS: int):
    """One packed scatter-back of per-slot channels to dense [RS, C], with a
    leading coverage channel (1 where a slot landed): samples the flat
    bucket dropped must read as empty (sigma = blending = 0), not as
    feature2density(0), which is nonzero for softplus. Returns (covered
    [RS] bool, dense [RS, C])."""
    dtype = parts[0].dtype
    cols = [torch.ones((idx_flat.shape[0], 1), dtype=dtype, device=idx_flat.device)]
    cols += [(p[:, None] if p.dim() == 1 else p).to(dtype) for p in parts]
    payload = torch.cat(cols, dim=-1)
    dense = payload.new_zeros((RS + 1, payload.shape[-1])).index_copy(0, idx_flat, payload)
    return dense[:RS, 0] > 0, dense[:RS, 1:]


def _shade_compacted(shading_params, cfg: FieldConfig, weight, idx_keep, pts, vd_rays,
                     app_fn, ts):
    """Appearance gather + shading MLP on the per-ray top-K bucket only.

    pts [R, S, C3]: the coordinate channels to compact; the leading 3 feed
    the appearance gather, the trailing 3 the shading MLP. Returns dense rgb
    [R, S, 3], zero off the bucket (the reference's app_mask semantics,
    tensorBase.py:774-804)."""
    R, S = weight.shape
    idx, keep = idx_keep
    K = idx.shape[1]
    pts_k = compact_rows(pts, idx)  # [R, K, C3]
    app_feats = app_fn(pts_k[..., :3].reshape(-1, 3))
    vd = vd_rays[:, None, :].expand(R, K, 3).reshape(-1, 3)
    t_in = ts[:, None].expand(R, K).reshape(-1, 1)
    rgb_k = apply_shading(
        shading_params, cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe,
        pts_k[..., -3:].reshape(-1, 3), vd, app_feats, t_in,
    ).reshape(R, K, 3)
    return expand_rows(rgb_k * keep[..., None], idx, S)


def eval_static_field(params, cfg: FieldConfig, aabb, rays, ts, xyz, z_vals, ray_valid,
                      ray_type: str = "ndc", packed=None, dists=None,
                      flat_n: int = 0, flat_base=None) -> FieldEval:
    """Static field forward over [R, S] samples.

    packed: prebuilt gather tables (stat.pack_tables), hoisted out of
    per-pass code. dists: precomputed unscaled dists (the compacted train
    step passes the dense consecutive-z dists gathered at its kept samples,
    which compacted z_vals cannot give). flat_n > 0: the per-sample work
    runs through a flat [flat_n] bucket of the ray_valid samples; flat_base:
    this rank's row offsets into the whole batch's bucket (_flat_index)."""
    with span("field.static"):
        R, S, _ = xyz.shape
        dense_dists, viewdirs = _dists_and_viewdirs(rays, z_vals, ray_type)
        dists = (dense_dists if dists is None else dists) * cfg.distance_scale
        xyz_n = dyn.normalize_coord(xyz, aabb)
        if packed is None:
            packed = stat.pack_tables(params, cfg)

        if flat_n > 0:
            RS = R * S
            idx_flat, idx_safe, rid = _flat_index(ray_valid, flat_n, flat_base)
            pts_f = xyz_n.reshape(RS, 3).index_select(0, idx_safe)
            sigma_feat_f, app_f = stat.all_features_fused(params, cfg, pts_f, packed=packed)
            rgb_f = apply_shading(
                params["shading"], cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe,
                pts_f, viewdirs.index_select(0, rid), app_f, ts.index_select(0, rid)[:, None],
            )
            covered, dense = _scatter_payload(
                idx_flat, (feature2density(sigma_feat_f, cfg), rgb_f), RS)
            sigma = torch.where(ray_valid & covered.reshape(R, S), dense[:, 0].reshape(R, S), 0.0)
            _, weight, _ = raw2alpha(sigma, dists)
            rgb = torch.where((weight > cfg.ray_march_weight_thres)[..., None],
                              dense[:, 1:4].reshape(R, S, 3), 0.0)
            return FieldEval(blending=None, pts_ref=xyz, weights=weight, xyz_prime=None,
                             rgb=rgb, sigma=sigma, z_vals=z_vals, dists=dists)

        flat = xyz_n.reshape(-1, 3)
        K = cfg.app_topk(S)
        compacted = isinstance(packed, dict) and 0 < K < S
        if compacted:
            sigma_feat = stat.density_fused(params, cfg, flat, packed)
        else:
            sigma_feat, app_feats = stat.all_features_fused(params, cfg, flat, packed=packed)
        sigma = torch.where(ray_valid, feature2density(sigma_feat.reshape(R, S), cfg), 0.0)
        _, weight, _ = raw2alpha(sigma, dists)

        if compacted:
            rgb = _shade_compacted(
                params["shading"], cfg, weight, topk_select(weight, K, cfg.ray_march_weight_thres),
                xyz_n, viewdirs, lambda pts: stat.app_fused(params, cfg, pts, packed), ts,
            )
        else:
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
                       ray_type: str = "ndc", packed=None, dists=None,
                       flat_n: int = 0, flat_base=None) -> FieldEval:
    """Dynamic field forward over [R, S] samples. The deformation warp is
    evaluated once and shared by the density, blending and appearance
    gathers. dists, flat_n, flat_base: see eval_static_field; on the flat branch
    xyz_prime is zero off the kept samples (no loss reads it there)."""
    with span("field.dynamic"):
        R, S, _ = xyz.shape
        dense_dists, viewdirs = _dists_and_viewdirs(rays, z_vals, ray_type)
        dists = (dense_dists if dists is None else dists) * cfg.distance_scale
        if packed is None:
            packed = dyn.pack_tables(params, cfg)

        if flat_n > 0:
            RS = R * S
            idx_flat, idx_safe, rid = _flat_index(ray_valid, flat_n, flat_base)
            xyz_f = xyz.reshape(RS, 3).index_select(0, idx_safe)
            t_f = ts.index_select(0, rid)
            xyz_prime_f = dyn.warp_coordinate(params, xyz_f, t_f, aabb)
            xyz_n_f = dyn.normalize_coord(xyz_f, aabb)
            sigma_feat_f, blend_feat_f, app_f = dyn.all_features_fused(
                params, cfg, xyz_n_f, t_f, dyn.normalize_coord(xyz_prime_f, aabb), packed=packed
            )
            rgb_f = apply_shading(
                params["shading"], cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe,
                xyz_n_f, viewdirs.index_select(0, rid), app_f, t_f[:, None],
            )
            covered, dense = _scatter_payload(
                idx_flat, (feature2density(sigma_feat_f, cfg), torch.sigmoid(blend_feat_f), rgb_f,
                           xyz_prime_f), RS)
            live = ray_valid & covered.reshape(R, S)
            sigma = torch.where(live, dense[:, 0].reshape(R, S), 0.0)
            blending = torch.where(live, dense[:, 1].reshape(R, S), 0.0)
            _, weight, _ = raw2alpha(sigma, dists)
            rgb = torch.where((weight > cfg.ray_march_weight_thres)[..., None],
                              dense[:, 2:5].reshape(R, S, 3), 0.0)
            return FieldEval(blending=blending, pts_ref=xyz, weights=weight,
                             xyz_prime=dense[:, 5:8].reshape(R, S, 3), rgb=rgb, sigma=sigma,
                             z_vals=z_vals, dists=dists)

        xyz_flat = xyz.reshape(-1, 3)
        xyz_n = dyn.normalize_coord(xyz_flat, aabb)
        t_flat = ts[:, None].expand(R, S).reshape(-1)
        xyz_prime = dyn.warp_coordinate(params, xyz_flat, t_flat, aabb)
        xyz_prime_n = dyn.normalize_coord(xyz_prime, aabb)
        K = cfg.app_topk(S)
        compacted = isinstance(packed, dict) and 0 < K < S
        if compacted:
            sigma_feat, blend_feat = dyn.density_blend_fused(
                params, cfg, xyz_n, t_flat, xyz_prime_n, packed)
        else:
            sigma_feat, blend_feat, app_feats = dyn.all_features_fused(
                params, cfg, xyz_n, t_flat, xyz_prime_n, packed=packed
            )
        sigma = torch.where(ray_valid, feature2density(sigma_feat.reshape(R, S), cfg), 0.0)
        _, weight, _ = raw2alpha(sigma, dists)

        if compacted:
            # leading 3 channels: warped coords (appearance gather); trailing 3:
            # unwarped normalized coords (shading MLP input)
            pts6 = torch.cat([xyz_prime_n.reshape(R, S, 3), xyz_n.reshape(R, S, 3)], dim=-1)
            rgb = _shade_compacted(
                params["shading"], cfg, weight, topk_select(weight, K, cfg.ray_march_weight_thres),
                pts6, viewdirs, lambda pts: dyn.app_fused(params, cfg, pts, packed), ts,
            )
        else:
            vd = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
            rgb_raw = apply_shading(
                params["shading"], cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe,
                xyz_n, vd, app_feats, t_flat[:, None],
            ).reshape(R, S, 3)
            rgb = torch.where((weight > cfg.ray_march_weight_thres)[..., None], rgb_raw, 0.0)
        blending = torch.where(ray_valid, torch.sigmoid(blend_feat.reshape(R, S)), 0.0)
        return FieldEval(blending=blending, pts_ref=xyz, weights=weight,
                         xyz_prime=xyz_prime.reshape(R, S, 3), rgb=rgb, sigma=sigma,
                         z_vals=z_vals, dists=dists)
