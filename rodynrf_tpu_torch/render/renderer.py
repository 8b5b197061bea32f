"""Image renderer: chunked dual-field rendering of full frames (port of
rodynrf_tpu/render/renderer.py; reference renderer.py:24-144, 660-966).

A frame's rays go through one chunk function, chunk by chunk, under
`torch.inference_mode()`. Sampling is deterministic (no jitter, no white
fill). The gather tables are packed once per frame by `render_chunk.pack`,
in the configs' dtype and layout as the train step packs them ('auto' with
the render path's larger merged budget).

With an occupancy mask the chunk renderer takes one of two paths:
- dense (`compact=False`): samples whose trilinear mask value is 0 are
  marked invalid before the field evaluations (the reference's early-out,
  tensorBase.py:745-765);
- compact: the nearest-voxel test on the pre-dilated volume selects the
  chunk's occupied samples (a superset of the trilinear test's), the two
  fields run on one flat bucket of them, sized to the chunk's count rounded
  up to `flat_quantum` (one count read back per chunk), and the outputs
  scatter back for the dense compositor. The superset-masked dense render
  (`render_chunk.dense_superset`) is its exactness oracle and its fallback
  when the bucket would not be smaller than the chunk.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.rays import get_ray_directions_blender, get_rays, ndc_rays_blender
from ..fields import dynamic as dyn_fields
from ..fields import static as stat_fields
from ..fields.alpha_mask import dilate_occupancy, occupancy_nearest
from ..fields.config import FieldConfig
from ..fields.mlps import apply_shading
from ..fields.static import feature2density
from ..ops.compositing import raw2alpha, raw2outputs
from ..utils.profiling import span
from .flow import induce_flow
from .pipeline import _dists_and_viewdirs, _flat_index, eval_dynamic_field, eval_static_field
from .sampling import sample_xyz


class RenderMaps(NamedTuple):
    """Per-ray maps of one chunk."""

    rgb: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    rgb_s: torch.Tensor
    depth_s: torch.Tensor
    rgb_d: torch.Tensor
    depth_d: torch.Tensor
    blending: torch.Tensor  # [N] dynamicness
    delta_xyz: torch.Tensor  # [N, 3] mean warp displacement


def _pack(static_cfg: FieldConfig, dynamic_cfg: FieldConfig):
    def pack(params):
        with torch.inference_mode():
            return (
                stat_fields.pack_tables(params["static"], static_cfg),
                dyn_fields.pack_tables(params["dynamic"], dynamic_cfg, eval_mode=True),
            )

    return pack


def _fields(params, packs, static_cfg, dynamic_cfg, aabb, rays, ts, ray_type, n_samples,
            step_size, samp=None):
    xyz, z_vals, ray_valid = samp if samp is not None else sample_xyz(
        rays, n_samples, ray_type, static_cfg.near_far, aabb, step_size, None
    )
    st = eval_static_field(params["static"], static_cfg, aabb, rays, ts, xyz, z_vals,
                           ray_valid, ray_type, packed=packs[0])
    dn = eval_dynamic_field(params["dynamic"], dynamic_cfg, aabb, rays, ts, xyz, z_vals,
                            ray_valid, ray_type, packed=packs[1])
    out = raw2outputs(st.rgb, st.sigma, dn.rgb, dn.sigma, dn.dists, dn.blending, dn.z_vals,
                      rays, is_train=False, ray_type=ray_type)
    return st, dn, out


def make_chunk_renderer(
    static_cfg: FieldConfig,
    dynamic_cfg: FieldConfig,
    ray_type: str,
    n_samples: int,
    step_size: float,
    alpha_mask=None,
    compact: bool = False,
    flat_quantum: int = 16384,
):
    """The per-chunk render function (params, packs, aabb, rays, ts) ->
    RenderMaps, with `.pack(params)` building the frame's gather tables.

    alpha_mask: an AlphaGridMask (on any device; a copy moves to the
    chunk's). compact: with a mask, the flat-bucket path (module
    docstring); `.flat_fn(N)` pins the bucket size and `.dense_superset` is
    the oracle. Without a mask `compact` renders dense, as in the JAX
    package. `.flat_log` collects (N, occupied count, R·S) per compact
    chunk (the caller may clear it)."""
    masks = {}

    def mask_on(device):
        if device not in masks:
            m = alpha_mask.to(device)
            vol = dilate_occupancy(m.alpha_volume) if compact else None
            masks[device] = (m, vol)
        return masks[device]

    def sample_masked(aabb, rays, ts):
        xyz, z_vals, ray_valid = sample_xyz(
            rays, n_samples, ray_type, static_cfg.near_far, aabb, step_size, None)
        if alpha_mask is not None:
            R, S, _ = xyz.shape
            alphas = mask_on(aabb.device)[0].sample_alpha(
                xyz.reshape(-1, 3), ts[:, None].expand(R, S).reshape(-1)).reshape(R, S)
            ray_valid = ray_valid & (alphas > 0)
        return xyz, z_vals, ray_valid

    def finish(params, packs, aabb, rays, ts, samp) -> RenderMaps:
        _, dn, out = _fields(params, packs, static_cfg, dynamic_cfg, aabb, rays, ts,
                             ray_type, n_samples, step_size, samp=samp)
        delta = torch.mean(torch.abs(dn.xyz_prime - dn.pts_ref), dim=1)
        return RenderMaps(out.rgb_full, out.depth_full, out.rgb_s, out.depth_s,
                          out.rgb_d, out.depth_d, out.dynamicness, delta)

    def occ_probe(aabb, rays, ts):
        """The superset selector: (xyz, z_vals, occ) of the chunk."""
        m, vol = mask_on(aabb.device)
        xyz, z_vals, ray_valid = sample_xyz(
            rays, n_samples, ray_type, static_cfg.near_far, aabb, step_size, None)
        R, S, _ = xyz.shape
        occ = occupancy_nearest(vol, m.aabb, xyz.reshape(-1, 3),
                                ts[:, None].expand(R, S).reshape(-1)).reshape(R, S)
        return xyz, z_vals, ray_valid & occ

    def render_flat(params, packs, aabb, rays, ts, probed, N: int) -> RenderMaps:
        """The chunk's occupied samples in one flat [N] bucket through both
        fields (gathers + shading MLPs), one 12-channel scatter back to [R,
        S] (zeros where the selector dropped a sample: exactly the oracle's
        where(occ, ., 0)), then the dense compositor."""
        xyz, z_vals, occ = probed
        R, S, _ = xyz.shape
        RS = R * S
        dists, viewdirs = _dists_and_viewdirs(rays, z_vals, ray_type)
        idx_flat, idx_safe, rid = _flat_index(occ, N)
        xyz_f = xyz.reshape(RS, 3).index_select(0, idx_safe)
        t_f = ts.index_select(0, rid)
        vd_f = viewdirs.index_select(0, rid)
        xyz_fn = dyn_fields.normalize_coord(xyz_f, aabb)
        p_s, p_d = params["static"], params["dynamic"]

        sig_feat_s, app_s = stat_fields.all_features_fused(p_s, static_cfg, xyz_fn,
                                                           packed=packs[0])
        rgb_s_f = apply_shading(p_s["shading"], static_cfg.shading_mode, static_cfg.view_pe,
                                static_cfg.fea_pe, static_cfg.pos_pe, xyz_fn, vd_f, app_s,
                                t_f[:, None])
        xyz_prime_f = dyn_fields.warp_coordinate(p_d, xyz_f, t_f, aabb)
        sig_feat_d, blend_feat, app_d = dyn_fields.all_features_fused(
            p_d, dynamic_cfg, xyz_fn, t_f, dyn_fields.normalize_coord(xyz_prime_f, aabb),
            packed=packs[1])
        rgb_d_f = apply_shading(p_d["shading"], dynamic_cfg.shading_mode, dynamic_cfg.view_pe,
                                dynamic_cfg.fea_pe, dynamic_cfg.pos_pe, xyz_fn, vd_f, app_d,
                                t_f[:, None])
        payload = torch.cat([
            feature2density(sig_feat_s, static_cfg)[:, None],
            feature2density(sig_feat_d, dynamic_cfg)[:, None],
            torch.sigmoid(blend_feat)[:, None], rgb_s_f, rgb_d_f, xyz_prime_f,
        ], dim=-1)
        dense = payload.new_zeros((RS + 1, payload.shape[-1]))
        dense.index_copy_(0, idx_flat, payload)  # unused slots land in row RS
        dense = dense[:RS]
        sigma_s = dense[:, 0].reshape(R, S)
        sigma_d = dense[:, 1].reshape(R, S)
        blending = dense[:, 2].reshape(R, S)
        xyz_prime = dense[:, 9:12].reshape(R, S, 3)
        # the reference's app_mask: rgb zeroed below the transmittance-weight
        # threshold, which needs the dense sigma (tensorBase.py:774-804)
        _, w_s, _ = raw2alpha(sigma_s, dists * static_cfg.distance_scale)
        _, w_d, _ = raw2alpha(sigma_d, dists * dynamic_cfg.distance_scale)
        rgb_s = torch.where((w_s > static_cfg.ray_march_weight_thres)[..., None],
                            dense[:, 3:6].reshape(R, S, 3), 0.0)
        rgb_d = torch.where((w_d > dynamic_cfg.ray_march_weight_thres)[..., None],
                            dense[:, 6:9].reshape(R, S, 3), 0.0)
        out = raw2outputs(rgb_s, sigma_s, rgb_d, sigma_d, dists * dynamic_cfg.distance_scale,
                          blending, z_vals, rays, is_train=False, ray_type=ray_type)
        kf = occ.to(xyz.dtype)[..., None]
        delta = torch.sum(torch.abs(xyz_prime - xyz) * kf, dim=1) / torch.clamp(
            torch.sum(kf, dim=1), min=1.0)
        return RenderMaps(out.rgb_full, out.depth_full, out.rgb_s, out.depth_s,
                          out.rgb_d, out.depth_d, out.dynamicness, delta)

    use_compact = compact and alpha_mask is not None

    def render_chunk(params, packs, aabb, rays, ts) -> RenderMaps:
        with torch.inference_mode():
            if not use_compact:
                return finish(params, packs, aabb, rays, ts, sample_masked(aabb, rays, ts))
            probed = occ_probe(aabb, rays, ts)
            RS = probed[2].numel()
            total = int(probed[2].sum())  # the one count read back per chunk
            N = min(RS, -(-max(total, 1) // flat_quantum) * flat_quantum)
            render_chunk.flat_log.append((N, total, RS))
            if N >= RS:
                return finish(params, packs, aabb, rays, ts, probed)
            return render_flat(params, packs, aabb, rays, ts, probed, N)

    def flat_fn(N: int):
        def call(params, packs, aabb, rays, ts):
            with torch.inference_mode():
                return render_flat(params, packs, aabb, rays, ts, occ_probe(aabb, rays, ts), N)
        return call

    def dense_superset(params, packs, aabb, rays, ts) -> RenderMaps:
        with torch.inference_mode():
            return finish(params, packs, aabb, rays, ts, occ_probe(aabb, rays, ts))

    render_chunk.pack = _pack(static_cfg, dynamic_cfg)
    render_chunk.flat_log = []
    if use_compact:
        render_chunk.flat_fn = flat_fn
        render_chunk.dense_superset = dense_superset
    return render_chunk


class VisMaps(NamedTuple):
    """RenderMaps + the induced-flow/Δxyz families the reference's train-time
    vis logs (reference: renderer.py:483-560, 612-615)."""

    base: RenderMaps
    induced_flow_f: torch.Tensor  # [N, 2] px
    induced_flow_b: torch.Tensor
    induced_flow_s_f: torch.Tensor
    induced_flow_s_b: torch.Tensor
    delta_xyz_sum: torch.Tensor  # [N, 3] weights_d-weighted warp displacement


def make_vis_chunk_renderer(
    static_cfg: FieldConfig,
    dynamic_cfg: FieldConfig,
    ray_type: str,
    n_samples: int,
    step_size: float,
    H: int,
    W: int,
):
    """Vis-mode chunk renderer: everything render_chunk produces plus the
    dynamic/static induced fwd/bwd flows against neighbor poses and the
    weighted scene-flow displacement map (reference: renderer.py:400-560)."""

    def render_chunk_vis(params, packs, aabb, rays, ts, grid, pose_f, pose_b, focal) -> VisMaps:
        with torch.inference_mode():
            st, dn, out = _fields(params, packs, static_cfg, dynamic_cfg, aabb, rays, ts,
                                  ray_type, n_samples, step_size)
            delta_sum = torch.sum(out.weights_d[..., None] * (dn.xyz_prime - dn.pts_ref), dim=1)
            base = RenderMaps(out.rgb_full, out.depth_full, out.rgb_s, out.depth_s, out.rgb_d,
                              out.depth_d, out.dynamicness, delta_sum)
            sf_f, sf_b = dyn_fields.scene_flow(params["dynamic"], dn.pts_ref, ts, aabb)
            pts_f = dn.pts_ref + sf_f
            pts_b = dn.pts_ref + sf_b
            R = rays.shape[0]
            pf = pose_f[None].expand(R, 3, 4)
            pb = pose_b[None].expand(R, 3, 4)
            if_f, _ = induce_flow(H, W, focal, pf, out.weights_d, pts_f, grid, rays, ray_type)
            if_b, _ = induce_flow(H, W, focal, pb, out.weights_d, pts_b, grid, rays, ray_type)
            if_s_f, _ = induce_flow(H, W, focal, pf, out.weights_s, st.pts_ref, grid, rays,
                                    ray_type)
            if_s_b, _ = induce_flow(H, W, focal, pb, out.weights_s, st.pts_ref, grid, rays,
                                    ray_type)
            return VisMaps(base, if_f, if_b, if_s_f, if_s_b, delta_sum)

    render_chunk_vis.pack = _pack(static_cfg, dynamic_cfg)
    return render_chunk_vis


def rays_for_view(pose_c2w, focal, H: int, W: int, ray_type: str, device=None):
    """All-pixel rays [H·W, 6] for one camera (reference: renderer.py:359-372)."""
    pose = torch.as_tensor(np.asarray(pose_c2w, np.float32), device=device)
    dirs = get_ray_directions_blender(H, W, (focal, focal), device=device)
    rays_o, rays_d = get_rays(dirs, pose)
    if ray_type == "ndc":
        rays_o, rays_d = ndc_rays_blender(H, W, focal, 1.0, rays_o, rays_d)
    return torch.cat([rays_o, rays_d], -1)


def _chunks(N: int, chunk: int):
    return [slice(s, min(s + chunk, N)) for s in range(0, N, chunk)]


def _host(tensors):
    return [t.float().cpu().numpy() for t in tensors]


def render_image(render_chunk, params, aabb, pose_c2w, focal, t_value: float, H: int, W: int,
                 ray_type: str, chunk: int = 8192) -> Dict[str, np.ndarray]:
    """Render one frame; returns host numpy maps shaped [H, W, ...]."""
    with span("render.frame", t=float(t_value)):
        with torch.inference_mode():
            rays = rays_for_view(pose_c2w, focal, H, W, ray_type, device=aabb.device)
            N = rays.shape[0]
            ts = torch.full((N,), float(t_value), dtype=torch.float32, device=aabb.device)
            packs = render_chunk.pack(params)
            outs = [_host(render_chunk(params, packs, aabb, rays[sl], ts[sl]))
                    for sl in _chunks(N, chunk)]
        cat = RenderMaps(*(np.concatenate(xs, 0) for xs in zip(*outs)))
        return {
            "rgb": cat.rgb.reshape(H, W, 3),
            "depth": cat.depth.reshape(H, W),
            "rgb_s": cat.rgb_s.reshape(H, W, 3),
            "depth_s": cat.depth_s.reshape(H, W),
            "rgb_d": cat.rgb_d.reshape(H, W, 3),
            "depth_d": cat.depth_d.reshape(H, W),
            "blending": cat.blending.reshape(H, W),
            "delta_xyz": cat.delta_xyz.reshape(H, W, 3),
        }


def render_image_vis(render_chunk_vis, params, aabb, pose_c2w, pose_f, pose_b, focal,
                     t_value: float, H: int, W: int, ray_type: str,
                     chunk: int = 8192) -> Dict[str, np.ndarray]:
    """Render one frame in vis mode: render_image's maps plus induced-flow
    and Δxyz maps against the given neighbor poses."""
    dev = aabb.device
    with torch.inference_mode():
        rays = rays_for_view(pose_c2w, focal, H, W, ray_type, device=dev)
        jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        grid = torch.stack([ii, jj], -1).reshape(-1, 2)
        N = rays.shape[0]
        ts = torch.full((N,), float(t_value), dtype=torch.float32, device=dev)
        pf = torch.as_tensor(np.asarray(pose_f, np.float32), device=dev)
        pb = torch.as_tensor(np.asarray(pose_b, np.float32), device=dev)
        focal_t = torch.tensor(float(focal), dtype=torch.float32, device=dev)
        packs = render_chunk_vis.pack(params)
        outs = []
        for sl in _chunks(N, chunk):
            m = render_chunk_vis(params, packs, aabb, rays[sl], ts[sl], grid[sl], pf, pb,
                                 focal_t)
            outs.append(_host(list(m.base) + list(m[1:])))
    cat = [np.concatenate(xs, 0) for xs in zip(*outs)]
    b = RenderMaps(*cat[:8])
    if_f, if_b, if_s_f, if_s_b, delta_sum = cat[8:]
    return {
        "rgb": b.rgb.reshape(H, W, 3),
        "depth": b.depth.reshape(H, W),
        "rgb_s": b.rgb_s.reshape(H, W, 3),
        "depth_s": b.depth_s.reshape(H, W),
        "rgb_d": b.rgb_d.reshape(H, W, 3),
        "depth_d": b.depth_d.reshape(H, W),
        "blending": b.blending.reshape(H, W),
        "induced_flow_f": if_f.reshape(H, W, 2),
        "induced_flow_b": if_b.reshape(H, W, 2),
        "induced_flow_s_f": if_s_f.reshape(H, W, 2),
        "induced_flow_s_b": if_s_b.reshape(H, W, 2),
        "delta_xyz_sum": delta_sum.reshape(H, W, 3),
    }
