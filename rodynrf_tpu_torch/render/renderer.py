"""Image renderer: chunked dual-field rendering of full frames, dense branch
(port of rodynrf_tpu/render/renderer.py; reference renderer.py:24-144,
660-966).

A frame's rays go through one chunk function, chunk by chunk, under
`torch.inference_mode()`. Sampling is deterministic (no jitter, no white
fill). The gather tables are packed once per frame by `render_chunk.pack`,
in the configs' dtype and layout as the train step packs them ('auto' with
the render path's larger merged budget). Occupancy masks and compacted
rendering are a later slice of the port (ROADMAP.md queue 1, item 2:
compaction) and are refused.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.rays import get_ray_directions_blender, get_rays, ndc_rays_blender
from ..fields import dynamic as dyn_fields
from ..fields import static as stat_fields
from ..fields.config import FieldConfig
from ..ops.compositing import raw2outputs
from .flow import induce_flow
from .pipeline import eval_dynamic_field, eval_static_field
from .sampling import sample_xyz

_NO_MASK = ("rendering with an occupancy mask{} is not ported to rodynrf_tpu_torch yet "
            "(ROADMAP.md queue 1, item 2: compaction)")


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
            step_size):
    xyz, z_vals, ray_valid = sample_xyz(
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
):
    """The per-chunk render function (params, packs, aabb, rays, ts) ->
    RenderMaps, with `.pack(params)` building the frame's gather tables.
    `alpha_mask` and `compact` raise NotImplementedError."""
    if alpha_mask is not None:
        raise NotImplementedError(_NO_MASK.format(" (alpha mask)"))
    if compact:
        raise NotImplementedError(_NO_MASK.format(" (compact eval)"))

    def render_chunk(params, packs, aabb, rays, ts) -> RenderMaps:
        with torch.inference_mode():
            _, dn, out = _fields(params, packs, static_cfg, dynamic_cfg, aabb, rays, ts,
                                 ray_type, n_samples, step_size)
            delta = torch.mean(torch.abs(dn.xyz_prime - dn.pts_ref), dim=1)
            return RenderMaps(out.rgb_full, out.depth_full, out.rgb_s, out.depth_s,
                              out.rgb_d, out.depth_d, out.dynamicness, delta)

    render_chunk.pack = _pack(static_cfg, dynamic_cfg)
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
