"""Plain PyTorch model of the two recipes' fields, sampler and compositor.

A direct reading of the published RoDynRF model (facebookresearch/
robust-dynrf, models/tensoRF.py, models/tensorBase.py, renderer.py) in the
semantics the benchmark's configurations state: float32 parameters and
arithmetic, TF32 off, and plane and line texels read in bfloat16 where a
configuration states bf16 gather tables ("gather": "bfloat16"). Such a read
rounds each texel to bf16 and its gradient once, after a float32 sum; the
line interpolation's two weights are rounded to bf16 as well, and the
interpolation, MLPs and compositor stay float32.

Every grid is sampled directly from its [C, H, W] plane and [C, L] line
(align_corners bilinear and linear interpolation with zero padding, the
multiscale grids on the strided virtual grid plane[:, ::s, ::s]); there are
no packed tables and no hand-written kernels. `Model.matmul` is "float32",
or "tf32" for the lower-precision control: every matrix product of the
fields then rounds its two inputs to TF32's 10-bit mantissa first.

Imports nothing of the measured program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
DYN_STRIDES = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One field's widths and options (reference TensorBase.__init__)."""

    grid: Tuple[int, int, int]
    density_n_comp: Tuple[int, ...]
    app_n_comp: Tuple[int, ...]
    app_dim: int
    shading_mode: str
    fea_pe: int
    view_pe: int
    pos_pe: int
    featureC: int
    density_shift: float
    fea2dense_act: str
    distance_scale: float
    ray_march_weight_thres: float
    bf16: bool


@dataclasses.dataclass(frozen=True)
class Model:
    static: FieldSpec
    dynamic: FieldSpec
    ray_type: str
    near_far: Tuple[float, float]
    n_samples: int
    step_size: float
    H: int
    W: int
    T: int
    matmul: str = "float32"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    kept in float32; the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    r = torch.where(torch.isfinite(x.detach()), r, x.detach())
    return x + (r - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, model: Model) -> torch.Tensor:
    if model.matmul == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def linear(p, x, model: Model):
    return mm(x, p["w"], model) + p["b"]


def mlp(layers, x, model: Model):
    for i, p in enumerate(layers):
        x = linear(p, x, model)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """sin/cos positional encoding, (d, f) row-major (tensorBase.py:13-19)."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


# ---------------------------------------------------------------------------
# parameter shapes (the benchmark makes the weights from these)
# ---------------------------------------------------------------------------

def shading_dims(mode: str, app_dim: int, view_pe: int, fea_pe: int, pos_pe: int,
                 featureC: int):
    """{name: [layer widths]} of a shading head (tensorBase.py:37-278)."""
    if mode == "MLP_Fea":
        return {"mlp": [2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim, featureC,
                        featureC, 3]}
    if mode in ("MLP_Fea_TimeEmbedding", "MLP_Fea_late_view"):
        in_c = 2 * fea_pe * app_dim + app_dim
        if mode == "MLP_Fea_late_view":
            in_c += 2 * 10 * 3 + 3 + 2 * 8 + 1
        return {"mlp": [in_c, featureC, featureC], "mlp_view": [featureC + 2 * view_pe * 3 + 3, 3]}
    raise ValueError(f"shading mode {mode} is not in the benchmark's configurations")


def head_in(spec: FieldSpec) -> int:
    return sum(spec.density_n_comp) * len(DYN_STRIDES) + 3 + 60 + 1 + 16


def param_specs(model: Model):
    """[(path, shape, kind, bound)] of every leaf, in the parameter tree's
    order: kind "normal" (0.1 * N(0, 1), the VM grids), "uniform" (U(±bound),
    torch.nn.Linear's init) or "zero" (the shading heads' last bias)."""
    out = []

    def vm(prefix, name, comps, grid):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            out.append((prefix + (f"{name}_plane", i), (comps[i], grid[m1], grid[m0]), "normal", 0.1))
        for i in range(3):
            out.append((prefix + (f"{name}_line", i), (comps[i], grid[VEC_MODE[i]]), "normal", 0.1))

    def layers(prefix, dims, zero_last=False):
        for i in range(len(dims) - 1):
            bound = 1.0 / math.sqrt(dims[i])
            out.append((prefix + (i, "w"), (dims[i], dims[i + 1]), "uniform", bound))
            last = zero_last and i == len(dims) - 2
            out.append((prefix + (i, "b"), (dims[i + 1],), "zero" if last else "uniform", bound))

    def shading(prefix, spec):
        dims = shading_dims(spec.shading_mode, spec.app_dim, spec.view_pe, spec.fea_pe,
                            spec.pos_pe, spec.featureC)
        for k, d in dims.items():
            layers(prefix + ("shading", k), d, zero_last=(k == "mlp_view" or spec.shading_mode
                                                          == "MLP_Fea"))

    s, d = model.static, model.dynamic
    vm(("static",), "density", s.density_n_comp, s.grid)
    vm(("static",), "app", s.app_n_comp, s.grid)
    n_app = sum(s.app_n_comp)
    out.append((("static", "basis_mat"), (n_app, s.app_dim), "uniform", 1.0 / math.sqrt(n_app)))
    shading(("static",), s)
    vm(("dynamic",), "density", d.density_n_comp, d.grid)
    vm(("dynamic",), "blending", d.density_n_comp, d.grid)
    vm(("dynamic",), "app", d.app_n_comp, d.grid)
    n_app = sum(d.app_n_comp) * len(DYN_STRIDES)
    out.append((("dynamic", "basis_mat"), (n_app, d.app_dim), "uniform", 1.0 / math.sqrt(n_app)))
    for name, fi, fo in (("warp_t1", 17, 64), ("warp_t2", 64, 30)):
        b = 1.0 / math.sqrt(fi)
        out.append((("dynamic", name, "w"), (fi, fo), "uniform", b))
        out.append((("dynamic", name, "b"), (fo,), "uniform", b))
    layers(("dynamic", "warp_xyz"), [3 + 60 + 30, 64, 64, 3])
    layers(("dynamic", "density_head"), [head_in(d), 64, 1])
    layers(("dynamic", "blending_head"), [head_in(d), 64, 1])
    layers(("dynamic", "scene_flow"), [36, 64, 64, 64, 6])
    shading(("dynamic",), d)
    return out


def build_tree(items):
    """[(path, tensor)] in tree order -> the nested dict / list tree."""
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    keys = list(dict.fromkeys(p[0] for p, _ in items))
    sub = {k: build_tree([(p[1:], t) for p, t in items if p[0] == k]) for k in keys}
    if all(isinstance(k, int) for k in keys):
        return [sub[k] for k in sorted(keys)]
    return sub


def leaves(tree, prefix=()):
    """(path, tensor) of a nested dict / list tree, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# grid sampling
# ---------------------------------------------------------------------------

def _rd(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A grid as read: rounded to bf16 (its gradient rounded once, after the
    float32 sum) or as it is."""
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


def _axis(u, n):
    g = (u + 1.0) * 0.5 * (n - 1)
    i0f = torch.floor(g)
    return g, i0f, i0f.to(torch.int64)


def plane_taps(xy, Hs: int, Ws: int):
    """The four bilinear corners of xy [N, 2] on an Hs x Ws grid: [(row ids
    [N], weights [N])] in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1),
    out-of-grid corners weighted 0 (zero padding)."""
    gx, x0f, x0 = _axis(xy[:, 0], Ws)
    gy, y0f, y0 = _axis(xy[:, 1], Hs)
    wx, wy = gx - x0f, gy - y0f
    valid = ((x0 >= -1) & (x0 <= Ws - 1) & (y0 >= -1) & (y0 <= Hs - 1)).to(xy.dtype)
    out = []
    for yi, xi, w in ((y0, x0, (1 - wy) * (1 - wx)), (y0, x0 + 1, (1 - wy) * wx),
                      (y0 + 1, x0, wy * (1 - wx)), (y0 + 1, x0 + 1, wy * wx)):
        inb = ((yi >= 0) & (yi <= Hs - 1) & (xi >= 0) & (xi <= Ws - 1)).to(xy.dtype)
        out.append((yi.clamp(0, Hs - 1) * Ws + xi.clamp(0, Ws - 1), w * valid, inb))
    return out


def line_taps(z, Ls: int, bf16: bool):
    """The two linear taps of z [N] on a length-Ls line: [(ids, weights
    [N, 1], in-grid [N, 1])]; with bf16 reads the weights are rounded to bf16
    (their gradient rounded once)."""
    g, i0f, i0 = _axis(z, Ls)
    i1 = i0 + 1
    if bf16:
        w0 = torch.clamp(1.0 - torch.abs(i0f - g), 0.0, 1.0).to(torch.bfloat16).to(z.dtype)
        w1 = torch.clamp(1.0 - torch.abs((i0f + 1.0) - g), 0.0, 1.0).to(torch.bfloat16).to(z.dtype)
    else:
        w1 = g - i0f
        w0 = 1 - w1
    return [(i.clamp(0, Ls - 1), w[:, None], ((i >= 0) & (i <= Ls - 1)).to(z.dtype)[:, None])
            for i, w in ((i0, w0), (i1, w1))]


def vm_feats(grids, xyz_n, strides, bf16: bool):
    """Features of several VM grids sampled at the same points: per grid
    [N, sum_o C_o * len(strides)], stride-major then orientation, each a
    bilinear plane value times a linear line value on the stride-s virtual
    grid plane[:, ::s, ::s] (align_corners, zero padding). With bf16 reads
    every stride's texels are rounded to bf16 and the interpolation weights
    of a sample and axis are shared by the grids. grids: [(planes, lines)]."""
    out = [[] for _ in grids]
    for s in strides:
        for o in range(3):
            m0, m1 = MAT_MODE[o]
            xy, z = xyz_n[:, (m0, m1)], xyz_n[:, VEC_MODE[o]]
            _, H, W = grids[0][0][o].shape
            Hs, Ws = -(-H // s), -(-W // s)
            Ls = -(-grids[0][1][o].shape[1] // s)
            ptaps = plane_taps(xy, Hs, Ws)
            ltaps = line_taps(z, Ls, bf16)
            for gi, (planes, lines) in enumerate(grids):
                p = _rd(planes[o][:, ::s, ::s], bf16)
                flat = p.reshape(p.shape[0], Hs * Ws).t()
                pf = None
                for idx, w, inb in ptaps:
                    term = (flat.index_select(0, idx) * inb[:, None]) * w[:, None]
                    pf = term if pf is None else pf + term
                lt = _rd(lines[o][:, ::s], bf16).t()
                v = [lt.index_select(0, i) * ib for i, _, ib in ltaps]
                lf = v[0] * ltaps[0][1] + v[1] * ltaps[1][1]
                out[gi].append(pf * lf)
    return [torch.cat(chunks, dim=-1) for chunks in out]


def normalize(xyz, aabb):
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def feature2density(feat, spec: FieldSpec):
    if spec.fea2dense_act == "softplus":
        return torch.nn.functional.softplus(feat + spec.density_shift)
    if spec.fea2dense_act == "relu":
        return torch.relu(feat)
    raise ValueError(spec.fea2dense_act)


def shade(p, spec: FieldSpec, pts, viewdirs, feats, time, model: Model):
    """The shading heads' forward (tensorBase.py:101-278)."""
    mode = spec.shading_mode
    if mode == "MLP_Fea":
        indata = [feats, viewdirs]
        if spec.fea_pe > 0:
            indata.append(pe(feats, spec.fea_pe))
        if spec.view_pe > 0:
            indata.append(pe(viewdirs, spec.view_pe))
        return torch.sigmoid(mlp(p["mlp"], torch.cat(indata, -1), model))
    indata = [feats]
    if spec.fea_pe > 0:
        indata.append(pe(feats, spec.fea_pe))
    vd = viewdirs
    if mode == "MLP_Fea_late_view":
        vd = viewdirs.detach()
        indata += [pts, pe(pts, 10), time, pe(time, 8)]
    view = [vd] + ([pe(vd, spec.view_pe)] if spec.view_pe > 0 else [])
    inter = torch.relu(mlp(p["mlp"], torch.cat(indata, -1), model))
    return torch.sigmoid(mlp(p["mlp_view"], torch.cat([inter] + view, -1), model))


def warp(p, xyz, t, aabb, model: Model):
    """Deformation warp (tensoRF.py:521-541): xyz + Δ(xyz, t)."""
    t_in = torch.cat([t[:, None], pe(t[:, None], 8)], -1)
    t_code = linear(p["warp_t2"], torch.relu(linear(p["warp_t1"], t_in, model)), model)
    xyz_n = normalize(xyz, aabb)
    return xyz + mlp(p["warp_xyz"], torch.cat([xyz_n, pe(xyz_n, 10), t_code], -1), model)


def scene_flow(p, pts, t, aabb, model: Model):
    """Forward / backward scene flow at [R, S, 3] points (tensoRF.py:446-462)."""
    R, S, _ = pts.shape
    n = normalize(pts.reshape(-1, 3), aabb)
    tt = t[:, None].expand(R, S).reshape(-1, 1)
    sf = mlp(p["scene_flow"], torch.cat([n, pe(n, 4), tt, pe(tt, 4)], -1), model)
    sf = sf.reshape(R, S, 6)
    return sf[..., 0:3], sf[..., 3:6]


# ---------------------------------------------------------------------------
# field evaluation over [R, S] samples
# ---------------------------------------------------------------------------

class FieldEval(NamedTuple):
    blending: Optional[torch.Tensor]
    pts_ref: torch.Tensor
    weights: torch.Tensor
    xyz_prime: Optional[torch.Tensor]
    rgb: torch.Tensor
    sigma: torch.Tensor
    z_vals: torch.Tensor
    dists: torch.Tensor

    def detach(self):
        return FieldEval(*(None if v is None else v.detach() for v in self))


def dists_viewdirs(rays, z_vals, ray_type):
    viewdirs = rays[:, 3:6]
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], -1)
    if ray_type in ("ndc", "contract"):
        norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
        dists = dists * norm
        viewdirs = viewdirs / norm
    return dists, viewdirs


def transmittance(alpha, eps: float = 1e-10):
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + eps], dim=-1)
    return torch.cumprod(shifted, dim=-1)


def raw2weights(sigma, dists):
    alpha = 1.0 - torch.exp(-sigma * dists)
    return alpha * transmittance(alpha)


def eval_static(p, model: Model, aabb, rays, ts, xyz, z_vals, valid) -> FieldEval:
    spec = model.static
    R, S, _ = xyz.shape
    dists, viewdirs = dists_viewdirs(rays, z_vals, model.ray_type)
    dists = dists * spec.distance_scale
    flat = normalize(xyz, aabb).reshape(-1, 3)
    dens_f, app_f = vm_feats([(p["density_plane"], p["density_line"]),
                              (p["app_plane"], p["app_line"])], flat, (1,), spec.bf16)
    sigma_feat = torch.zeros(flat.shape[0], dtype=flat.dtype, device=flat.device)
    c0 = 0
    for c in spec.density_n_comp:
        sigma_feat = sigma_feat + torch.sum(dens_f[:, c0:c0 + c], dim=-1)
        c0 += c
    app = mm(app_f, p["basis_mat"], model)
    sigma = torch.where(valid, feature2density(sigma_feat.reshape(R, S), spec), 0.0)
    weight = raw2weights(sigma, dists)
    vd = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    t_in = ts[:, None].expand(R, S).reshape(-1, 1)
    rgb = shade(p["shading"], spec, flat, vd, app, t_in, model).reshape(R, S, 3)
    rgb = torch.where((weight > spec.ray_march_weight_thres)[..., None], rgb, 0.0)
    return FieldEval(None, xyz, weight, None, rgb, sigma, z_vals, dists)


def eval_dynamic(p, model: Model, aabb, rays, ts, xyz, z_vals, valid) -> FieldEval:
    spec = model.dynamic
    R, S, _ = xyz.shape
    dists, viewdirs = dists_viewdirs(rays, z_vals, model.ray_type)
    dists = dists * spec.distance_scale
    xyz_flat = xyz.reshape(-1, 3)
    xyz_n = normalize(xyz_flat, aabb)
    t_flat = ts[:, None].expand(R, S).reshape(-1)
    xyz_prime = warp(p, xyz_flat, t_flat, aabb, model)
    dens_f, blend_f, app_f = vm_feats(
        [(p["density_plane"], p["density_line"]), (p["blending_plane"], p["blending_line"]),
         (p["app_plane"], p["app_line"])], normalize(xyz_prime, aabb), DYN_STRIDES, spec.bf16)
    tail = [xyz_n, pe(xyz_n, 10), t_flat[:, None], pe(t_flat[:, None], 8)]
    sigma_feat = mlp(p["density_head"], torch.cat([dens_f] + tail, -1), model)[..., 0]
    blend_feat = mlp(p["blending_head"], torch.cat([blend_f] + tail, -1), model)[..., 0]
    app = mm(app_f, p["basis_mat"], model)
    sigma = torch.where(valid, feature2density(sigma_feat.reshape(R, S), spec), 0.0)
    weight = raw2weights(sigma, dists)
    vd = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    rgb = shade(p["shading"], spec, xyz_n, vd, app, t_flat[:, None], model).reshape(R, S, 3)
    rgb = torch.where((weight > spec.ray_march_weight_thres)[..., None], rgb, 0.0)
    blending = torch.where(valid, torch.sigmoid(blend_feat.reshape(R, S)), 0.0)
    return FieldEval(blending, xyz, weight, xyz_prime.reshape(R, S, 3), rgb, sigma, z_vals,
                     dists)


# ---------------------------------------------------------------------------
# rays, spaces and the sampler
# ---------------------------------------------------------------------------

def pose_to_mtx(pose9):
    """6D rotation + translation -> [..., 3, 4] (Gram-Schmidt)."""
    b1 = pose9[..., 0:3]
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = pose9[..., 3:6] - torch.sum(b1 * pose9[..., 3:6], dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3, pose9[..., 6:9]], dim=-1)


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def rays_lean(dirs, c2w, H, W, focal, ray_type):
    rays_d = torch.einsum("bi,bji->bj", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, :3, 3]
    if ray_type == "ndc":
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return torch.cat([rays_o, rays_d], -1)


def pixel_rays(i, j, focal, c2w, H, W, ray_type):
    """Rays through pixel centres (col i, row j) of per-ray cameras."""
    i = i.to(focal.dtype) + 0.5
    j = j.to(focal.dtype) + 0.5
    dirs = torch.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -torch.ones_like(i)], -1)
    return rays_lean(dirs, c2w, H, W, focal, ray_type)


def uv_rays(uv, c2w, focal, H, W, ray_type):
    """Rays through flow-displaced pixel coordinates uv [R, 2]."""
    dirs = torch.stack([(uv[..., 0] - W / 2) / focal, -(uv[..., 1] - H / 2) / focal,
                        -torch.ones_like(uv[..., 0])], -1)
    return rays_lean(dirs, c2w, H, W, focal, ray_type)


def contract(pts):
    norm = torch.amax(torch.abs(pts), dim=-1, keepdim=True)
    safe = torch.clamp(norm, min=1e-9)
    return torch.where(norm > 1.0, (2.0 - 1.0 / safe) * (pts / safe), pts)


def contract2world(pts):
    norm = torch.amax(torch.abs(pts), dim=-1, keepdim=True)
    safe = torch.clamp(norm, min=1e-9)
    return torch.where(norm > 1.0, pts / safe * (-1.0 / (norm - 2.0)), pts)


def ndc2world(pts, H, W, f):
    z = 2.0 / (torch.clamp(pts[..., 2:], -1.0, 1.0 - 1e-6) - 1.0)
    return torch.cat([-pts[..., 0:1] * z * W / 2.0 / f, -pts[..., 1:2] * z * H / 2.0 / f, z], -1)


def world2ndc(p, H, W, f):
    return torch.cat([-1.0 / (W / (2.0 * f)) * p[..., 0:1] / p[..., 2:],
                      -1.0 / (H / (2.0 * f)) * p[..., 1:2] / p[..., 2:],
                      1.0 + 2.0 / p[..., 2:]], -1)


def _jitter(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=torch.float32).to(like.device, like.dtype)


def sample_points(model: Model, rays, aabb, gen=None):
    """(xyz [R, S, 3], z_vals [R, S], valid [R, S]) (tensorBase.py:487-559):
    NDC rays uniform in [near, far] with one jitter shared by every ray;
    contract rays inner uniform to 2 and outer inverse-distance to far."""
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    near, far = model.near_far
    S = model.n_samples
    if model.ray_type == "ndc":
        z = torch.linspace(near, far, S, device=rays.device, dtype=rays.dtype)[None]
        if gen is not None:
            z = z + _jitter(gen, z.shape, rays) * ((far - near) / S)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
        inb = torch.all((pts >= aabb[0]) & (pts <= aabb[1]), dim=-1)
        return pts, z.expand(rays.shape[0], S), inb
    if model.ray_type != "contract":
        raise ValueError(f"ray type {model.ray_type} is not in the benchmark's configurations")
    inner_n, outer_n = S - S // 2, S // 2
    zi = torch.linspace(near, 2.0, inner_n + 1, device=rays.device, dtype=rays.dtype)[None]
    if gen is not None:
        jit = _jitter(gen, zi.shape, rays) * ((2.0 - near) / inner_n)
        zi = torch.cat([zi[:, :-1] + jit[:, :-1], zi[:, -1:]], -1)
    zi = (zi[:, 1:] + zi[:, :-1]) * 0.5
    rng = torch.arange(outer_n + 1, dtype=rays.dtype, device=rays.device)[None]
    if gen is not None:
        jit = _jitter(gen, rng.shape, rays)
        rng = torch.cat([rng[:, :-1] + jit[:, :-1], rng[:, -1:]], -1)
    rng = torch.flip(rng, dims=(1,))
    rng = (rng[:, 1:] + rng[:, :-1]) * 0.5
    zo = 1.0 / (1.0 / far + (1.0 / 2.0 - 1.0 / far) * rng / outer_n)
    z = torch.cat([zi, zo], -1)
    pts = contract(rays_o[..., None, :] + rays_d[..., None, :] * z[..., None])
    z = z.expand(rays.shape[0], S)
    return pts, z, torch.ones_like(z, dtype=torch.bool)


# ---------------------------------------------------------------------------
# compositing and induced flow
# ---------------------------------------------------------------------------

class Outputs(NamedTuple):
    rgb_full: torch.Tensor
    depth_full: torch.Tensor
    rgb_s: torch.Tensor
    depth_s: torch.Tensor
    weights_s: torch.Tensor
    rgb_d: torch.Tensor
    depth_d: torch.Tensor
    weights_d: torch.Tensor
    dynamicness: torch.Tensor


def _depth_tail(depth, acc, rays, ray_type, relu=False):
    rest = torch.relu(1.0 - acc) if relu else 1.0 - acc
    if ray_type == "ndc":
        return depth + rest * (rays[..., 2] + rays[..., -1])
    return depth + rest * 256.0


def static_side(rgb_s, sigma_s, dists, z_vals, rays, ray_type, white):
    weights_s = raw2weights(sigma_s, dists)
    rgb = torch.sum(weights_s[..., None] * rgb_s, -2)
    acc = torch.sum(weights_s, -1)
    if white:
        rgb = rgb + (1.0 - acc[..., None])
    depth = _depth_tail(torch.sum(weights_s * z_vals, -1), acc, rays, ray_type)
    return torch.clamp(rgb, 0.0, 1.0), depth, weights_s


def dynamic_weights(sigma_d, dists):
    w = raw2weights(sigma_d, dists)
    return w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-10)


def composite(st: FieldEval, dn: FieldEval, rays, ray_type, white) -> Outputs:
    """Dual-field compositing (renderer.py:173-315)."""
    sigma_d, sigma_s, dists, blending, z_vals = dn.sigma, st.sigma, dn.dists, dn.blending, dn.z_vals
    alpha_d = 1.0 - torch.exp(-sigma_d * dists)
    alpha_s = 1.0 - torch.exp(-sigma_s * dists)
    T_d, T_s = transmittance(alpha_d), transmittance(alpha_s)
    mix = (1.0 - alpha_d * blending) * (1.0 - alpha_s * (1.0 - blending))
    T_full = torch.cumprod(torch.cat([torch.ones_like(alpha_d[:, :1]), mix[:, :-1] + 1e-10], -1),
                           dim=-1)
    weights_d = alpha_d * T_d
    weights_s = alpha_s * T_s
    weights_d = weights_d / torch.clamp(torch.sum(weights_d, -1, keepdim=True), min=1e-10)
    weights_full = (alpha_d * blending + alpha_s * (1.0 - blending)) * T_full
    rgb_d = torch.sum(weights_d[..., None] * dn.rgb, -2)
    rgb_s = torch.sum(weights_s[..., None] * st.rgb, -2)
    rgb_full = torch.sum((T_full * alpha_d * blending)[..., None] * dn.rgb
                         + (T_full * alpha_s * (1.0 - blending))[..., None] * st.rgb, -2)
    acc_d, acc_s = torch.sum(weights_d, -1), torch.sum(weights_s, -1)
    acc_full = torch.sum(weights_full, -1)
    if white:
        rgb_d = rgb_d + (1.0 - acc_d[..., None])
        rgb_s = rgb_s + (1.0 - acc_s[..., None])
        rgb_full = rgb_full + torch.relu(1.0 - acc_full[..., None])
    return Outputs(
        torch.clamp(rgb_full, 0.0, 1.0),
        _depth_tail(torch.sum(weights_full * z_vals, -1), acc_full, rays, ray_type, relu=True),
        torch.clamp(rgb_s, 0.0, 1.0),
        _depth_tail(torch.sum(weights_s * z_vals, -1), acc_s, rays, ray_type),
        weights_s,
        torch.clamp(rgb_d, 0.0, 1.0),
        _depth_tail(torch.sum(weights_d * z_vals, -1), acc_d, rays, ray_type),
        weights_d,
        torch.sum(weights_full * blending, -1),
    )


def induce_flow(H, W, f, c2w, weights, pts, pts_2d, rays, ray_type):
    """Flow and NDC disparity of each ray's expected point seen from the
    neighbouring camera c2w [R, 3, 4] (renderer.py:1328-1392)."""
    w2c = torch.transpose(c2w[:, :3, :3], 1, 2)
    acc = torch.sum(weights, -1)[:, None]
    pts_map = torch.sum(weights[..., None] * pts, -2)
    if ray_type == "ndc":
        pts_map = pts_map + (1.0 - acc) * (rays[:, :3] + rays[:, 3:])
        world = ndc2world(pts_map, H, W, f)
    else:
        pts_map = pts_map + (1.0 - acc) * contract(rays[:, :3] + rays[:, 3:] * 256.0)
        world = contract2world(pts_map)
    world = world - c2w[..., 3]
    cam = torch.sum(world[..., None, :] * w2c[:, :3, :3], -1)
    plane = torch.cat([cam[..., 0:1] / (-cam[..., 2:]) * f + W * 0.5,
                       -cam[..., 1:2] / (-cam[..., 2:]) * f + H * 0.5], -1)
    return plane - pts_2d, world2ndc(cam, H, W, f)[:, 2:]
