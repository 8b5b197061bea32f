"""Plain PyTorch training step of the two recipes (reference train.py:
1032-2351): the seven render passes, every loss term, the backward and the
three Adam optimizers, on the benchmark's ray batches and draws.

Per micro-batch the passes are evaluated one after another in this order
(the draws of jitter and white-fill coins follow it): the shared train-ray
sample set, E (training rays, static field with gradient), A and B
(training rays at the training and a random time, both fields, E's static
evaluation detached), C and D (flow-warped neighbour rays, dynamic field),
and with pose optimisation F and G (pixel neighbours) and FF and BB
(flow-warped rays with live poses, static field). With `grad_accum` A > 1
the batch is split into A equal micro-batches whose gradients are averaged.

Imports nothing of the measured program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from . import model as M

FIELD_BETAS = (0.9, 0.99)
POSE_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class Weights:
    distortion_static: float
    distortion_dynamic: float
    monodepth_static: float
    monodepth_dynamic: float
    small_scene_flow: float
    smooth_scene_flow: float
    l1: float
    tv_density: float
    tv_app: float


@dataclasses.dataclass(frozen=True)
class Recipe:
    model: M.Model
    weights: Weights
    optimize_poses: bool
    optimize_focal: bool
    use_disp: bool
    n_iters: int
    upsamp_list: tuple
    lr_init: float
    lr_basis: float
    lr_decay_target_ratio: float
    grad_accum: int
    batch_size: int
    seed: int


# ---------------------------------------------------------------------------
# host schedules (train.py:81-93 sampler, 924-1009 and 2350-2610 rates)
# ---------------------------------------------------------------------------

class Sampler:
    """Shuffled epochs over every ray (train.py:81-93 SimpleSampler),
    permutations from numpy's default generator seeded with `seed`."""

    def __init__(self, total: int, batch: int, seed: int):
        self.total, self.batch, self.curr, self.ids = total, batch, total, None
        self.rng = np.random.default_rng(seed)

    def next(self) -> np.ndarray:
        self.curr += self.batch
        if self.curr + self.batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr:self.curr + self.batch]


def rates(r: Recipe, iteration: int) -> Dict[str, float]:
    """Learning rates in effect at `iteration`, replayed from iteration 0:
    exponential decay of the field rates, reset at each upsample; the pose
    rate reset at each upsample and decayed to 1e-5 by n_iters // 2; the
    focal rate from the fourth upsample on; both 0 past n_iters // 2."""
    factor = r.lr_decay_target_ratio ** (1.0 / r.n_iters)
    pose0, pose_end = 3e-3, 1e-5
    gamma = (pose_end / pose0) ** (1.0 / max(r.n_iters // 2 - r.upsamp_list[-1], 1))
    main, lr_pose, lr_focal = 1.0, (pose0 if r.optimize_poses else 0.0), 0.0
    for i in range(iteration):
        main *= factor
        if r.optimize_poses:
            lr_pose *= gamma
        if r.optimize_focal:
            lr_focal *= gamma
        if i > r.n_iters // 2:
            lr_pose = lr_focal = 0.0
        if i in r.upsamp_list:
            if r.optimize_poses:
                lr_pose = pose0
            if r.optimize_focal and i >= r.upsamp_list[3]:
                lr_focal = pose0
            main = 1.0
    return {"lr_spatial": r.lr_init * main, "lr_network": r.lr_basis * main,
            "lr_pose": lr_pose, "lr_focal": lr_focal}


# ---------------------------------------------------------------------------
# losses (train.py citations)
# ---------------------------------------------------------------------------

def mse(a, b):
    return torch.mean((a - b) ** 2)


def masked_l1(err, mask, denom: float = 1.0):
    return torch.sum(err * mask) / (torch.sum(mask) + 1e-8) / denom


def abs_plus(x):
    """|x| whose subgradient at 0 is +1."""
    return torch.where(x >= 0, x, -x)


def skewed_entropy(m):
    m = torch.clamp(m, 1e-6, 1.0 - 1e-6)
    m2 = m * m
    return torch.mean(-(m2 * torch.log(m2) + (1 - m2) * torch.log(1 - m2)))


def order_loss(depth_d, depth_s, dyn, ray_type):
    w = 1.0 - dyn
    if ray_type == "ndc":
        err = (depth_d - depth_s) ** 2
    else:
        err = (1.0 / (depth_d + 1e-6) - 1.0 / (depth_s + 1e-6)) ** 2
    return torch.sum(err * w) / (torch.sum(w) + 1e-8)


def _lower_median(x, valid):
    srt = torch.sort(torch.where(valid, x[None, :], torch.inf), dim=-1).values
    count = torch.sum(valid.to(torch.int64), dim=-1)
    idx = torch.div(torch.clamp(count - 1, min=0), 2, rounding_mode="floor")
    return torch.gather(srt, 1, idx[:, None])[:, 0]


def monodepth(depth, target, t_ref, T: int, extra=None):
    """Per-camera median/MAD-normalised depth loss (train.py:797-807,
    1635-1658), cameras with at most one ray skipped."""
    valid = t_ref[None, :] == torch.arange(T, device=depth.device)[:, None]
    if extra is not None:
        valid = valid & extra[None, :]
    v = valid.to(depth.dtype)
    n = torch.sum(v, dim=-1)
    nc = torch.clamp(n, min=1.0)
    td = _lower_median(depth, valid)[:, None]
    sd = (torch.sum(torch.abs(depth[None] - td) * v, dim=-1) / nc)[:, None]
    tg = _lower_median(target, valid)[:, None]
    sg_ = (torch.sum(torch.abs(target[None] - tg) * v, dim=-1) / nc)[:, None]
    per = torch.sum((((depth[None] - td) / (sd + 1e-10) - (target[None] - tg) / (sg_ + 1e-10))
                     ** 2) * v, dim=-1)
    use = n > 1.0
    return (torch.sum(torch.where(use, per, 0.0))
            / torch.clamp(torch.sum(torch.where(use, n, 0.0)), min=1.0))


def distortion(w, m, interval):
    """Σ_rays Σ_ij w_i w_j |m_i - m_j| + 1/3 Σ interval w² in prefix-sum form."""
    uni = (1.0 / 3.0) * torch.sum(interval * w * w)
    wm = w * m
    wc, wmc = torch.cumsum(w, dim=-1), torch.cumsum(wm, dim=-1)
    return 2.0 * torch.sum(wm[:, 1:] * wc[:, :-1] - w[:, 1:] * wmc[:, :-1]) + uni


def disp_smooth(depth, di, dj):
    inv = 1.0 / torch.clamp(depth, min=1e-6)
    return (torch.mean((inv - 1.0 / torch.clamp(di, min=1e-6)) ** 2)
            + torch.mean((inv - 1.0 / torch.clamp(dj, min=1e-6)) ** 2))


def tv_plane(p):
    C, H, W = p.shape
    return 2.0 * (torch.sum((p[:, 1:, :] - p[:, :-1, :]) ** 2) / (C * (H - 1) * W)
                  + torch.sum((p[:, :, 1:] - p[:, :, :-1]) ** 2) / (C * H * (W - 1)))


def tv_line(l):
    C, L = l.shape
    return 2.0 * torch.sum((l[:, 1:] - l[:, :-1]) ** 2) / (C * (L - 1))


def tv_vm(planes, lines):
    total = 0.0
    for p, l in zip(planes, lines):
        total = total + 1e-2 * tv_plane(p) + 1e-3 * tv_line(l)
    return total


def density_l1(planes, lines, spec):
    vol = (torch.einsum("cyx,cz->xyz", planes[0], lines[0])
           + torch.einsum("czx,cy->xyz", planes[1], lines[1])
           + torch.einsum("czy,cx->xyz", planes[2], lines[2]))
    return torch.mean(torch.abs(M.feature2density(vol, spec)))


def _pair(a, b, rays_a, rays_b):
    """a - b of a disparity pair; where both rays are one ray with one
    value the difference carries no gradient."""
    d = a - b
    one = (rays_a == rays_b).all(-1, keepdim=True) & (d == 0)
    return torch.where(one, d.detach(), d)


# ---------------------------------------------------------------------------
# the loss of one micro-batch
# ---------------------------------------------------------------------------

def train_loss(params, r: Recipe, aabb, data, ray_idx, ray_idx_rand, gen, it: int, focal_fixed):
    m = r.model
    H, W, T = m.H, m.W, m.T
    S = m.n_samples
    wts = r.weights
    sg = torch.Tensor.detach
    metrics = {}
    temp_static = 10.0 ** (-(it / 100000.0))
    temp = 10.0 ** (-(it // 100000.0))
    temp_disp_tv = 10.0 ** (-(it // 50000.0))
    after_u0 = float(it >= r.upsamp_list[0])
    after_u3 = float(it >= (r.upsamp_list[3] if len(r.upsamp_list) > 3 else r.upsamp_list[-1]))

    if r.optimize_focal:
        focal = max(H, W) / 2.0 / torch.tan(params["fov"][0, 0])
    else:
        focal = aabb.new_tensor(float(focal_fixed))
    poses = M.pose_to_mtx(params["pose"])

    rgb = data["rgbs"][ray_idx]
    ts = data["ts"][ray_idx]
    flow_f, flow_b = data["flows_f"][ray_idx], data["flows_b"][ray_idx]
    mask_f = data["flow_masks_f"][ray_idx][..., None]
    mask_b = data["flow_masks_b"][ray_idx][..., None]
    fg = data["fg_masks"][ray_idx]
    disps = data["disps"][ray_idx] if r.use_disp else None
    ts_rand = data["ts"][ray_idx_rand]

    i_px = ray_idx % W
    j_px = torch.div(ray_idx, W, rounding_mode="floor") % H
    view = torch.div(ray_idx, W * H, rounding_mode="floor")
    rays = M.pixel_rays(i_px, j_px, focal, poses[view], H, W, m.ray_type)
    grid = torch.stack([i_px, j_px], -1).to(aabb.dtype)
    t_ref = torch.div(ray_idx, H * W, rounding_mode="floor")
    u_ref = torch.div(ray_idx % (H * W), W, rounding_mode="floor")
    v_ref = (ray_idx % (H * W)) % W
    t_int = 2.0 / (T - 1)
    poses_f = torch.cat([poses[1:], poses[-1:]], 0)[t_ref]
    poses_b = torch.cat([poses[0:1], poses[:-1]], 0)[t_ref]
    rays_det, focal_det = sg(rays), sg(focal)
    uv = torch.stack([v_ref + 0.5, u_ref + 0.5], -1).to(aabb.dtype)
    rays_f = M.uv_rays(uv + flow_f, sg(poses_f), focal_det, H, W, m.ray_type)
    rays_b = M.uv_rays(uv + flow_b, sg(poses_b), focal_det, H, W, m.ray_type)

    def coin():
        return bool(torch.rand((), generator=gen) < 0.5)

    # draws: the coins of A, B, C, D and E, the shared train-ray jitter,
    # the coins of F and G, then each other pass's jitter as it is sampled
    white = {n: coin() for n in ("A", "B", "C", "D", "E")}
    live = M.sample_points(m, rays, aabb, gen)
    if r.optimize_poses:
        white["F"], white["G"] = coin(), coin()

    # E first (A and B reuse its static evaluation, detached)
    det = tuple(sg(x) for x in live)
    xyz_e, z_e, v_e = live
    stE = M.eval_static(params["static"], m, aabb, rays, ts, xyz_e, z_e, v_e)
    rgb_s_e, depth_s_e, w_s_e = M.static_side(stE.rgb, stE.sigma, stE.dists, z_e, rays,
                                              m.ray_type, white["E"])
    st_det = stE.detach()
    dnA = M.eval_dynamic(params["dynamic"], m, aabb, rays_det, ts, *det)
    outA = M.composite(st_det, dnA, rays_det, m.ray_type, white["A"])
    dnB = M.eval_dynamic(params["dynamic"], m, aabb, rays_det, ts_rand, *det)
    outB = M.composite(st_det, dnB, rays_det, m.ray_type, white["B"])

    def dyn_pass(rays_p, ts_p):
        xyz, z, v = M.sample_points(m, rays_p, aabb, gen)
        dn = M.eval_dynamic(params["dynamic"], m, aabb, rays_p, ts_p, xyz, z, v)
        return M.dynamic_weights(dn.sigma, dn.dists), dn

    wC, dnC = dyn_pass(sg(rays_f), ts + t_int)
    wD, dnD = dyn_pass(sg(rays_b), ts - t_int)

    total = after_u3 * 0.01 * (skewed_entropy(outB.dynamicness) + torch.mean(
        torch.abs(outB.dynamicness)))
    total = total + order_loss(outB.depth_d, sg(outB.depth_s), sg(outB.dynamicness),
                               m.ray_type) * 10.0
    if wts.distortion_dynamic > 0:
        total = total + distortion(outB.weights_d, sg(dnB.z_vals), 1.0 / S) * \
            wts.distortion_dynamic * (it / r.n_iters)

    sf_f, sf_b = M.scene_flow(params["dynamic"], dnA.pts_ref, ts, aabb, m)
    img_loss = mse(outA.rgb_full, rgb)
    metrics["mse"] = img_loss
    total = total + 3.0 * img_loss
    total = total + mse(outA.rgb_d, rgb)
    total = total + after_u0 * 0.1 * torch.mean(torch.abs(outA.dynamicness - fg)) * temp_disp_tv
    total = total + after_u3 * 0.01 * (skewed_entropy(outA.dynamicness)
                                       + torch.mean(torch.abs(outA.dynamicness)))
    if m.ray_type == "ndc":
        pts_f, pts_b = dnA.pts_ref + sf_f, dnA.pts_ref + sf_b
    else:
        pts_f = torch.clamp(dnA.pts_ref + sf_f, -2.0 + 1e-6, 2.0 - 1e-6)
        pts_b = torch.clamp(dnA.pts_ref + sf_b, -2.0 + 1e-6, 2.0 - 1e-6)
    ind_f, disp_f = M.induce_flow(H, W, focal_det, sg(poses_f), outA.weights_d, pts_f, grid,
                                  rays_det, m.ray_type)
    ind_b, disp_b = M.induce_flow(H, W, focal_det, sg(poses_b), outA.weights_d, pts_b, grid,
                                  rays_det, m.ray_type)
    total = total + 0.02 * (masked_l1(torch.abs(ind_f - flow_f), mask_f, 2.0)
                            + masked_l1(torch.abs(ind_b - flow_b), mask_b, 2.0)) * temp
    total = total + wts.small_scene_flow * (torch.mean(torch.abs(sf_f))
                                            + torch.mean(torch.abs(sf_b)))
    _, disp_ff = M.induce_flow(H, W, focal_det, sg(poses_f), wC, dnC.pts_ref, grid, sg(rays_f),
                               m.ray_type)
    total = total + 0.04 * masked_l1(abs_plus(_pair(disp_f, disp_ff, rays_det, rays_f)),
                                     mask_f) * temp
    _, disp_bb = M.induce_flow(H, W, focal_det, sg(poses_b), wD, dnD.pts_ref, grid, sg(rays_b),
                               m.ray_type)
    total = total + 0.04 * masked_l1(abs_plus(_pair(disp_b, disp_bb, rays_det, rays_b)),
                                     mask_b) * temp
    total = total + wts.smooth_scene_flow * torch.mean(torch.abs(sf_f + sf_b))
    if r.use_disp:
        if m.ray_type == "ndc":
            md = monodepth(outA.depth_d, -disps, t_ref, T)
        else:
            md = monodepth(1.0 / (outA.depth_d + 1e-6), disps, t_ref, T)
        total = total + md * wts.monodepth_dynamic * temp
    total = total + order_loss(outA.depth_d, sg(outA.depth_s), sg(outA.dynamicness),
                               m.ray_type) * 10.0
    if wts.distortion_dynamic > 0:
        dist = (distortion(outA.weights_d, sg(dnA.z_vals), 1.0 / S)
                + distortion(wC, sg(dnC.z_vals), 1.0 / S)
                + distortion(wD, sg(dnD.z_vals), 1.0 / S))
        total = total + dist * wts.distortion_dynamic * (it / r.n_iters)
    pd, ps = params["dynamic"], params["static"]
    tv_mult = (r.lr_decay_target_ratio ** (1.0 / r.n_iters)) ** (it + 1.0)
    if wts.l1 > 0:
        total = total + wts.l1 * density_l1(pd["density_plane"], pd["density_line"], m.dynamic)
    if wts.tv_density > 0:
        total = total + wts.tv_density * tv_mult * (
            tv_vm(pd["density_plane"], pd["density_line"])
            + tv_vm(pd["blending_plane"], pd["blending_line"]))
    if wts.tv_app > 0:
        total = total + wts.tv_app * tv_mult * tv_vm(pd["app_plane"], pd["app_line"])

    bg = 1.0 - fg[..., None]
    total = total + torch.sum(((rgb_s_e - rgb) ** 2) * bg) / (torch.sum(bg) + 1e-8) / 3.0
    if wts.distortion_static > 0:
        total = total + distortion(w_s_e, z_e, 1.0 / S) * wts.distortion_static * (
            it / r.n_iters)
    if wts.l1 > 0:
        total = total + wts.l1 * density_l1(ps["density_plane"], ps["density_line"], m.static)
    if wts.tv_density > 0:
        total = total + wts.tv_density * tv_mult * tv_vm(ps["density_plane"], ps["density_line"])
    if wts.tv_app > 0:
        total = total + wts.tv_app * tv_mult * tv_vm(ps["app_plane"], ps["app_line"])

    if r.optimize_poses:
        ind_f_s, disp_f_s = M.induce_flow(H, W, focal, poses_f, w_s_e, stE.pts_ref, grid, rays,
                                          m.ray_type)
        ind_b_s, disp_b_s = M.induce_flow(H, W, focal, poses_b, w_s_e, stE.pts_ref, grid, rays,
                                          m.ray_type)
        comb_f, comb_b = mask_f * bg, mask_b * bg
        total = total + 0.02 * (masked_l1(torch.abs(ind_f_s - flow_f), comb_f, 2.0)
                                + masked_l1(torch.abs(ind_b_s - flow_b), comb_b, 2.0)) * temp_static
        i_n = torch.clamp(i_px + 1, max=W - 1)
        j_n = torch.clamp(j_px + 1, max=H - 1)
        rays_F = M.pixel_rays(i_n, j_px, focal, poses[view], H, W, m.ray_type)
        rays_G = M.pixel_rays(i_px, j_n, focal, poses[view], H, W, m.ray_type)
        rays_ff = M.uv_rays(uv + flow_f, poses_f, focal, H, W, m.ray_type)
        rays_bb = M.uv_rays(uv + flow_b, poses_b, focal, H, W, m.ray_type)

        def stat_pass(rays_p, white_p):
            xyz, z, v = M.sample_points(m, rays_p, aabb, gen)
            st = M.eval_static(params["static"], m, aabb, rays_p, ts, xyz, z, v)
            if white_p is None:
                return None, st
            return M.static_side(st.rgb, st.sigma, st.dists, z, rays_p, m.ray_type, white_p), st

        outF, _ = stat_pass(rays_F, white["F"])
        outG, _ = stat_pass(rays_G, white["G"])
        _, stFF = stat_pass(rays_ff, None)
        _, stBB = stat_pass(rays_bb, None)
        _, disp_s_ff = M.induce_flow(H, W, focal, poses_f, stFF.weights, stFF.pts_ref, grid,
                                     rays_ff, m.ray_type)
        total = total + 0.04 * masked_l1(abs_plus(_pair(disp_f_s, disp_s_ff, rays, rays_ff)),
                                         comb_f) * temp_static
        _, disp_s_bb = M.induce_flow(H, W, focal, poses_b, stBB.weights, stBB.pts_ref, grid,
                                     rays_bb, m.ray_type)
        total = total + 0.04 * masked_l1(abs_plus(_pair(disp_b_s, disp_s_bb, rays, rays_bb)),
                                         comb_b) * temp_static
        if r.use_disp:
            bgv = fg < 0.5
            if m.ray_type == "ndc":
                md_s = monodepth(depth_s_e, -disps, t_ref, T, bgv)
            else:
                md_s = monodepth(1.0 / (depth_s_e + 1e-6), disps, t_ref, T, bgv)
            total = total + md_s * wts.monodepth_static * temp_static
        total = total + disp_smooth(depth_s_e, outF[1], outG[1]) * 50.0 * temp_disp_tv
    metrics["total_loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# optimisers and the step
# ---------------------------------------------------------------------------

def is_spatial(path) -> bool:
    return any(("plane" in str(n) or "line" in str(n)) for n in path)


def make_optimizers(params):
    fields = list(M.leaves({"static": params["static"], "dynamic": params["dynamic"]}))
    return {
        "fields": torch.optim.Adam(
            [{"params": [t for p, t in fields if is_spatial(p)], "lr": 0.0},
             {"params": [t for p, t in fields if not is_spatial(p)], "lr": 0.0}],
            betas=FIELD_BETAS, eps=ADAM_EPS),
        "pose": torch.optim.Adam([params["pose"]], lr=0.0, betas=POSE_BETAS, eps=ADAM_EPS),
        "fov": torch.optim.Adam([params["fov"]], lr=0.0, betas=POSE_BETAS, eps=ADAM_EPS),
    }


def step(params, opts, r: Recipe, aabb, data, ray_idx, ray_idx_rand, gen, it: int,
         focal_fixed) -> List[float]:
    """One optimisation step in place; returns [mean total loss, mean mse]
    over the micro-batches, and leaves each leaf's averaged gradient in
    `.grad` until the optimizers have stepped."""
    for _, t in M.leaves(params):
        t.grad = None
    A = max(1, r.grad_accum)
    loss = mse_ = 0.0
    for ri, rr in zip(ray_idx.reshape(A, -1), ray_idx_rand.reshape(A, -1)):
        total, mets = train_loss(params, r, aabb, data, ri, rr, gen, it, focal_fixed)
        (total / A if A > 1 else total).backward()
        loss += float(total.detach()) / A
        mse_ += float(mets["mse"].detach()) / A
        del total, mets
    for _, t in M.leaves(params):
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    lr = rates(r, it)
    spatial, network = opts["fields"].param_groups
    spatial["lr"], network["lr"] = lr["lr_spatial"], lr["lr_network"]
    opts["pose"].param_groups[0]["lr"] = lr["lr_pose"]
    opts["fov"].param_groups[0]["lr"] = lr["lr_focal"]
    for o in opts.values():
        o.step()
    return [loss, mse_]
