"""The training step: all render passes + every loss term (port of
rodynrf_tpu/train/step.py, the dense sequential store path).

Per iteration the static+dynamic field pair is evaluated over up to 7 ray
sets (SURVEY.md §3.1 passes A-G):

  A  training rays (detached)           -> RGB/mask/flow/monodepth losses
  B  novel-time rays (detached)         -> novel mask/order/distortion losses
  C  flow-warped fwd-neighbor rays      -> disparity consistency (fwd)
  D  flow-warped bwd-neighbor rays      -> disparity consistency (bwd)
  E  training rays (NOT detached)       -> static RGB + pose/focal gradients
  F  pixel (i+1) neighbor rays          -> disparity smoothness   (pose optim)
  G  pixel (j+1) neighbor rays          -> disparity smoothness   (pose optim)

The reference's detach topology is kept: every `lax.stop_gradient` of the
JAX step is a `.detach()` at the same site, and a fully detached static
evaluation runs under `torch.no_grad()`. Passes run one after another and
keep their activations for the backward (store mode), or, with `remat`,
recompute each field evaluation's activations in the backward. With
`fused_passes` the passes' rows are concatenated into batched field
evaluations instead (`_batched_passes`). With an occupancy mask
(`use_alpha_mask`) each pass's samples are masked by the mask's occupancy
bit and, with `compact_k`, compacted to a per-ray [R, K] bucket, optionally
evaluated through a flat bucket (`compact_flat`). With `grad_accum` > 1 the
ray batch is split into equal micro-batches whose gradients are averaged
before one optimizer update (`TrainStep.grads_and_metrics`). On a data mesh
(`mesh`, parallel/mesh.py) each rank evaluates the passes on its span of the
rays and gathers what the losses read; every rank computes the same global
loss, and the gradients are averaged over the ranks (mesh.py's gradient
rule).

The three Adam optimizers (fields, pose, fov) update the parameters in
place; their learning rates come from the host schedule on every step.

With the tracer on (utils/profiling), each sequential pass runs inside a
`train.pass` span and each field's grid regularizers inside a
`train.regularizers` span.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.rays import get_rays_lean, ids2pixel, make_rays, ndc_rays_blender
from ..core.se3 import pose_to_mtx
from ..device import check_device
from ..fields import dynamic as dyn_field
from ..fields import static as stat_field
from ..fields.alpha_mask import occupancy_nearest
from ..fields.config import FieldConfig
from ..ops.compositing import (
    RenderOutputs,
    dynamic_side_weights,
    raw2outputs,
    static_side_outputs,
)
from ..ops.distortion import eff_distloss
from ..ops.regularizers import line_orthogonality
from ..parallel.collectives import all_gather_dim, gather_rows_packed
from ..parallel.mesh import mesh_group, sync_gradients, working_copy
from ..parallel.multihost import process_span
from ..render.flow import induce_flow
from ..render.pipeline import (
    FieldEval,
    _dists_and_viewdirs,
    eval_dynamic_field,
    eval_static_field,
)
from ..render.sampling import sample_xyz
from ..utils.profiling import span
from . import losses as L


@dataclass(frozen=True)
class LossWeights:
    """Loss weights (reference flag defaults, opt.py:80-106)."""

    distortion_static: float = 0.0
    distortion_dynamic: float = 0.0
    monodepth_static: float = 0.04
    monodepth_dynamic: float = 0.04
    small_scene_flow: float = 0.1
    smooth_scene_flow: float = 0.1
    l1: float = 0.0
    ortho: float = 0.0
    tv_density: float = 0.0
    tv_app: float = 0.0


@dataclass(frozen=True)
class StepStatics:
    """Configuration of the train step (the JAX StepStatics fields the port
    implements)."""

    static_cfg: FieldConfig
    dynamic_cfg: FieldConfig
    H: int
    W: int
    n_cams: int
    n_samples: int
    ray_type: str = "ndc"
    optimize_poses: bool = False
    optimize_focal: bool = False
    use_disp: bool = True
    n_iters: int = 100000
    upsamp0: int = 2000
    upsamp3: int = 8000
    lr_factor: float = 1.0  # per-iteration TV-weight decay (train.py:1735, 1748)
    weights: LossWeights = LossWeights()
    step_size: float = 0.01  # world-sampler march step
    # golden-comparison mode: every stochastic draw takes the value the
    # reference harness patches torch.rand to (0.5): sampler jitter is a
    # constant half-bin shift and the white-fill coin always lands tails
    golden_det: bool = False
    # passes A/B/E share one sample set and A/B reuse E's static evaluation
    # detached (exact: the static field is time-invariant)
    share_forward: bool = True
    # train-time occupancy mask: each pass's ray_valid is ANDed with the
    # mask's nearest-voxel occupancy bit at (sample, t), the reference's
    # early-out (tensorBase.py:745-765) applied to training. The pre-dilated
    # volume rides flat in data["alpha_volume"] (uint8), its aabb in
    # data["alpha_aabb"], its (D, H, W, T) in alpha_shape. Passes sharing
    # one sample set (A/B/E) use the union of their per-time occupancies.
    use_alpha_mask: bool = False
    alpha_shape: tuple = ()
    # with use_alpha_mask: compact each pass's samples to its per-ray [R, K]
    # occupied bucket before the field evaluations; exact vs the
    # dense-masked step whenever every ray's occupied count is <= K, rays
    # beyond K drop their farthest occupied samples. 0 = dense.
    compact_k: int = 0
    # with compact_k: run each field evaluation's per-sample work on a flat
    # bucket of compact_flat × R slots holding only the occupied samples,
    # scattered back to [R, K]; exact vs the [R, K] step whenever the
    # batch's occupied count fits, overflow samples read as empty. 0 = off.
    compact_flat: int = 0
    # recompute each field evaluation's activations in the backward instead
    # of storing them (torch.utils.checkpoint); the same numbers
    remat: bool = False
    # batch the passes' field evaluations: one dynamic evaluation over the
    # dual and dyn-only passes, one detached and one gradient-carrying
    # static evaluation, one dual compositor; the same numbers up to float
    # reassociation (_batched_passes)
    fused_passes: bool = False
    # split the ray batch into this many equal micro-batches and average
    # their gradients and metrics before one optimizer update. Not the
    # full-batch step: the monodepth median/MAD normalisation and the flow
    # losses' mask-sum ratios are batch statistics, taken per micro-batch
    grad_accum: int = 1
    # with fused_passes: at most this many passes per batched dynamic
    # evaluation (0 = all in one)
    pass_chunk: int = 0
    # fill the RenderOutputs fields no loss reads with NaN instead of zeros,
    # so that a loss that reads one turns the total non-finite
    debug_nan_fill: bool = False
    # data parallelism over rays: the 1-D data mesh (a DeviceMesh) whose
    # ranks each evaluate a contiguous span of every pass's rays; None = one
    # process. grid_dims: ((leaf path, axis), ...) of the plane grids kept
    # sharded at rest over it (--shard_grids 1)
    mesh: Any = None
    grid_dims: tuple = ()


def focal_from_fov(fov, H: int, W: int):
    """(reference: train.py:1038-1041)."""
    return max(H, W) / 2.0 / torch.tan(fov)


def _rays_from_idx(ray_idx, poses_mtx, focal, S: StepStatics):
    """Pixel ids -> packed rays + per-ray pose/time index (train.py:1066-1088)."""
    H, W = S.H, S.W
    i, j, view_ids = ids2pixel(W, H, ray_idx)
    rays = make_rays(i, j, (focal, focal), (W / 2, H / 2), poses_mtx[view_ids], H, W, S.ray_type)
    return rays, i, j, view_ids


def _warped_pair(a, b, rays_a, rays_b):
    """a - b per ray of the four disparity pairs, detached where the two
    rays are one ray with one value. Ties between different rays are real
    (contract rays: two empty rays whose far points share their largest
    coordinate induce one disparity) and take `losses.abs_`'s +1, as in the
    JAX package; in the static pairs that tie reaches the poses and focal,
    in the dynamic ones no parameter (their rays, poses and focal are
    detached, and an empty ray's weights sit behind relu's zero
    derivative). But the last frame's forward neighbour and the first
    frame's backward one are the frame itself: the warped ray is then the
    training ray and, with one sample set, the two disparities are one
    function of the parameters, whose difference has no gradient; a +1 there
    would add only float32 rounding that depends on how the rays are split
    over ranks."""
    d = a - b
    one = (rays_a == rays_b).all(-1, keepdim=True) & (d == 0)
    return torch.where(one, d.detach(), d)


def _rays_from_uv(uv, pose_per_ray, focal, S: StepStatics):
    """Flow-displaced pixel coords -> rays (train.py:1433-1455)."""
    H, W = S.H, S.W
    dirs = torch.stack(
        [(uv[..., 0] - W / 2) / focal, -(uv[..., 1] - H / 2) / focal,
         -torch.ones_like(uv[..., 0])],
        -1,
    )
    rays_o, rays_d = get_rays_lean(dirs, pose_per_ray)
    if S.ray_type == "ndc":
        rays_o, rays_d = ndc_rays_blender(H, W, (focal, focal), 1.0, rays_o, rays_d)
    return torch.cat([rays_o, rays_d], -1)


class PassSpec(NamedTuple):
    """One render pass: ray set + time stamps + randomness + detach topology.

    mode — which field evaluations the pass's losses consume:
      "dual":     both fields + dual compositor            (A, B)
      "dyn":      dynamic field only, normalized weights_d  (C, D)
      "stat_out": static field + static-side compositor     (E, F, G)
      "stat":     static field only, no compositor          (FF, BB)
    gen — generator for the pass's sampler jitter (None: no jitter draw).
    white — the pass's white-fill coin (None: no fill).
    samp — optional (xyz, z_vals, ray_valid) shared with other passes, or
      with train-time compaction (xyz, z_vals, keep, dists) (`_unpack_samp`).
    static_from — reuse the named pass's static FieldEval, detached.
    """

    rays: Any
    ts: Any
    gen: Optional[torch.Generator]
    white: Optional[bool]
    detach_static: bool
    mode: str
    samp: Any = None
    static_from: Any = None


def _partial_outputs(like: torch.Tensor, R: int, nS: int, debug_nan: bool = False,
                     **filled) -> RenderOutputs:
    """A RenderOutputs with only the consumed fields filled; the rest are
    zeros of like's dtype and device (no loss reads them), or NaN with
    debug_nan (StepStatics.debug_nan_fill)."""
    fill = float("nan") if debug_nan else 0.0
    z_r = like.new_full((R,), fill)
    z_rs = like.new_full((R, nS), fill)
    z_r3 = like.new_full((R, 3), fill)
    defaults = dict(
        rgb_full=z_r3, depth_full=z_r, acc_full=z_r, weights_full=z_rs,
        rgb_s=z_r3, depth_s=z_r, acc_s=z_r, weights_s=z_rs,
        rgb_d=z_r3, depth_d=z_r, acc_d=z_r, weights_d=z_rs,
        dynamicness=z_r,
    )
    defaults.update(filled)
    return RenderOutputs(**defaults)


def _unpack_samp(samp):
    """samp is (xyz, z_vals, valid) or, with train-time compaction, (xyz,
    z_vals, valid, dists): compacted z_vals cannot give the dense
    consecutive-z dists, so they ride precomputed."""
    if len(samp) == 4:
        return samp
    xyz, z_vals, valid = samp
    return xyz, z_vals, valid, None


def _occupancy(data, xyz, ts, valid, alpha_shape):
    """valid & the mask's occupancy bit at each (sample, time): the
    reference's early-out (tensorBase.py:745-765) as a where-mask, on
    detached positions (a boolean carries no gradient). One gathered byte
    per sample from the pre-dilated volume (fields/alpha_mask
    .occupancy_nearest)."""
    R, S_ = valid.shape
    t_flat = ts[:, None].expand(R, S_).reshape(-1)
    occ = occupancy_nearest(data["alpha_volume"], data["alpha_aabb"],
                            xyz.detach().reshape(-1, 3), t_flat, shape=alpha_shape)
    return valid & occ.reshape(R, S_)


def _compact_samp(xyz, z_vals, occ, rays, ray_type, K: int):
    """Per-ray [R, K] occupied bucket: a stable argsort puts the occupied
    samples first in ascending z (transmittance order); slots past a ray's
    count carry keep = False, so sigma = blending = rgb = 0 there. Returns
    ((xyz_c, z_c, keep, dists_c), idx) with the dense consecutive-z dists
    gathered at idx; xyz, z and dists ride one packed [R, S, 5] gather."""
    dists, _ = _dists_and_viewdirs(rays, z_vals, ray_type)
    order = torch.argsort(torch.logical_not(occ).to(torch.uint8), dim=1, stable=True)
    idx = order[:, :K]
    count = occ.sum(dim=1)
    keep = torch.arange(K, device=occ.device)[None, :] < count[:, None]
    packed = torch.cat([xyz, z_vals[..., None], dists[..., None]], dim=-1)
    pk = torch.gather(packed, 1, idx[..., None].expand(-1, -1, 5))
    return (pk[..., :3], pk[..., 3], keep, pk[..., 4]), idx


def _eval(field_fn, remat: bool, *args, **kw) -> FieldEval:
    """One field evaluation; with remat its activations are dropped after
    the forward and recomputed in the backward. The gather tables come in
    built, so the recomputation never rebuilds them, and the evaluation
    draws nothing at random, so it recomputes the same values."""
    if remat:
        return checkpoint(field_fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
    return field_fn(*args, **kw)


def _dual_pass(params, S: StepStatics, aabb, sp: PassSpec, packs, shared_st=None):
    """Sampler + static field + dynamic field + compositor for one ray set.
    packs: (packed_static, packed_dynamic) gather tables built once per step."""
    packed_st, packed_dn = packs
    rays, ts = sp.rays, sp.ts
    if sp.samp is not None:
        xyz, z_vals, ray_valid, dists_pre = _unpack_samp(sp.samp)
    else:
        xyz, z_vals, ray_valid = sample_xyz(
            rays, S.n_samples, S.ray_type, S.static_cfg.near_far, aabb, S.step_size,
            sp.gen, det_jitter=S.golden_det,
        )
        dists_pre = None
    R, nS = z_vals.shape
    # flat-bucket evals apply only on compacted geometry (dists_pre marks it)
    flat_n, flat_base = _flat_args(S, [ray_valid], dists_pre is not None)

    def run_dynamic():
        return _eval(
            eval_dynamic_field, S.remat, params["dynamic"], S.dynamic_cfg, aabb, rays, ts, xyz,
            z_vals, ray_valid, S.ray_type, packed=packed_dn, dists=dists_pre, flat_n=flat_n,
            flat_base=flat_base,
        )

    if sp.mode == "dyn":
        dn = run_dynamic()
        out = _partial_outputs(rays, R, nS, S.debug_nan_fill,
                               weights_d=dynamic_side_weights(dn.sigma, dn.dists))
        return out, None, dn, z_vals

    if shared_st is not None:
        st = shared_st.detach()
    elif sp.detach_static:
        # the reference's .detach() of static rgb/sigma in A-D: no gradient
        # reaches the static field, the rays or the samples
        with torch.no_grad():
            st = eval_static_field(
                params["static"], S.static_cfg, aabb, rays, ts, xyz, z_vals, ray_valid,
                S.ray_type, packed=packed_st, dists=dists_pre, flat_n=flat_n,
                flat_base=flat_base,
            )
    else:
        st = _eval(
            eval_static_field, S.remat, params["static"], S.static_cfg, aabb, rays, ts, xyz,
            z_vals, ray_valid, S.ray_type, packed=packed_st, dists=dists_pre, flat_n=flat_n,
            flat_base=flat_base,
        )

    if sp.mode == "stat":
        return None, st, None, z_vals

    if sp.mode == "stat_out":
        rgb_s, depth_s, acc_s, weights_s = static_side_outputs(
            st.rgb, st.sigma, st.dists, st.z_vals, rays,
            is_train=True, ray_type=S.ray_type, white=sp.white,
        )
        out = _partial_outputs(rays, R, nS, S.debug_nan_fill, rgb_s=rgb_s, depth_s=depth_s,
                               acc_s=acc_s, weights_s=weights_s)
        return out, st, None, z_vals

    dn = run_dynamic()
    out = raw2outputs(
        st.rgb, st.sigma, dn.rgb, dn.sigma, dn.dists, dn.blending, dn.z_vals, rays,
        is_train=True, ray_type=S.ray_type, white=sp.white,
    )
    return out, st, dn, z_vals


def _pass_order(specs):
    """The passes in evaluation order: static-eval providers
    (PassSpec.static_from) before their consumers, the given order
    otherwise. Jitter is drawn in this order on both paths."""
    providers = {sp.static_from for sp in specs.values() if sp.static_from}
    return [n for n in specs if n in providers] + [n for n in specs if n not in providers]


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _cat_evals(evs) -> FieldEval:
    return FieldEval(*(None if vs[0] is None else _cat(list(vs)) for vs in zip(*evs)))


def _slice_eval(ev: FieldEval, i0: int, i1: int) -> FieldEval:
    return FieldEval(*(None if v is None else v[i0:i1] for v in ev))


def _batched_passes(params, S: StepStatics, aabb, specs, packs):
    """All passes through batched field evaluations: the passes' rows are
    concatenated and evaluated as
      * one dynamic evaluation over the passes that need it (duals A/B and
        dyn-only C/D), in chunks of at most `pass_chunk` passes;
      * one fully detached static evaluation over the detach_static duals
        that do not reuse another pass's (none under share_forward);
      * one gradient-carrying static evaluation over E/F/G and FF/BB;
      * one dual compositor over the dual passes, each pass's white-fill
        coin broadcast over its rows; dyn and stat_out passes get the
        dynamic-side and static-side compositor subsets.
    The detach topology, the per-pass draws and every per-row number are
    the sequential path's; one table-gradient call sums what the sequential
    path sums over several, in another order."""
    packed_st, packed_dn = packs
    names = list(specs)
    dyn_names = [n for n in names if specs[n].mode in ("dual", "dyn")]
    dual_names = [n for n in names if specs[n].mode == "dual"]
    det_names = [n for n in dual_names
                 if specs[n].detach_static and specs[n].static_from is None]
    grad_names = [n for n in names
                  if (specs[n].mode == "dual" and not specs[n].detach_static)
                  or specs[n].mode in ("stat_out", "stat")]
    if dual_names != dyn_names[:len(dual_names)]:
        raise ValueError("dual passes must precede dyn-only passes")

    # per-pass geometry, drawn in the sequential path's order;
    # (xyz, z_vals, valid, dists or None) as _unpack_samp gives it
    samp = {}
    for n in _pass_order(specs):
        sp = specs[n]
        samp[n] = _unpack_samp(sp.samp) if sp.samp is not None else sample_xyz(
            sp.rays, S.n_samples, S.ray_type, S.static_cfg.near_far, aabb, S.step_size,
            sp.gen, det_jitter=S.golden_det,
        ) + (None,)
    R = {n: specs[n].rays.shape[0] for n in names}

    def group(grp):
        """The concatenated inputs of one evaluation; precomputed dists are
        all or nothing (train-time compaction sets them for every pass)."""
        rays = _cat([specs[n].rays for n in grp])
        dists = None if samp[grp[0]][3] is None else _cat([samp[n][3] for n in grp])
        # flat-bucket evals on compacted geometry only, sized by the rows
        flat_n, flat_base = _flat_args(S, [samp[n][2] for n in grp], dists is not None)
        return dict(rays=rays, ts=_cat([specs[n].ts for n in grp]),
                    xyz=_cat([samp[n][0] for n in grp]), z_vals=_cat([samp[n][1] for n in grp]),
                    ray_valid=_cat([samp[n][2] for n in grp]), dists=dists, flat_n=flat_n,
                    flat_base=flat_base)

    def evaluate(field_fn, p, cfg, packed, g, remat):
        return _eval(field_fn, remat, p, cfg, aabb, g["rays"], g["ts"], g["xyz"], g["z_vals"],
                     g["ray_valid"], S.ray_type, packed=packed, dists=g["dists"],
                     flat_n=g["flat_n"], flat_base=g["flat_base"])

    def split(ev, grp, out):
        off = 0
        for n in grp:
            out[n] = _slice_eval(ev, off, off + R[n])
            off += R[n]

    # dynamic: the chunks run one after another in eager order, so their
    # gathered rows are never live together (what the JAX package's
    # optimization_barrier chain enforces on XLA's schedule)
    chunk = S.pass_chunk if 0 < S.pass_chunk < len(dyn_names) else len(dyn_names)
    dn_all = _cat_evals([
        evaluate(eval_dynamic_field, params["dynamic"], S.dynamic_cfg, packed_dn,
                 group(dyn_names[i:i + chunk]), S.remat)
        for i in range(0, len(dyn_names), chunk)
    ])
    dn_by_name = {}
    split(dn_all, dyn_names, dn_by_name)

    st_by_name = {}
    if det_names:
        with torch.no_grad():
            split(evaluate(eval_static_field, params["static"], S.static_cfg, packed_st,
                           group(det_names), False), det_names, st_by_name)
    if grad_names:
        split(evaluate(eval_static_field, params["static"], S.static_cfg, packed_st,
                       group(grad_names), S.remat), grad_names, st_by_name)
    for n in names:
        if specs[n].static_from is not None:
            st_by_name[n] = st_by_name[specs[n].static_from].detach()

    res = {}
    if dual_names:
        n_dual = sum(R[n] for n in dual_names)
        dn_dual = _slice_eval(dn_all, 0, n_dual)
        white = None
        if not S.golden_det:
            white = torch.cat([torch.full((R[n],), bool(specs[n].white), dtype=torch.bool,
                                          device=dn_dual.sigma.device) for n in dual_names])
        out_all = raw2outputs(
            _cat([st_by_name[n].rgb for n in dual_names]),
            _cat([st_by_name[n].sigma for n in dual_names]),
            dn_dual.rgb, dn_dual.sigma, dn_dual.dists, dn_dual.blending, dn_dual.z_vals,
            _cat([specs[n].rays for n in dual_names]),
            is_train=True, ray_type=S.ray_type, white=white,
        )
        off = 0
        for n in dual_names:
            res[n] = (RenderOutputs(*(v[off:off + R[n]] for v in out_all)), st_by_name[n],
                      dn_by_name[n], samp[n][1])
            off += R[n]
    for n in names:
        sp, z_vals = specs[n], samp[n][1]
        if sp.mode == "dyn":
            dn = dn_by_name[n]
            res[n] = (_partial_outputs(sp.rays, R[n], z_vals.shape[1], S.debug_nan_fill,
                                       weights_d=dynamic_side_weights(dn.sigma, dn.dists)),
                      None, dn, z_vals)
        elif sp.mode == "stat_out":
            st = st_by_name[n]
            rgb_s, depth_s, acc_s, weights_s = static_side_outputs(
                st.rgb, st.sigma, st.dists, st.z_vals, sp.rays,
                is_train=True, ray_type=S.ray_type, white=sp.white,
            )
            res[n] = (_partial_outputs(sp.rays, R[n], z_vals.shape[1], S.debug_nan_fill,
                                       rgb_s=rgb_s, depth_s=depth_s, acc_s=acc_s,
                                       weights_s=weights_s), st, None, z_vals)
        elif sp.mode == "stat":
            res[n] = (None, st_by_name[n], None, z_vals)
    return res


def _run_local(params, S: StepStatics, aabb, specs, packs):
    """Batched (fused_passes) or sequential evaluation of the passes. The
    sequential passes run in eager order, one after another: the JAX
    package's optimization_barrier chain, which keeps XLA from overlapping
    rematerialized passes, has nothing to order here."""
    if S.fused_passes:
        return _batched_passes(params, S, aabb, specs, packs)
    res = {}
    for n in _pass_order(specs):
        sp = specs[n]
        shared = res[sp.static_from][1] if sp.static_from else None
        # grad: False where the pass's rays and static evaluation are
        # detached (A-D)
        with span("train.pass", name=n, grad=not sp.detach_static):
            res[n] = _dual_pass(params, S, aabb, sp, packs, shared_st=shared)
    return res


def _span(S: StepStatics, n_rows: int):
    """This rank's [start, end) of n_rows rays on the data mesh."""
    return process_span(n_rows, S.mesh.get_local_rank(), S.mesh.size())


def _flat_args(S: StepStatics, valids, compacted: bool):
    """(N, row offsets) of the flat bucket of one field evaluation over the
    concatenated rows of `valids` (one [R_p, S] occupancy per pass): N =
    compact_flat × the whole batch's rows, 0 off compacted geometry. On a
    data mesh the rows are this rank's span of each pass, and row r of pass
    p gets the offset of its samples in the whole batch's row-major order
    (every rank's rows of the earlier passes, the earlier ranks' rows of
    pass p) less this rank's earlier-pass samples: one all-gather of the
    per-pass occupied counts, no host sync (render/pipeline._flat_index)."""
    if S.compact_flat <= 0 or not compacted:
        return 0, None
    rows = sum(v.shape[0] for v in valids)
    if S.mesh is None:
        return S.compact_flat * rows, None
    W, r = S.mesh.size(), S.mesh.get_local_rank()
    counts = torch.stack([v.sum() for v in valids]).to(torch.int64)
    C = all_gather_dim(counts, 0, mesh_group(S.mesh)).view(W, -1)  # [W, P]
    per_pass = C.sum(0)
    delta = (torch.cumsum(per_pass, 0) - per_pass + C[:r].sum(0)
             - (torch.cumsum(C[r], 0) - C[r]))
    return S.compact_flat * rows * W, torch.cat([delta[p].expand(v.shape[0])
                                                 for p, v in enumerate(valids)])


# what train_loss reads of each pass's compositor outputs, by mode; on a data
# mesh only these are gathered, and the others are NaN placeholders, so that
# a loss reading a field not listed here turns non-finite instead of
# training on zeros
_READ = {
    "dual": ("rgb_full", "depth_s", "rgb_d", "depth_d", "weights_d", "dynamicness"),
    "dyn": ("weights_d",),
    "stat_out": ("rgb_s", "depth_s", "weights_s"),
    "stat": (),
}


def _run_passes(params, S: StepStatics, aabb, specs, packs):
    """The passes' results for the whole batch. On a data mesh each pass's
    samples are drawn for the whole batch (the same draws on every rank),
    each rank evaluates its span of the rays, and the outputs the losses
    read are gathered in one collective (gather_rows: the rank's rows of the
    cotangent × W in the backward). The field evaluations' sample points
    and z values are the whole batch's samples themselves; their weights
    are gathered for the static-only passes, the one place a loss reads
    them; their other fields are None."""
    if S.mesh is None:
        return _run_local(params, S, aabb, specs, packs)
    samp, local = {}, {}
    for n in _pass_order(specs):
        sp = specs[n]
        samp[n] = _unpack_samp(sp.samp) if sp.samp is not None else sample_xyz(
            sp.rays, S.n_samples, S.ray_type, S.static_cfg.near_far, aabb, S.step_size,
            sp.gen, det_jitter=S.golden_det,
        ) + (None,)
        a, b = _span(S, sp.rays.shape[0])
        local[n] = sp._replace(rays=sp.rays[a:b], ts=sp.ts[a:b], gen=None,
                               samp=tuple(x[a:b] for x in samp[n] if x is not None))
    res = _run_local(params, S, aabb, {n: local[n] for n in specs}, packs)

    parts, where = [], []
    for n in specs:
        out, st, _, _ = res[n]
        mode = specs[n].mode
        for f in _READ[mode]:
            parts.append(getattr(out, f))
            where.append((n, f))
        if mode == "stat":
            parts.append(st.weights)
            where.append((n, "weights"))
    full = dict(zip(where, gather_rows_packed(parts, mesh_group(S.mesh))))

    out = {}
    for n, sp in specs.items():
        xyz, z_vals = samp[n][0], samp[n][1]
        R, nS = z_vals.shape
        ev = FieldEval(blending=None, pts_ref=xyz, weights=full.get((n, "weights")),
                       xyz_prime=None, rgb=None, sigma=None, z_vals=z_vals, dists=None)
        filled = {f: full[(n, f)] for f in _READ[sp.mode]}
        ro = (None if sp.mode == "stat" else
              _partial_outputs(z_vals, R, nS, debug_nan=True, **filled))
        out[n] = (ro, ev if sp.mode != "dyn" else None, ev if sp.mode in ("dual", "dyn") else None,
                  z_vals)
    return out


def _per_ray(S: StepStatics, fn, *xs):
    """fn over the batch's rays (leading dim): on a data mesh each rank
    evaluates its span and the outputs are gathered (gather_rows)."""
    if S.mesh is None:
        return fn(*xs)
    a, b = _span(S, xs[0].shape[0])
    return tuple(gather_rows_packed(list(fn(*(x[a:b] for x in xs))), mesh_group(S.mesh)))


def train_loss(
    params: Dict[str, Any],
    S: StepStatics,
    aabb: torch.Tensor,
    data: Dict[str, torch.Tensor],
    ray_idx: torch.Tensor,
    ray_idx_rand: torch.Tensor,
    gen: Optional[torch.Generator],
    sc: Dict[str, float],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full loss assembly (reference: train.py:1032-2311). Returns
    (total_loss, metrics). `gen` draws the sampler jitter and white-fill
    coins (unused with golden_det); `sc` holds the host scalars."""
    H, W, T = S.H, S.W, S.n_cams
    it = float(sc["iteration"])
    wts = S.weights
    metrics: Dict[str, Any] = {}
    sg = torch.Tensor.detach

    # Lambda annealing (train.py:1033-1036)
    Temp_static = 10.0 ** (-(it / 100000.0))
    Temp = 10.0 ** (-(it // 100000.0))
    Temp_disp_TV = 10.0 ** (-(it // 50000.0))
    # iteration-gated loss switches (train.py:1248, 1339)
    after_u0 = float(it >= S.upsamp0)
    after_u3 = float(it >= S.upsamp3)

    if S.optimize_focal:
        focal = focal_from_fov(params["fov"][0, 0], H, W)
    else:
        focal = aabb.new_tensor(float(sc["focal_fixed"]))
    poses_mtx = pose_to_mtx(params["pose"])  # [T, 3, 4]

    # fused gather tables, built once per step and shared by every pass
    packs = (
        stat_field.pack_tables(params["static"], S.static_cfg),
        dyn_field.pack_tables(params["dynamic"], S.dynamic_cfg),
    )

    rgb_train = data["rgbs"][ray_idx]
    ts_train = data["ts"][ray_idx]
    flow_f = data["flows_f"][ray_idx]
    mask_f = data["flow_masks_f"][ray_idx][..., None]
    flow_b = data["flows_b"][ray_idx]
    mask_b = data["flow_masks_b"][ray_idx][..., None]
    fg_mask = data["fg_masks"][ray_idx]
    disps_train = data["disps"][ray_idx] if S.use_disp else None
    ts_rand = data["ts"][ray_idx_rand]

    rays_train, i_px, j_px, view_ids = _rays_from_idx(ray_idx, poses_mtx, focal, S)
    grid_train = torch.stack([i_px, j_px], -1).to(aabb.dtype)  # (train.py:983-988)

    t_ref = torch.div(ray_idx, H * W, rounding_mode="floor")
    u_ref = torch.div(ray_idx % (H * W), W, rounding_mode="floor")
    v_ref = (ray_idx % (H * W)) % W
    t_interval = 2.0 / (T - 1)

    poses_f = torch.cat([poses_mtx[1:], poses_mtx[-1:]], 0)[t_ref]
    poses_b = torch.cat([poses_mtx[0:1], poses_mtx[:-1]], 0)[t_ref]

    # ---- pass geometry, hoisted (math-identical to the reference's
    # interleaving)
    rays_det = sg(rays_train)
    focal_det = sg(focal)
    uv_base = torch.stack([v_ref + 0.5, u_ref + 0.5], -1).to(aabb.dtype)
    rays_f = _rays_from_uv(uv_base + flow_f, sg(poses_f), focal_det, S)  # (train.py:1433-1436)
    rays_b = _rays_from_uv(uv_base + flow_b, sg(poses_b), focal_det, S)

    def _draws(coin: bool):
        if S.golden_det:
            return None, None
        white = bool(torch.rand((), generator=gen) < 0.5) if coin else None
        return gen, white

    def _spec(rays, ts, detach, mode="dual"):
        g, white = _draws(True)
        return PassSpec(rays, ts, g, white, detach, mode)

    # A: training rays detached (train.py:1092-1162); B: novel time (1166);
    # C/D: flow-warped neighbors (1431-1625), losses consume only weights_d
    # + sampler points ("dyn"); E: non-detached (1755-1823), losses consume
    # only the static-side compositor outputs ("stat_out")
    specs = {
        "A": _spec(rays_det, ts_train, True),
        "B": _spec(rays_det, ts_rand, True),
        "C": _spec(sg(rays_f), ts_train + t_interval, True, "dyn"),
        "D": _spec(sg(rays_b), ts_train - t_interval, True, "dyn"),
        "E": _spec(rays_train, ts_train, False, "stat_out"),
    }
    if S.share_forward:
        # one sample set for the train-ray passes: E samples live (pose/focal
        # grads flow through xyz), A/B consume it detached and reuse E's
        # static eval
        samp_live = sample_xyz(
            rays_train, S.n_samples, S.ray_type, S.static_cfg.near_far, aabb,
            S.step_size, specs["A"].gen, det_jitter=S.golden_det,
        )
        samp_det = tuple(sg(a) for a in samp_live)
        specs["A"] = specs["A"]._replace(samp=samp_det, static_from="E")
        specs["B"] = specs["B"]._replace(samp=samp_det, static_from="E")
        specs["E"] = specs["E"]._replace(samp=samp_live)
    if S.optimize_poses:
        # FF/BB: static disparity passes with NON-detached pose/focal
        # (train.py:1960-2094); F/G: pixel-neighbor passes (2123-2311)
        rays_f_nd = _rays_from_uv(uv_base + flow_f, poses_f, focal, S)
        rays_b_nd = _rays_from_uv(uv_base + flow_b, poses_b, focal, S)
        i_n = torch.clamp(i_px + 1, max=W - 1)
        j_n = torch.clamp(j_px + 1, max=H - 1)
        poses_per_ray = poses_mtx[view_ids]

        def _neighbor_rays(ii, jj):
            return make_rays(ii, jj, (focal, focal), (W / 2, H / 2), poses_per_ray, H, W,
                             S.ray_type)

        specs["F"] = _spec(_neighbor_rays(i_n, j_px), ts_train, False, "stat_out")
        specs["G"] = _spec(_neighbor_rays(i_px, j_n), ts_train, False, "stat_out")
        specs["FF"] = PassSpec(rays_f_nd, ts_train, _draws(False)[0], None, False, "stat")
        specs["BB"] = PassSpec(rays_b_nd, ts_train, _draws(False)[0], None, False, "stat")

    # ---- train-time occupancy mask (+ [R, K] compaction); the trainer turns
    # these on once update_AlphaMask_list fires with --compact_train
    sf_pts_dense = None  # pass A's dense pre-compaction points + selection:
    sf_idx = None        # the scene-flow regularisers keep the dense domain
    if S.use_alpha_mask:
        K = S.compact_k
        done = set()
        if S.share_forward:
            # shared train-ray geometry: one selection for A/B/E from the
            # union of their per-time occupancies (keeps A/B's reuse of E's
            # static eval exact; a superset of per-pass masking)
            xyz_sh, z_sh, valid_sh = samp_live
            occ_u = (_occupancy(data, xyz_sh, ts_train, valid_sh, S.alpha_shape)
                     | _occupancy(data, xyz_sh, ts_rand, valid_sh, S.alpha_shape))
            if K > 0:
                samp_m, sf_idx = _compact_samp(xyz_sh, z_sh, occ_u, rays_train, S.ray_type, K)
                sf_pts_dense = sg(xyz_sh)
            else:
                samp_m = (xyz_sh, z_sh, occ_u)
            specs["E"] = specs["E"]._replace(samp=samp_m)
            samp_m_det = tuple(sg(a) for a in samp_m)
            specs["A"] = specs["A"]._replace(samp=samp_m_det)
            specs["B"] = specs["B"]._replace(samp=samp_m_det)
            done |= {"A", "B", "E"}
        for n in list(specs):
            if n in done:
                continue
            sp = specs[n]
            xyz_p, z_p, v_p = sp.samp if sp.samp is not None else sample_xyz(
                sp.rays, S.n_samples, S.ray_type, S.static_cfg.near_far, aabb, S.step_size,
                sp.gen, det_jitter=S.golden_det,
            )
            occ_p = _occupancy(data, xyz_p, sp.ts, v_p, S.alpha_shape)
            if K > 0:
                samp_m, idx_p = _compact_samp(xyz_p, z_p, occ_p, sp.rays, S.ray_type, K)
                if n == "A":  # share_forward off: A owns its geometry
                    sf_pts_dense, sf_idx = xyz_p, idx_p
            else:
                samp_m = (xyz_p, z_p, occ_p)
            specs[n] = sp._replace(samp=samp_m)

    res = _run_passes(params, S, aabb, specs, packs)
    outA, stA, dnA, _ = res["A"]
    outB, stB, dnB, _ = res["B"]

    # skewed mask + novel mask losses (train.py:1248-1273), gated on upsamp3
    skewed_rand = L.skewed_entropy(outB.dynamicness)
    novel_mask = torch.mean(torch.abs(outB.dynamicness))
    total = after_u3 * 0.01 * (skewed_rand + novel_mask)
    metrics["skewed_mask_loss_rand"] = skewed_rand
    metrics["novel_view_time_mask_loss"] = novel_mask

    # novel adaptive order loss (train.py:1276-1292)
    novel_order = L.adaptive_order_loss(
        outB.depth_d, sg(outB.depth_s), sg(outB.dynamicness), S.ray_type
    )
    total = total + novel_order * 10.0
    metrics["novel_order_loss"] = novel_order

    # novel-time distortion (train.py:1299-1311); the 1/nS interval is the
    # dense sampler spacing, also under compaction (weights axis K)
    if wts.distortion_dynamic > 0:
        dist_rand = eff_distloss(outB.weights_d, sg(dnB.z_vals), 1.0 / S.n_samples)
        total = total + dist_rand * wts.distortion_dynamic * (it / S.n_iters)
        metrics["loss_distortion_rand"] = dist_rand

    # scene flow at pass-A sample points (train.py:1319-1321). Under
    # compaction the regularisers (small/smooth, below) keep the dense
    # domain: the flow MLP runs at all S dense points, and only the kept
    # samples feed the induced flows (aligned with the compacted weights_d)
    def scene_flow(pts, ts):
        return dyn_field.scene_flow(params["dynamic"], pts, ts, aabb)

    if sf_idx is not None:
        sf_reg_f, sf_reg_b = _per_ray(S, scene_flow, sf_pts_dense, ts_train)
        pick = sf_idx[..., None].expand(-1, -1, 3)
        scene_flow_f = torch.gather(sf_reg_f, 1, pick)
        scene_flow_b = torch.gather(sf_reg_b, 1, pick)
    else:
        scene_flow_f, scene_flow_b = _per_ray(S, scene_flow, dnA.pts_ref, ts_train)
        sf_reg_f, sf_reg_b = scene_flow_f, scene_flow_b

    # RGB losses (train.py:1323-1335)
    img_loss = L.mse(outA.rgb_full, rgb_train)
    total = total + 3.0 * img_loss
    metrics["mse"] = img_loss
    metrics["psnr"] = -10.0 * torch.log(img_loss) / math.log(10.0)

    img_d_loss = L.mse(outA.rgb_d, rgb_train)
    total = total + 1.0 * img_d_loss
    metrics["img_d_loss"] = img_d_loss

    # mask loss (train.py:1339-1347), gated on upsamp0
    mask_loss = torch.mean(torch.abs(outA.dynamicness - fg_mask))
    total = total + after_u0 * 0.1 * mask_loss * Temp_disp_TV
    metrics["mask_loss"] = mask_loss

    # skewed mask + L1 on training time (train.py:1349-1371), gated on upsamp3
    skewed = L.skewed_entropy(outA.dynamicness)
    mask_l1 = torch.mean(torch.abs(outA.dynamicness))
    total = total + after_u3 * 0.01 * (skewed + mask_l1)
    metrics["skewed_mask_loss"] = skewed
    metrics["mask_L1_reg_loss"] = mask_l1

    # displaced points (train.py:1373-1378)
    if S.ray_type == "ndc":
        pts_f = dnA.pts_ref + scene_flow_f
        pts_b = dnA.pts_ref + scene_flow_b
    else:
        pts_f = torch.clamp(dnA.pts_ref + scene_flow_f, -2.0 + 1e-6, 2.0 - 1e-6)
        pts_b = torch.clamp(dnA.pts_ref + scene_flow_b, -2.0 + 1e-6, 2.0 - 1e-6)

    # induced flow losses (train.py:1380-1419); focal detached here
    induced_flow_f, induced_disp_f = induce_flow(
        H, W, focal_det, sg(poses_f), outA.weights_d, pts_f, grid_train, rays_det, S.ray_type
    )
    flow_f_loss = L.masked_l1_mean(torch.abs(induced_flow_f - flow_f), mask_f, 2.0)
    induced_flow_b, induced_disp_b = induce_flow(
        H, W, focal_det, sg(poses_b), outA.weights_d, pts_b, grid_train, rays_det, S.ray_type
    )
    flow_b_loss = L.masked_l1_mean(torch.abs(induced_flow_b - flow_b), mask_b, 2.0)
    total = total + 0.02 * (flow_f_loss + flow_b_loss) * Temp
    metrics["flow_f_loss"] = flow_f_loss
    metrics["flow_b_loss"] = flow_b_loss

    # small scene flow (train.py:1421-1429), dense domain
    small_sf = torch.mean(torch.abs(sf_reg_f)) + torch.mean(torch.abs(sf_reg_b))
    total = total + wts.small_scene_flow * small_sf
    metrics["small_scene_flow_loss"] = small_sf

    # ---- PASS C/D: flow-warped neighbor rays (train.py:1431-1625)
    outC, _, dnC, _ = res["C"]
    _, induced_disp_ff = induce_flow(
        H, W, focal_det, sg(poses_f), outC.weights_d, dnC.pts_ref, grid_train, sg(rays_f),
        S.ray_type,
    )
    disp_f_loss = L.masked_l1_mean(
        L.abs_(_warped_pair(induced_disp_f, induced_disp_ff, rays_det, rays_f)), mask_f)
    total = total + 0.04 * disp_f_loss * Temp
    metrics["disp_f_loss"] = disp_f_loss

    outD, _, dnD, _ = res["D"]
    _, induced_disp_bb = induce_flow(
        H, W, focal_det, sg(poses_b), outD.weights_d, dnD.pts_ref, grid_train, sg(rays_b),
        S.ray_type,
    )
    disp_b_loss = L.masked_l1_mean(
        L.abs_(_warped_pair(induced_disp_b, induced_disp_bb, rays_det, rays_b)), mask_b)
    total = total + 0.04 * disp_b_loss * Temp
    metrics["disp_b_loss"] = disp_b_loss

    # smooth scene flow (train.py:1627-1633), dense domain
    smooth_sf = torch.mean(torch.abs(sf_reg_f + sf_reg_b))
    total = total + wts.smooth_scene_flow * smooth_sf
    metrics["smooth_scene_flow_loss"] = smooth_sf

    # monodepth dynamic (train.py:1635-1659)
    if S.use_disp:
        if S.ray_type == "ndc":
            md = L.monodepth_loss(outA.depth_d, -disps_train, t_ref, T)
        else:
            md = L.monodepth_loss(1.0 / (outA.depth_d + 1e-6), disps_train, t_ref, T)
        total = total + md * wts.monodepth_dynamic * Temp
        metrics["total_mono_depth_loss_dynamic"] = md

    # adaptive order loss (train.py:1666-1680)
    order = L.adaptive_order_loss(outA.depth_d, sg(outA.depth_s), sg(outA.dynamicness), S.ray_type)
    total = total + order * 10.0
    metrics["order_loss"] = order

    # dynamic distortion over A/C/D (train.py:1685-1711)
    if wts.distortion_dynamic > 0:
        nS = S.n_samples
        dist = (
            eff_distloss(outA.weights_d, sg(dnA.z_vals), 1.0 / nS)
            + eff_distloss(outC.weights_d, sg(dnC.z_vals), 1.0 / nS)
            + eff_distloss(outD.weights_d, sg(dnD.z_vals), 1.0 / nS)
        )
        total = total + dist * wts.distortion_dynamic * (it / S.n_iters)
        metrics["loss_distortion"] = dist

    # grid regularizers, dynamic field (train.py:1718-1753)
    tv_mult = S.lr_factor ** (it + 1.0)  # (train.py:1735: *= lr_factor before use)
    with span("train.regularizers", field="dynamic"):
        if wts.ortho > 0:
            ortho = line_orthogonality(params["dynamic"]["density_line"]) + line_orthogonality(
                params["dynamic"]["app_line"]
            )
            total = total + wts.ortho * ortho
            metrics["reg"] = ortho
        if wts.l1 > 0:
            l1d = dyn_field.density_l1(params["dynamic"], S.dynamic_cfg)
            total = total + wts.l1 * l1d
            metrics["loss_reg_L1_density"] = l1d
        if wts.tv_density > 0:
            tvd = dyn_field.tv_density(params["dynamic"]) + dyn_field.tv_blending(params["dynamic"])
            total = total + wts.tv_density * tv_mult * tvd
            metrics["reg_tv_density"] = tvd
        if wts.tv_app > 0:
            tva = dyn_field.tv_app(params["dynamic"])
            total = total + wts.tv_app * tv_mult * tva
            metrics["reg_tv_app"] = tva

    # ---- PASS E: non-detached rays -> static + camera gradients
    # (train.py:1755-1823)
    outE, stE, _, z_vals_E = res["E"]

    # static RGB on background pixels (train.py:1827-1835)
    bg = 1.0 - fg_mask[..., None]
    img_s_loss = torch.sum(((outE.rgb_s - rgb_train) ** 2) * bg) / (torch.sum(bg) + 1e-8) / 3.0
    total = total + 1.0 * img_s_loss
    metrics["img_s_loss"] = img_s_loss

    # static distortion (train.py:1841-1856)
    if wts.distortion_static > 0:
        dist_s = eff_distloss(outE.weights_s, z_vals_E, 1.0 / S.n_samples)
        total = total + dist_s * wts.distortion_static * (it / S.n_iters)
        metrics["loss_distortion_static"] = dist_s

    # static regs (train.py:1863-1887)
    with span("train.regularizers", field="static"):
        if wts.l1 > 0:
            l1s = stat_field.density_l1(params["static"], S.static_cfg)
            total = total + wts.l1 * l1s
            metrics["loss_reg_L1_density_s"] = l1s
        if wts.tv_density > 0:
            tvs = stat_field.tv_density(params["static"])
            total = total + wts.tv_density * tv_mult * tvs
            metrics["reg_tv_density_static"] = tvs
        if wts.tv_app > 0:
            tvas = stat_field.tv_app(params["static"])
            total = total + wts.tv_app * tv_mult * tvas
            metrics["reg_tv_app_static"] = tvas

    if S.optimize_poses:
        # static motion losses (train.py:1895-1958); focal NOT detached
        induced_flow_f_s, induced_disp_f_s = induce_flow(
            H, W, focal, poses_f, outE.weights_s, stE.pts_ref, grid_train, rays_train, S.ray_type
        )
        comb_f = mask_f * bg
        flow_f_s = L.masked_l1_mean(torch.abs(induced_flow_f_s - flow_f), comb_f, 2.0)
        induced_flow_b_s, induced_disp_b_s = induce_flow(
            H, W, focal, poses_b, outE.weights_s, stE.pts_ref, grid_train, rays_train, S.ray_type
        )
        comb_b = mask_b * bg
        flow_b_s = L.masked_l1_mean(torch.abs(induced_flow_b_s - flow_b), comb_b, 2.0)
        total = total + 0.02 * (flow_f_s + flow_b_s) * Temp_static
        metrics["flow_f_s_loss"] = flow_f_s
        metrics["flow_b_s_loss"] = flow_b_s

        # static disparity consistency via flow-warped rays (train.py:1960-2094)
        stFF = res["FF"][1]
        _, induced_disp_s_ff = induce_flow(
            H, W, focal, poses_f, stFF.weights, stFF.pts_ref, grid_train, rays_f_nd, S.ray_type
        )
        disp_f_s = L.masked_l1_mean(
            L.abs_(_warped_pair(induced_disp_f_s, induced_disp_s_ff, rays_train, rays_f_nd)),
            comb_f)
        total = total + 0.04 * disp_f_s * Temp_static
        metrics["disp_f_s_loss"] = disp_f_s

        stBB = res["BB"][1]
        _, induced_disp_s_bb = induce_flow(
            H, W, focal, poses_b, stBB.weights, stBB.pts_ref, grid_train, rays_b_nd, S.ray_type
        )
        disp_b_s = L.masked_l1_mean(
            L.abs_(_warped_pair(induced_disp_b_s, induced_disp_s_bb, rays_train, rays_b_nd)),
            comb_b)
        total = total + 0.04 * disp_b_s * Temp_static
        metrics["disp_b_s_loss"] = disp_b_s

        # static monodepth, background-only (train.py:2096-2116)
        if S.use_disp:
            bg_valid = fg_mask < 0.5
            if S.ray_type == "ndc":
                md_s = L.monodepth_loss(outE.depth_s, -disps_train, t_ref, T, bg_valid)
            else:
                md_s = L.monodepth_loss(1.0 / (outE.depth_s + 1e-6), disps_train, t_ref, T,
                                        bg_valid)
            total = total + md_s * wts.monodepth_static * Temp_static
            metrics["total_mono_depth_loss_static"] = md_s

        # ---- PASS F/G: pixel-neighbor rays (train.py:2123-2311)
        smooth = L.disp_smooth_loss(outE.depth_s, res["F"][0].depth_s, res["G"][0].depth_s)
        total = total + smooth * 50.0 * Temp_disp_TV
        metrics["disp_smooth_loss"] = smooth

    metrics["total_loss"] = total
    metrics["focal"] = focal
    return total, metrics


# ---------------------------------------------------------------------------
# Optimizers: one Adam over both fields (spatial and network learning rates
# as two param groups), one for the poses, one for the focal; learning rates
# from the host schedule on every step (reference: train.py:934, 991-1009,
# 2350-2351, 2589-2610).
# ---------------------------------------------------------------------------

FIELD_BETAS = (0.9, 0.99)
# pose/focal Adams use torch defaults — the reference constructs them without
# betas (train.py:993, 1002), unlike the field optimizer's (0.9, 0.99)
POSE_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def named_leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def is_spatial(path) -> bool:
    """Plane/line params get lr_init (0.02); everything else lr_basis (0.001)
    (reference: tensoRF.py:49-61, 352-376 get_optparam_groups)."""
    return any(("plane" in str(n) or "line" in str(n)) for n in path)


def init_opt_state(params) -> Dict[str, torch.optim.Adam]:
    fields = list(named_leaves({"static": params["static"], "dynamic": params["dynamic"]}))
    spatial = [t for p, t in fields if is_spatial(p)]
    network = [t for p, t in fields if not is_spatial(p)]
    return {
        "fields": torch.optim.Adam(
            [{"params": spatial, "lr": 0.0}, {"params": network, "lr": 0.0}],
            betas=FIELD_BETAS, eps=ADAM_EPS,
        ),
        "pose": torch.optim.Adam([params["pose"]], lr=0.0, betas=POSE_BETAS, eps=ADAM_EPS),
        "fov": torch.optim.Adam([params["fov"]], lr=0.0, betas=POSE_BETAS, eps=ADAM_EPS),
    }


def apply_updates(params, opt_state, sc):
    """Adam step of every group at this iteration's learning rates. A
    parameter the loss did not reach steps with a zero gradient, as in the
    JAX package (its moments decay)."""
    with span("train.adam"):
        for _, t in named_leaves(params):
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        spatial, network = opt_state["fields"].param_groups
        spatial["lr"] = float(sc["lr_spatial"])
        network["lr"] = float(sc["lr_network"])
        opt_state["pose"].param_groups[0]["lr"] = float(sc["lr_pose"])
        opt_state["fov"].param_groups[0]["lr"] = float(sc["lr_focal"])
        for opt in opt_state.values():
            opt.step()


class TrainStep:
    """One optimisation step: (params, opt_state, aabb, data, ray_idx,
    ray_idx_rand, gen, sc) -> metrics. Updates params and optimizer state in
    place."""

    def __init__(self, S: StepStatics, device):
        self.S = S
        self.device = check_device(device)

    def grads_and_metrics(self, params, aabb, data, ray_idx, ray_idx_rand, gen, sc):
        """Loss, backward, and the gradient tree (zeros where the loss did
        not reach a parameter). Leaves the gradients in `.grad`.

        With grad_accum = A > 1, micro-batch i takes row i of
        ray_idx.reshape(A, -1) and of ray_idx_rand.reshape(A, -1) and draws
        from `gen` after micro-batch i - 1; each micro-batch's backward adds
        its gradient over A into `.grad`, zeroed once per step, and the
        metrics are the mean over the micro-batches (the JAX package's
        scan). Each micro-batch builds its own gather tables, so only one
        micro-batch's graph is alive at a time.

        On a data mesh every rank takes the same global batch: micro-batch i
        is the global micro-batch i, split over the ranks inside the passes.
        The sharded grids are gathered into a working copy once per step;
        after the last micro-batch's backward every gradient is averaged
        over the ranks (parallel/mesh.sync_gradients), and a sharded grid's
        `.grad` (and its entry in the returned tree) is its shard's."""
        S = self.S
        work = params if S.mesh is None else working_copy(params, S.grid_dims,
                                                          mesh_group(S.mesh))
        for _, t in named_leaves(work):
            t.grad = None
        A = max(1, int(S.grad_accum))
        metrics: Dict[str, Any] = {}
        for ri, rr in zip(ray_idx.reshape(A, -1), ray_idx_rand.reshape(A, -1)):
            with span("train.forward"):
                total, m = train_loss(work, S, aabb, data, ri, rr, gen, sc)
            with span("train.backward"):
                (total / A if A > 1 else total).backward()
            for k, v in m.items():
                v = v.detach() if torch.is_tensor(v) else v
                metrics[k] = v if A == 1 else metrics.get(k, 0.0) + v / A
            del total, m
        if S.mesh is not None:
            sync_gradients(params, work, S.grid_dims, mesh_group(S.mesh))
        grads = _tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)
        return grads, metrics

    def __call__(self, params, opt_state, aabb, data, ray_idx, ray_idx_rand, gen, sc):
        _, metrics = self.grads_and_metrics(params, aabb, data, ray_idx, ray_idx_rand, gen, sc)
        apply_updates(params, opt_state, sc)
        return metrics


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def make_train_step(S: StepStatics, device="cuda") -> TrainStep:
    """Build the train step for `device` (the card by default)."""
    return TrainStep(S, device)
