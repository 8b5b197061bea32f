"""Trainer: owns params, optimizers, schedules and the train step (port of
rodynrf_tpu/train/trainer.py; reference train.py:824-2658).

Runs the JAX package's default recipe: bf16 or f32 gather tables, the
strided or merged table layout ('auto' picks per field by table bytes), and
the voxel upsample at every `upsamp_list` iteration, after which the layout
is chosen anew. Builds the dual-field occupancy mask (`update_alpha_mask`,
fired by `train` at `update_AlphaMask_list` iterations); with
`--compact_train 1` the step then masks and compacts its samples to the
[R, K] and flat buckets the occupancy probe sizes. `--app_frac` turns on
appearance top-K compaction from `--app_start` (default: after the first
upsample). Resumes from a native checkpoint (`--ckpt`), its mask included:
a full one (`save_full`) continues the exact trajectory, a plain one
restarts the optimizers and replays the schedule. The step's memory
options follow the JAX trainer's auto rules: gradient accumulation
(`--grad_accum`, 0 = 4 micro-batches when N_voxel_final > 500³),
rematerialization (`--remat auto|on|off`) and, with `--fused_passes 1`,
the passes per batched dynamic evaluation. What the port lacks is refused
with NotImplementedError rather than ignored, naming the ROADMAP.md queue 1
item that brings it: sharded grids, the table-gradient routes other than
the kernels, and more than one device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.se3 import pose_to_mtx
from ..data.scene import SceneData, default_focal
from ..fields import FieldConfig, cal_n_samples, n_to_reso
from ..fields import dynamic as dyn_field
from ..fields import static as stat_field
from ..fields.alpha_mask import build_dual_alpha_mask, dilate_occupancy, occupancy_nearest
from ..render.sampling import sample_xyz
from .checkpoints import load_checkpoint, save_checkpoint
from .convert import params_from_numpy, params_to_numpy
from .schedule import LrSchedule, PermutationSampler, n_voxel_schedule
from .step import (
    LossWeights,
    StepStatics,
    _rays_from_idx,
    check_device,
    focal_from_fov,
    init_opt_state,
    make_train_step,
    named_leaves,
)


def init_pose_params(scene: SceneData, n_cams: int) -> np.ndarray:
    """6D-rotation + translation per frame (reference: train.py:964-973)."""
    init = np.zeros((n_cams, 9), np.float32)
    if scene.poses is not None:
        init[:, 0:3] = scene.poses[:, :, 0]
        init[:, 3:6] = scene.poses[:, :, 1]
        init[:, 6:9] = scene.poses[:, :, 3]
    else:
        init[:, 0] = 1.0
        init[:, 4] = 1.0
    return init


# the ROADMAP.md queue 1 item that brings what the port refuses
PARALLELISM = "ROADMAP.md queue 1, item 4: parallelism"


def not_ported(what: str, item: str = "ROADMAP.md"):
    raise NotImplementedError(f"{what} is not ported to rodynrf_tpu_torch yet ({item})")


def _refuse_unported(args, device: torch.device):
    """NotImplementedError for every option the port does not implement."""
    if int(getattr(args, "shard_grids", 0)):
        not_ported("--shard_grids 1", PARALLELISM)
    if getattr(args, "grad_impl", "autodiff") != "autodiff":
        not_ported(f"--grad_impl {args.grad_impl} (the port's table gradients are the "
                   "coalesce and segment-sum kernels)")
    n_dev = int(getattr(args, "n_devices", 0))
    if n_dev == 0 and device.type == "cuda":
        n_dev = torch.cuda.device_count()
    if n_dev > 1:
        not_ported(f"data parallelism over {n_dev} devices; pass --n_devices 1", PARALLELISM)


class Trainer:
    """The training loop's state. `device` is the card unless the caller asks
    for the CPU; there is no fallback when the card is missing."""

    def __init__(self, args, scene: SceneData, device="cuda"):
        self.device = check_device(device)
        _refuse_unported(args, self.device)
        self.args = args
        self.scene = scene
        # one CPU generator for the init and every per-step draw (jitter,
        # white-fill coins); the JAX package's keys give other numbers
        self.gen = torch.Generator().manual_seed(int(args.seed))

        W, H = scene.img_wh
        self.H, self.W = H, W
        self.aabb = torch.as_tensor(scene.scene_bbox, dtype=torch.float32, device=self.device)

        reso_cur = n_to_reso(args.N_voxel_init, scene.scene_bbox)
        self.n_samples = min(args.nSamples, cal_n_samples(reso_cur, args.step_ratio))

        common = dict(
            t_size=args.N_voxel_t,
            density_n_comp=tuple(args.n_lamb_sigma),
            app_n_comp=tuple(args.n_lamb_sh),
            app_dim=args.data_dim_color,
            density_shift=args.density_shift,
            alpha_mask_thres=args.alpha_mask_thre,
            distance_scale=args.distance_scale,
            ray_march_weight_thres=args.rm_weight_mask_thre,
            fea2dense_act=args.fea2denseAct,
            near_far=tuple(scene.near_far),
            step_ratio=args.step_ratio,
            pos_pe=args.pos_pe,
            view_pe=args.view_pe,
            featureC=args.featureC,
            grid_sample_dtype="bfloat16" if int(getattr(args, "bf16", 0)) else "float32",
            vm_layout=getattr(args, "vm_layout", "auto"),
        )
        # static model uses fea_pe=2, dynamic fea_pe=0 (train.py:889, 918)
        self.static_cfg = FieldConfig(
            grid_size=reso_cur, shading_mode=args.shadingModeStatic, fea_pe=2, **common
        )
        self.dynamic_cfg = FieldConfig(
            grid_size=reso_cur, shading_mode=args.shadingMode, fea_pe=0, **common
        )

        params = {
            "static": stat_field.init_static_field(self.gen, self.static_cfg),
            "dynamic": dyn_field.init_dynamic_field(self.gen, self.dynamic_cfg),
            "pose": torch.from_numpy(init_pose_params(scene, args.N_voxel_t)),
            "fov": torch.full((1, 1), 30.0 / 180.0 * np.pi),
        }
        self.set_params(params)

        if args.lr_decay_iters > 0:
            lr_factor = args.lr_decay_target_ratio ** (1.0 / args.lr_decay_iters)
        else:
            lr_factor = args.lr_decay_target_ratio ** (1.0 / args.n_iters)
        self.lr_factor = lr_factor
        self.schedule = LrSchedule(
            lr_init=args.lr_init,
            lr_basis=args.lr_basis,
            lr_factor=lr_factor,
            n_iters=args.n_iters,
            upsamp_list=list(args.upsamp_list),
            optimize_poses=bool(args.optimize_poses),
            optimize_focal=bool(args.optimize_focal_length),
            lr_upsample_reset=bool(args.lr_upsample_reset),
            lr_decay_target_ratio=args.lr_decay_target_ratio,
        )
        self.n_voxel_list = n_voxel_schedule(
            args.N_voxel_init, args.N_voxel_final, len(args.upsamp_list)
        )
        self.sampler = PermutationSampler(scene.n_rays, args.batch_size, args.seed)
        self.sampler2 = PermutationSampler(scene.n_rays, args.batch_size, args.seed + 1)

        self.data = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in scene.device_arrays().items()
        }
        self.focal_fixed = float(scene.focal if scene.focal is not None else default_focal(W, H))
        self.iteration = 0
        # occupancy mask, built at update_AlphaMask_list iterations: feeds the
        # eval early-out, checkpoints and, with --compact_train, the step
        self.alpha_mask = None
        # train-time compaction: per-ray [R, K] bucket (0 = dense), flat
        # slots per ray (0 = [R, K] evals), dims of data["alpha_volume"]
        self.compact_k = 0
        self.compact_flat = 0
        self.alpha_shape = ()
        # golden-comparison hook: callable(iteration) -> (ray_idx, ray_idx_rand)
        # replacing the permutation samplers with an externally recorded stream
        self.sampler_override = None
        if getattr(args, "ckpt", None):
            sizes = self._resume(args.ckpt)
            if self.alpha_mask is not None and int(getattr(args, "compact_train", 0)):
                self._enable_train_compaction(sizes)
        self._refresh_app_frac()
        self.step_fn = make_train_step(self._statics(), device=self.device)
        S = self.step_fn.S
        print(f"memory policies: grad_accum {S.grad_accum}, remat {'on' if S.remat else 'off'}, "
              f"fused_passes {int(S.fused_passes)}, pass_chunk {S.pass_chunk}")

    def save_full(self, path: str):
        """Write a full training checkpoint: parameters, every Adam's moments
        and step counts, the generator's state, and both samplers' ids,
        cursors and numpy states. A run resumed from it continues the exact
        trajectory (the reference's resume restarts the static model and all
        optimizers, train.py:896-901)."""
        tree = {
            "params": {k: self.params[k] for k in ("static", "dynamic", "pose", "fov")},
            "opt": {name: _adam_state(opt) for name, opt in self.opt_state.items()},
            "gen_state": self.gen.get_state().numpy(),
            "sampler_ids": np.asarray(
                self.sampler.ids if self.sampler.ids is not None else np.zeros(0, np.int64)),
            "sampler2_ids": np.asarray(
                self.sampler2.ids if self.sampler2.ids is not None else np.zeros(0, np.int64)),
        }
        extra = {
            "iteration": self.iteration,
            "full_state": True,
            "sampler_curr": int(self.sampler.curr),
            "sampler2_curr": int(self.sampler2.curr),
            "sampler_rng": self.sampler.rng.bit_generator.state,
            "sampler2_rng": self.sampler2.rng.bit_generator.state,
            # the bucket sizes in use, so that a resumed run keeps them
            "compact_k": self.compact_k,
            "compact_flat": self.compact_flat,
        }
        save_checkpoint(path, tree, self.static_cfg, self.dynamic_cfg, self.aabb, extra=extra,
                        alpha_mask=self.alpha_mask)

    def _resume(self, ckpt_path: str):
        """Resume from a native checkpoint. A full one (`save_full`, this
        port's) restores the optimizers, the generator and the samplers too:
        an exact continuation. A plain one (the CLI's periodic saves, either
        package's) restores parameters, grids and iteration with fresh
        optimizers. Both replay the learning-rate and upsample schedule up to
        the checkpoint's iteration; the tables' layout is chosen anew from
        the checkpoint's configs ('auto' by table bytes). The checkpoint's
        occupancy mask is adopted. Returns the compaction bucket sizes (K,
        F) a full checkpoint of this port recorded, else None."""
        params, static_cfg, dynamic_cfg, aabb, extra, alpha = load_checkpoint(
            ckpt_path, return_alpha=True)
        if alpha is not None:
            self.alpha_mask = alpha.to(self.device)
        full = bool(extra.get("full_state"))
        if full and "gen_state" not in params:
            raise ValueError(f"{ckpt_path}: a full checkpoint of another package; resume "
                             "from a plain checkpoint or one this port wrote")
        self.static_cfg = static_cfg
        self.dynamic_cfg = dynamic_cfg
        self.aabb = torch.as_tensor(aabb, dtype=torch.float32, device=self.device)
        self.set_params(params["params"] if full else params)
        self.iteration = int(extra.get("iteration", 0))
        self.n_samples = min(
            self.args.nSamples, cal_n_samples(static_cfg.grid_size, self.args.step_ratio))
        if full:
            for name, opt in self.opt_state.items():
                _load_adam_state(opt, params.get("opt", {}).get(name), self.device)
            self.gen.set_state(torch.from_numpy(np.asarray(params["gen_state"], np.uint8)))
            for name, samp in (("sampler", self.sampler), ("sampler2", self.sampler2)):
                ids = np.asarray(params[f"{name}_ids"])
                samp.ids = ids if ids.size else None
                samp.curr = int(extra[f"{name}_curr"])
                samp.rng.bit_generator.state = extra[f"{name}_rng"]
        # replay the schedule (the upsample ends iteration i when i is in
        # upsamp_list, reference train.py:2582)
        for i in range(self.iteration):
            self.schedule.after_step(i)
            if i in self.args.upsamp_list:
                if self.n_voxel_list:
                    self.n_voxel_list.pop(0)
                self.schedule.on_upsample(i)
        if full and "compact_k" in extra:
            return int(extra["compact_k"]), int(extra["compact_flat"])
        return None

    def set_params(self, params):
        """Adopt a parameter tree (moved to this trainer's device as f32
        leaves that require grad) with fresh optimizers."""
        self.params = params_from_numpy(params_to_numpy(params), self.device)
        self.opt_state = init_opt_state(self.params)

    def _statics(self) -> StepStatics:
        a = self.args
        return StepStatics(
            static_cfg=self.static_cfg,
            dynamic_cfg=self.dynamic_cfg,
            H=self.H,
            W=self.W,
            n_cams=a.N_voxel_t,
            n_samples=self.n_samples,
            ray_type=a.ray_type,
            optimize_poses=bool(a.optimize_poses),
            optimize_focal=bool(a.optimize_focal_length),
            use_disp=bool(a.use_disp),
            n_iters=a.n_iters,
            upsamp0=a.upsamp_list[0],
            upsamp3=a.upsamp_list[3] if len(a.upsamp_list) > 3 else a.upsamp_list[-1],
            lr_factor=self.lr_factor,
            weights=LossWeights(
                distortion_static=a.distortion_weight_static,
                distortion_dynamic=a.distortion_weight_dynamic,
                monodepth_static=a.monodepth_weight_static,
                monodepth_dynamic=a.monodepth_weight_dynamic,
                small_scene_flow=a.small_scene_flow_weight,
                smooth_scene_flow=a.smooth_scene_flow_weight,
                l1=a.L1_weight_inital,
                ortho=a.Ortho_weight,
                tv_density=a.TV_weight_density,
                tv_app=a.TV_weight_app,
            ),
            step_size=self.static_cfg.step_size(np.asarray(self.scene.scene_bbox)),
            golden_det=bool(getattr(a, "golden_det", 0)),
            share_forward=bool(getattr(a, "share_forward", 1)),
            use_alpha_mask=self.compact_k > 0,
            alpha_shape=self.alpha_shape,
            compact_k=self.compact_k,
            compact_flat=self.compact_flat,
            remat=self._remat_policy(),
            fused_passes=bool(int(getattr(a, "fused_passes", 0))),
            pass_chunk=self._pass_chunk(),
            grad_accum=self._grad_accum(),
        )

    # The three policies below are the JAX trainer's, rule for rule
    # (rodynrf_tpu/train/trainer.py:316-388), budgets included: those were
    # measured against a 16 GB TPU's memory, not this card's.

    def _grad_accum(self) -> int:
        """Micro-batch count: explicit --grad_accum, else 4 on the
        640³-class schedules (N_voxel_final > 500³), 1 otherwise, raised
        until it divides the batch."""
        a = int(getattr(self.args, "grad_accum", 0))
        if a > 0:
            return a
        need = 4 if int(self.args.N_voxel_final) > 500 ** 3 else 1
        while int(self.args.batch_size) % need:
            need += 1
        return need

    def _gather_row_bytes(self) -> tuple:
        """(per-pass dynamic-evaluation gathered-row bytes, per-pass static):
        12 corner rows (3 orientations × 4 corners) × the packed channels per
        sample, density and blending on every sample, appearance scaled by
        the top-K fraction; the per-ray sample count is compact_k when
        train-time compaction is on."""
        S = self.compact_k if self.compact_k else self.n_samples
        B = int(self.args.batch_size)
        dt = 2 if self.dynamic_cfg.grid_sample_dtype == "bfloat16" else 4
        k = self.dynamic_cfg.app_topk(S)
        app_f = (k / S) if 0 < k < S else 1.0
        c_dyn = 3 * (sum(self.dynamic_cfg.density_n_comp) * 2
                     + sum(self.dynamic_cfg.app_n_comp) * app_f)
        c_st = sum(self.static_cfg.density_n_comp) + sum(self.static_cfg.app_n_comp) * app_f
        return B * S * 12 * c_dyn * dt, B * S * 12 * c_st * dt

    def _pass_chunk(self) -> int:
        """Passes per batched dynamic evaluation: one evaluation's gathered
        rows within an 8e9-byte budget."""
        per_pass, _ = self._gather_row_bytes()
        return max(1, int(8e9 // max(per_pass, 1)))

    def _remat_policy(self) -> bool:
        """--remat on/off, or 'auto': sequential passes store their
        activations except on 350³ < N_voxel_final schedules without 4-way
        accumulation; batched passes rematerialize when 0.65 × their
        estimated gathered rows exceed 9e9 bytes."""
        mode = getattr(self.args, "remat", "auto")
        if mode == "on":
            return True
        if mode == "off":
            return False
        if not int(getattr(self.args, "fused_passes", 0)):
            n = int(self.args.N_voxel_final)
            return 350 ** 3 < n and self._grad_accum() < 4
        per_dyn, per_st = self._gather_row_bytes()
        return (7 * per_dyn + 9 * per_st) * 0.65 > 9e9

    def table_layouts(self) -> Dict[str, object]:
        """The gather-table layout each field's step uses at the current grid
        ('strided' or 'merged'; 'auto' resolved by table bytes); with
        appearance compaction a field's split pack gives {"db": ..., "app":
        ...}, each part laid out on its own."""
        def layout(packed):
            if isinstance(packed, dict):
                return {k: v.meta["layout"] for k, v in packed.items()}
            return packed.meta["layout"]

        with torch.no_grad():
            return {
                "static": layout(stat_field.pack_tables(self.params["static"], self.static_cfg)),
                "dynamic": layout(dyn_field.pack_tables(self.params["dynamic"],
                                                        self.dynamic_cfg)),
            }

    def run_step(self) -> Dict[str, torch.Tensor]:
        """One iteration; returns the step's metrics (detached tensors). An
        iteration in `upsamp_list` ends with the voxel upsample, so the new
        grid is first used by the next iteration (the reference's in-body
        check, train.py:2582)."""
        i = self.iteration
        if self.sampler_override is not None:
            idx, idx_rand = self.sampler_override(i)
        else:
            idx, idx_rand = self.sampler.nextids(), self.sampler2.nextids()
        ray_idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(self.device)
        ray_idx_rand = torch.as_tensor(np.asarray(idx_rand), dtype=torch.int64).to(self.device)
        sc = {"iteration": i, "focal_fixed": self.focal_fixed, **self.schedule.scalars(i)}
        metrics = self.step_fn(
            self.params, self.opt_state, self.aabb, self.data, ray_idx, ray_idx_rand, self.gen, sc
        )
        self.schedule.after_step(i)
        self.iteration += 1
        cfg_changed = self._refresh_app_frac()
        if i in self.args.upsamp_list:
            self._upsample(i)
        elif cfg_changed:
            self._build_step()
        return metrics

    def _build_step(self):
        self.step_fn = make_train_step(self._statics(), device=self.device)

    def _app_start_eff(self) -> int:
        """First iteration with appearance compaction active (-1 = never).
        --app_start -1 (the default): the step after the first voxel
        upsample, when density has concentrated enough for the per-ray top-K
        bucket to hold the reference's above-threshold samples."""
        a = self.args
        if float(getattr(a, "app_frac", 0.0)) <= 0.0:
            return -1
        start = int(getattr(a, "app_start", -1))
        if start >= 0:
            return start
        ups = sorted(a.upsamp_list)
        return (int(ups[0]) + 1) if ups else 0

    def _refresh_app_frac(self) -> bool:
        """Set both configs' app_frac by the activation schedule; True if it
        changed (the caller rebuilds the step)."""
        eff = self._app_start_eff()
        af = float(self.args.app_frac) if (eff >= 0 and self.iteration >= eff) else 0.0
        if af == self.static_cfg.app_frac:
            return False
        self.static_cfg = dataclasses.replace(self.static_cfg, app_frac=af)
        self.dynamic_cfg = dataclasses.replace(self.dynamic_cfg, app_frac=af)
        return True

    def update_alpha_mask(self) -> float:
        """Rebuild the dual-field occupancy mask at the current parameters
        (reference updateAlphaMask contract, tensorBase.py:591-629; dual-max
        semantics, fields/alpha_mask.build_dual_alpha_mask). With
        --compact_train, also (re)sizes and enables the step's compaction
        against the fresh mask. Returns the occupied share of the volume."""
        params = {"static": self.params["static"], "dynamic": self.params["dynamic"]}
        self.alpha_mask = build_dual_alpha_mask(
            params, self.static_cfg, self.dynamic_cfg, self.aabb.cpu().numpy(),
            n_frames=self.scene.n_frames, thres=self.args.alpha_mask_thre,
        )
        occ = float(self.alpha_mask.alpha_volume.float().mean())
        print(f"alpha mask updated: grid {tuple(self.alpha_mask.alpha_volume.shape)} "
              f"occupancy {occ:.3f}")
        if int(getattr(self.args, "compact_train", 0)):
            self._enable_train_compaction()
        return occ

    def _dilated_volume(self) -> torch.Tensor:
        """The step's occupancy volume: the mask pre-dilated one extra 3³
        max-pool, so the single-gather nearest-voxel test keeps a superset of
        the reference's trilinear early-out (fields/alpha_mask
        .dilate_occupancy). Eval and render keep the trilinear mask."""
        return dilate_occupancy(self.alpha_mask.alpha_volume)

    def _probe_compact_k(self, stride: int = 3, margin: float = 1.1,
                         quantum: int = 16) -> tuple:
        """Size the step's buckets from the occupancy over a strided probe of
        every frame's pixels at the current cameras, jitter-free. Returns
        (K, flat_per_ray).

        K: the --compact_quantile (default 0.995) quantile of the per-ray
        occupied counts × margin, rounded up to `quantum`, in [quantum, S];
        rays above K drop their farthest occupied samples. flat_per_ray: the
        mean of the union occupancy (train time | an independent random
        time per ray, as the shared A/B/E geometry uses) plus 4 batch sigma,
        × margin, rounded up to 8. The random times come from
        np.random.default_rng(0), as in the JAX package, so both packages
        size the same buckets from the same scene and weights."""
        H, W, T = self.H, self.W, self.args.N_voxel_t
        S = self._statics()
        vol_d = self._dilated_volume()
        maabb = self.alpha_mask.aabb
        uu, vv = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
        pix = np.ascontiguousarray((vv * W + uu).reshape(-1).astype(np.int64))
        rng = np.random.default_rng(0)
        all_ts = self.data["ts"][:: H * W].cpu().numpy()  # one t per frame
        cs, cus = [], []
        with torch.no_grad():
            if S.optimize_focal:
                focal = focal_from_fov(self.params["fov"][0, 0], H, W)
            else:
                focal = self.aabb.new_tensor(self.focal_fixed)
            poses = pose_to_mtx(self.params["pose"])
            for t in range(T):
                idx = torch.as_tensor(t * H * W + pix, device=self.device)
                ts_rand = torch.as_tensor(rng.choice(all_ts, size=pix.shape[0]),
                                          device=self.device)
                rays, _, _, _ = _rays_from_idx(idx, poses, focal, S)
                xyz, _, valid = sample_xyz(rays, self.n_samples, S.ray_type,
                                           S.static_cfg.near_far, self.aabb, S.step_size, None)
                R_, S_ = valid.shape
                flat3 = xyz.reshape(-1, 3)
                occ = occupancy_nearest(vol_d, maabb, flat3, self.data["ts"][idx][:, None]
                                        .expand(R_, S_).reshape(-1)).reshape(R_, S_)
                occ_u = occ | occupancy_nearest(
                    vol_d, maabb, flat3, ts_rand[:, None].expand(R_, S_).reshape(-1)
                ).reshape(R_, S_)
                cs.append((valid & occ).sum(1).cpu().numpy())
                cus.append((valid & occ_u).sum(1).cpu().numpy())
        counts, counts_u = np.concatenate(cs), np.concatenate(cus)
        q = float(getattr(self.args, "compact_quantile", 0.995))
        c_q = float(np.quantile(counts, min(max(q, 0.0), 1.0)))
        K = int(-(-c_q * margin // quantum) * quantum)
        K = min(max(K, quantum), self.n_samples)
        B = max(int(self.args.batch_size), 1)
        f_budget = (counts_u.mean() + 4.0 * counts_u.std() / np.sqrt(B)) * margin
        F = int(-(-f_budget // 8) * 8)
        F = min(max(F, 8), self.n_samples)
        print(f"compaction probe: occupied mean {counts.mean():.1f} "
              f"(union {counts_u.mean():.1f}) p{100 * q:g} {c_q:.0f} "
              f"max {counts_u.max()} of {self.n_samples} samples/ray -> K={K} flat={F}")
        return K, F

    def _enable_train_compaction(self, sizes=None):
        """Wire the mask into the step: the dilated volume rides flat in
        `data`, K and F come from the probe (or `sizes`, those a full
        checkpoint recorded), and the step is rebuilt. Stays dense when K
        would not shrink the sample axis by at least 15%; the flat bucket is
        used only when F < 0.85 K."""
        K, F = sizes if sizes is not None else self._probe_compact_k()
        self.data = {k: v for k, v in self.data.items() if not k.startswith("alpha_")}
        if K <= 0 or K >= self.n_samples or K > 0.85 * self.n_samples:
            self.compact_k = self.compact_flat = 0
            self.alpha_shape = ()
            print(f"train compaction disabled (K={K} of {self.n_samples})")
        else:
            vol_d = self._dilated_volume()
            self.alpha_shape = tuple(int(s) for s in vol_d.shape)
            self.data["alpha_volume"] = vol_d.reshape(-1)
            self.data["alpha_aabb"] = self.alpha_mask.aabb
            self.compact_k = K
            if sizes is not None:
                self.compact_flat = F
            else:
                self.compact_flat = (F if int(getattr(self.args, "compact_flat", 1))
                                     and F < 0.85 * K else 0)
            print(f"train compaction enabled: K={K} flat={self.compact_flat} "
                  f"of {self.n_samples} samples/ray")
        self._build_step()

    def _upsample(self, iteration: int):
        """Coarse-to-fine grid growth (reference: train.py:2582-2606). The
        fields' Adam starts fresh (train.py:2606 recreates the main
        optimizer); the pose and fov Adams and their moments survive, as in
        the reference (only their lr is touched, 2592-2595). The step is
        rebuilt for the new sample count and grid."""
        n_voxels = self.n_voxel_list.pop(0)
        reso = n_to_reso(n_voxels, self.scene.scene_bbox)
        self.n_samples = min(self.args.nSamples, cal_n_samples(reso, self.args.step_ratio))
        with torch.no_grad():
            static = stat_field.upsample_static_field(self.params["static"], reso)
            dynamic = dyn_field.upsample_dynamic_field(self.params["dynamic"], reso)
        for _, t in named_leaves((static, dynamic)):
            t.requires_grad_(True)  # the resized planes and lines: new leaves
        self.params = dict(self.params, static=static, dynamic=dynamic)
        self.static_cfg = self.static_cfg.with_grid(reso)
        self.dynamic_cfg = self.dynamic_cfg.with_grid(reso)
        self.schedule.on_upsample(iteration)
        fresh = init_opt_state(self.params)
        self.opt_state = dict(self.opt_state, fields=fresh["fields"])
        if self.compact_k:
            # the buckets were sized for the old sample count: re-probe the
            # (unchanged) mask at the new one
            self._enable_train_compaction()
        else:
            self._build_step()

    def train(self, n_steps: Optional[int] = None, log_every: int = 100, logger=None):
        """Run n_steps (default: to n_iters), rebuilding the occupancy mask
        after each iteration whose number (counted from 1) is in
        update_AlphaMask_list, as the CLI's loop does. `logger`, if given,
        gets a dict of host floats every `log_every` iterations and after
        the first, the only points at which metrics are read back from the
        device. Returns the last step's metrics as host floats."""
        n = n_steps if n_steps is not None else self.args.n_iters - self.iteration
        updates = set(self.args.update_AlphaMask_list or [])
        t0 = time.time()
        metrics = {}
        for _ in range(n):
            metrics = self.run_step()
            if self.iteration in updates:
                self.update_alpha_mask()
            if logger is not None and (self.iteration % log_every == 0 or self.iteration == 1):
                host = {k: float(v) for k, v in metrics.items()}
                host["iter"] = self.iteration
                host["elapsed"] = time.time() - t0
                logger(host)
        return {k: float(v) for k, v in metrics.items()}


def _adam_state(opt: torch.optim.Adam):
    """One Adam's per-parameter state, in its parameter order: [{step,
    exp_avg, exp_avg_sq}], or [] before its first step."""
    ps = [p for g in opt.param_groups for p in g["params"]]
    if not all(p in opt.state and opt.state[p] for p in ps):
        return []
    return [{k: opt.state[p][k] for k in ("step", "exp_avg", "exp_avg_sq")} for p in ps]


def _load_adam_state(opt: torch.optim.Adam, saved, device):
    ps = [p for g in opt.param_groups for p in g["params"]]
    if not saved:
        return
    if len(saved) != len(ps):
        raise ValueError(f"optimizer state for {len(saved)} parameters, not {len(ps)}")
    for p, st in zip(ps, saved):
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(st["step"])), dtype=torch.float32),
            "exp_avg": torch.as_tensor(st["exp_avg"], dtype=torch.float32, device=device).clone(),
            "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"], dtype=torch.float32,
                                          device=device).clone(),
        }
