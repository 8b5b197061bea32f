"""Trainer: owns params, optimizers, schedules and the train step (port of
rodynrf_tpu/train/trainer.py: `__init__`, `run_step`, `_upsample`, `train`,
`save_full` and `_resume`; reference train.py:824-2658).

Runs the JAX package's default recipe: bf16 or f32 gather tables, the
strided or merged table layout ('auto' picks per field by table bytes), and
the voxel upsample at every `upsamp_list` iteration, after which the layout
is chosen anew. Resumes from a native checkpoint (`--ckpt`): a full one
(`save_full`) continues the exact trajectory, a plain one restarts the
optimizers and replays the schedule. What the port lacks is refused with
NotImplementedError rather than ignored, naming the ROADMAP.md queue 1 item
that brings it: batched passes, rematerialization, gradient accumulation,
train-time and appearance compaction, occupancy-mask updates, sharded
grids, the table-gradient routes other than the kernels, and more than one
device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.scene import SceneData, default_focal
from ..fields import FieldConfig, cal_n_samples, n_to_reso
from ..fields import dynamic as dyn_field
from ..fields import static as stat_field
from .checkpoints import load_checkpoint, save_checkpoint
from .convert import params_from_numpy, params_to_numpy
from .schedule import LrSchedule, PermutationSampler, n_voxel_schedule
from .step import (
    LossWeights,
    StepStatics,
    check_device,
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


# ROADMAP.md queue 1 items that bring what the port refuses
COMPACTION = "ROADMAP.md queue 1, item 2: compaction"
MESH_LPIPS = "ROADMAP.md queue 1, item 3: mesh export and LPIPS"
PARALLELISM = "ROADMAP.md queue 1, item 4: parallelism"


def not_ported(what: str, item: str = "ROADMAP.md"):
    raise NotImplementedError(f"{what} is not ported to rodynrf_tpu_torch yet ({item})")


def _refuse_unported(args, device: torch.device):
    """NotImplementedError for every option the port does not implement."""
    if int(getattr(args, "fused_passes", 0)):
        not_ported("--fused_passes 1", PARALLELISM)
    if getattr(args, "remat", "auto") == "on":
        not_ported("--remat on", PARALLELISM)
    if int(getattr(args, "grad_accum", 0)) > 1:
        not_ported("--grad_accum > 1", PARALLELISM)
    if int(getattr(args, "compact_train", 0)):
        not_ported("--compact_train 1", COMPACTION)
    if float(getattr(args, "app_frac", 0.0)) > 0.0:
        not_ported("--app_frac > 0 (appearance compaction)", COMPACTION)
    updates = [i for i in (getattr(args, "update_AlphaMask_list", None) or [])
               if 0 < int(i) <= int(args.n_iters)]
    if updates:
        not_ported(f"the occupancy-mask update at iteration {updates[0]} "
                   "(update_AlphaMask_list)", COMPACTION)
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
        # golden-comparison hook: callable(iteration) -> (ray_idx, ray_idx_rand)
        # replacing the permutation samplers with an externally recorded stream
        self.sampler_override = None
        if getattr(args, "ckpt", None):
            self._resume(args.ckpt)
        self.step_fn = make_train_step(self._statics(), device=self.device)

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
        }
        save_checkpoint(path, tree, self.static_cfg, self.dynamic_cfg, self.aabb, extra=extra)

    def _resume(self, ckpt_path: str):
        """Resume from a native checkpoint. A full one (`save_full`, this
        port's) restores the optimizers, the generator and the samplers too:
        an exact continuation. A plain one (the CLI's periodic saves, either
        package's) restores parameters, grids and iteration with fresh
        optimizers. Both replay the learning-rate and upsample schedule up to
        the checkpoint's iteration; the tables' layout is chosen anew from
        the checkpoint's configs ('auto' by table bytes)."""
        params, static_cfg, dynamic_cfg, aabb, extra, alpha = load_checkpoint(
            ckpt_path, return_alpha=True)
        if alpha is not None:
            not_ported("resuming with an occupancy mask", COMPACTION)
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
        )

    def table_layouts(self) -> Dict[str, str]:
        """The gather-table layout each field's step uses at the current grid
        ('strided' or 'merged'; 'auto' resolved by table bytes)."""
        with torch.no_grad():
            return {
                "static": stat_field.pack_tables(
                    self.params["static"], self.static_cfg).meta["layout"],
                "dynamic": dyn_field.pack_tables(
                    self.params["dynamic"], self.dynamic_cfg).meta["layout"],
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
        if i in self.args.upsamp_list:
            self._upsample(i)
        return metrics

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
        self.step_fn = make_train_step(self._statics(), device=self.device)

    def train(self, n_steps: Optional[int] = None, log_every: int = 100, logger=None):
        """Run n_steps (default: to n_iters). `logger`, if given, gets a dict
        of host floats every `log_every` iterations and after the first,
        the only points at which metrics are read back from the device.
        Returns the last step's metrics as host floats."""
        n = n_steps if n_steps is not None else self.args.n_iters - self.iteration
        t0 = time.time()
        metrics = {}
        for _ in range(n):
            metrics = self.run_step()
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
