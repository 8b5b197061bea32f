"""Trainer: owns params, optimizers, schedules and the train step (port of
rodynrf_tpu/train/trainer.py, `__init__` and `run_step`; reference
train.py:824-2658).

What this slice of the port lacks is refused with NotImplementedError
rather than ignored: bf16 gather tables, the merged table layout, batched
passes, rematerialization, gradient accumulation, train-time compaction,
appearance compaction, more than one device, resuming, and the voxel
upsample at an `upsamp_list` iteration.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.scene import SceneData, default_focal
from ..fields import FieldConfig, cal_n_samples, n_to_reso
from ..fields.dynamic import init_dynamic_field
from ..fields.static import init_static_field
from .convert import params_from_numpy, params_to_numpy
from .schedule import LrSchedule, PermutationSampler
from .step import LossWeights, StepStatics, check_device, init_opt_state, make_train_step


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


def _refuse_unported(args, device: torch.device):
    """NotImplementedError for every option this slice does not implement."""
    def no(what):
        raise NotImplementedError(f"{what} is not ported to rodynrf_tpu_torch yet (ROADMAP.md)")

    if int(getattr(args, "bf16", 0)):
        no("--bf16 1 (bfloat16 gather tables); pass --bf16 0")
    if getattr(args, "vm_layout", "auto") == "merged":
        no("--vm_layout merged")
    if int(getattr(args, "fused_passes", 0)):
        no("--fused_passes 1")
    if getattr(args, "remat", "auto") == "on":
        no("--remat on")
    if int(getattr(args, "grad_accum", 0)) > 1:
        no("--grad_accum > 1")
    if int(getattr(args, "compact_train", 0)):
        no("--compact_train 1")
    if float(getattr(args, "app_frac", 0.0)) > 0.0:
        no("--app_frac > 0 (appearance compaction)")
    if int(getattr(args, "shard_grids", 0)):
        no("--shard_grids 1")
    if getattr(args, "grad_impl", "autodiff") != "autodiff":
        no(f"--grad_impl {args.grad_impl} (the port has one table-gradient route, "
           "the coalesce kernel)")
    if getattr(args, "ckpt", None):
        no("resuming from --ckpt")
    n_dev = int(getattr(args, "n_devices", 0))
    if n_dev == 0 and device.type == "cuda":
        n_dev = torch.cuda.device_count()
    if n_dev > 1:
        no(f"data parallelism over {n_dev} devices; pass --n_devices 1")


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
            "static": init_static_field(self.gen, self.static_cfg),
            "dynamic": init_dynamic_field(self.gen, self.dynamic_cfg),
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
        )
        self.sampler = PermutationSampler(scene.n_rays, args.batch_size, args.seed)
        self.sampler2 = PermutationSampler(scene.n_rays, args.batch_size, args.seed + 1)

        self.data = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in scene.device_arrays().items()
        }
        self.focal_fixed = float(scene.focal if scene.focal is not None else default_focal(W, H))
        self.iteration = 0
        self.step_fn = make_train_step(self._statics(), device=self.device)

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

    def run_step(self) -> Dict[str, torch.Tensor]:
        """One iteration; returns the step's metrics (detached tensors)."""
        i = self.iteration
        if i in self.args.upsamp_list:
            raise NotImplementedError(
                f"iteration {i} ends with a voxel upsample, which is not ported to "
                "rodynrf_tpu_torch yet (ROADMAP.md)"
            )
        ray_idx = torch.as_tensor(self.sampler.nextids(), dtype=torch.int64).to(self.device)
        ray_idx_rand = torch.as_tensor(self.sampler2.nextids(), dtype=torch.int64).to(self.device)
        sc = {"iteration": i, "focal_fixed": self.focal_fixed, **self.schedule.scalars(i)}
        metrics = self.step_fn(
            self.params, self.opt_state, self.aabb, self.data, ray_idx, ray_idx_rand, self.gen, sc
        )
        self.schedule.after_step(i)
        self.iteration += 1
        return metrics
