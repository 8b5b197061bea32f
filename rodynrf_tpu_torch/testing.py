"""Shared tiny-shape fixtures for the port's tests and smoke runs.

The shapes are the JAX package's (rodynrf_tpu/testing.py), so a test can
build both packages from one command line and one scene and compare them.
"""

from __future__ import annotations

TINY = dict(T=4, H=16, W=16, batch=64, n_samples=16)


def tiny_cmd(ray_type: str = "ndc", optimize: int = 1, batch: int | None = None) -> str:
    b = batch if batch is not None else TINY["batch"]
    return (
        f"--expname tiny --datadir none --dataset_name synthetic "
        f"--n_iters 32 --batch_size {b} --N_voxel_t {TINY['T']} "
        f"--N_voxel_init 512 --N_voxel_final 1000 "
        f"--upsamp_list 8 --upsamp_list 12 --upsamp_list 16 --upsamp_list 20 "
        f"--nSamples {TINY['n_samples']} --step_ratio 2.0 --ray_type {ray_type} "
        f"--model_name TensorVMSplit_TimeEmbedding --shadingMode MLP_Fea_late_view "
        f"--shadingModeStatic MLP_Fea "
        f"--n_lamb_sigma 4 --n_lamb_sigma 2 --n_lamb_sigma 2 "
        f"--n_lamb_sh 8 --n_lamb_sh 4 --n_lamb_sh 4 "
        f"--fea2denseAct relu --view_pe 0 --fea_pe 0 "
        f"--TV_weight_density 0.1 --TV_weight_app 0.01 --L1_weight_inital 8e-5 "
        f"--distortion_weight_static 0.02 --distortion_weight_dynamic 0.005 "
        f"--optimize_poses {optimize} --optimize_focal_length {optimize} --use_disp 1 "
        f"--bf16 0"  # f32 tables: the port's slice is the f32 step
    )


def tiny_scene(ray_type: str = "ndc"):
    from .data import make_synthetic_scene

    return make_synthetic_scene(T=TINY["T"], H=TINY["H"], W=TINY["W"], ray_type=ray_type)
