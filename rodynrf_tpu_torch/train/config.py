"""CLI/config-file surface (port of rodynrf_tpu/train/config.py): the same
flag set, so `configs/*.txt` parse verbatim in both packages.

Reads the reference's flat ``key = value`` config files (reference:
opt.py:6-242) including ``--config`` + CLI overrides and ``[a, b, c]`` list
syntax. Flags this slice of the port does not implement are parsed here and
refused by the trainer (train/trainer.py), never ignored.
"""

from __future__ import annotations

import argparse
import shlex
from typing import List, Optional, Sequence


def _strip_comment(line: str) -> str:
    out = []
    for part in line.split("#"):
        out.append(part)
        break
    return out[0]


def _parse_config_file(path: str) -> List[str]:
    """Flat `key = value` file -> argv fragments (reference config format)."""
    argv: List[str] = []
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw).strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key, val = key.strip(), val.strip()
            if val.startswith("[") and val.endswith("]"):
                items = [v.strip() for v in val[1:-1].split(",") if v.strip()]
                for item in items:
                    argv += [f"--{key}", item]
            else:
                argv += [f"--{key}", val]
    return argv


def config_parser(cmd: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Argument surface mirroring reference opt.py:6-242."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="config file path")
    parser.add_argument("--expname", type=str)
    parser.add_argument("--basedir", type=str, default="./log")
    parser.add_argument("--tblogdir", type=str, default=None)
    parser.add_argument("--add_timestamp", type=int, default=0)
    parser.add_argument("--datadir", type=str, default="./data/llff/fern")
    parser.add_argument("--progress_refresh_rate", type=int, default=10)

    parser.add_argument("--with_depth", action="store_true")
    parser.add_argument("--downsample_train", type=float, default=1.0)
    parser.add_argument("--downsample_test", type=float, default=1.0)

    parser.add_argument(
        "--model_name",
        type=str,
        default="TensorVMSplit",
        choices=["TensorVMSplit", "TensorCP", "TensorVMVt", "TensorMMt", "TensorVMSplit_TimeEmbedding"],
    )

    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--n_iters", type=int, default=30000)
    parser.add_argument("--dataset_name", type=str, default="nvidia",
                        choices=["nvidia", "davis", "synthetic"])

    parser.add_argument("--lr_init", type=float, default=0.02)
    parser.add_argument("--lr_basis", type=float, default=1e-3)
    parser.add_argument("--lr_decay_iters", type=int, default=-1)
    parser.add_argument("--lr_decay_target_ratio", type=float, default=0.1)
    parser.add_argument("--lr_upsample_reset", type=int, default=1)

    parser.add_argument("--L1_weight_inital", type=float, default=0.0)
    parser.add_argument("--L1_weight_rest", type=float, default=0.0)
    parser.add_argument("--Ortho_weight", type=float, default=0.0)
    parser.add_argument("--TV_weight_density", type=float, default=0.0)
    parser.add_argument("--TV_weight_app", type=float, default=0.0)
    parser.add_argument("--distortion_weight_static", type=float, default=0.0)
    parser.add_argument("--distortion_weight_dynamic", type=float, default=0.0)
    parser.add_argument("--monodepth_weight_static", type=float, default=0.04)
    parser.add_argument("--monodepth_weight_dynamic", type=float, default=0.04)
    parser.add_argument("--smooth_scene_flow_weight", type=float, default=0.1)
    parser.add_argument("--small_scene_flow_weight", type=float, default=0.1)

    parser.add_argument("--n_lamb_sigma", type=int, action="append")
    parser.add_argument("--n_lamb_sh", type=int, action="append")
    parser.add_argument("--data_dim_color", type=int, default=27)

    parser.add_argument("--rm_weight_mask_thre", type=float, default=0.0001)
    parser.add_argument("--alpha_mask_thre", type=float, default=0.0001)
    parser.add_argument("--distance_scale", type=float, default=25.0)
    parser.add_argument("--density_shift", type=float, default=-10.0)

    parser.add_argument("--shadingMode", type=str, default="MLP_PE")
    parser.add_argument("--shadingModeStatic", type=str, default="MLP_Fea_TimeEmbedding")
    parser.add_argument("--pos_pe", type=int, default=6)
    parser.add_argument("--view_pe", type=int, default=6)
    parser.add_argument("--fea_pe", type=int, default=6)
    parser.add_argument("--featureC", type=int, default=128)

    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--render_only", type=int, default=0)
    parser.add_argument("--render_test", type=int, default=0)
    parser.add_argument("--render_train", type=int, default=0)
    parser.add_argument("--render_path", type=int, default=0)
    parser.add_argument("--export_mesh", type=int, default=0)
    parser.add_argument("--no_tensorboard", type=int, default=0)

    parser.add_argument("--lindisp", default=False, action="store_true")
    parser.add_argument("--perturb", type=float, default=1.0)
    parser.add_argument("--accumulate_decay", type=float, default=0.998)
    parser.add_argument("--fea2denseAct", type=str, default="softplus")
    parser.add_argument("--ray_type", type=str, default="ndc", choices=["ndc", "contract"])
    parser.add_argument("--nSamples", type=int, default=int(1e6))
    parser.add_argument("--step_ratio", type=float, default=0.5)

    parser.add_argument("--white_bkgd", action="store_true")
    parser.add_argument("--N_voxel_init", type=int, default=100**3)
    parser.add_argument("--N_voxel_final", type=int, default=300**3)
    parser.add_argument("--N_voxel_t", type=int, default=12)
    parser.add_argument("--upsamp_list", type=int, action="append")
    parser.add_argument("--update_AlphaMask_list", type=int, action="append")

    parser.add_argument("--idx_view", type=int, default=0)
    parser.add_argument("--N_vis", type=int, default=5)
    parser.add_argument("--vis_every", type=int, default=10000)
    parser.add_argument("--vis_train_every", type=int, default=2000)
    parser.add_argument("--optimize_poses", type=int, default=0)
    parser.add_argument("--optimize_focal_length", type=int, default=0)
    parser.add_argument("--with_GT_poses", type=int, default=0)
    parser.add_argument("--multiview_dataset", type=int, default=0)
    parser.add_argument("--use_disp", type=int, default=0)
    parser.add_argument(
        "--use_foreground_mask", type=str, default="motion_masks",
        choices=["motion_masks", "epipolar_motion_masks", "epipolar_error_png"],
    )
    parser.add_argument("--use_time_embedding", type=int, default=0)
    parser.add_argument("--time_embedding_size", type=int, default=4)
    parser.add_argument("--save_poses_bounds", type=int, default=0)

    # framework flags of the JAX package, absent from the reference
    parser.add_argument("--n_devices", type=int, default=0,
                        help="data-parallel devices, one process each (0 = every card, "
                        "or the process group the caller started)")
    parser.add_argument("--seed", type=int, default=20211202)
    parser.add_argument("--bf16", type=int, default=1,
                        help="bfloat16 gather tables (0 = f32)")
    parser.add_argument("--shard_grids", type=int, default=0,
                        help="shard plane grids and their Adam moments over the data "
                        "mesh (parallel/mesh.py)")
    parser.add_argument("--vm_layout", type=str, default="auto",
                        choices=["auto", "merged", "strided"],
                        help="multiscale gather-table layout (ops/fused_vm.py)")
    parser.add_argument("--grad_impl", type=str, default="autodiff",
                        choices=["autodiff", "xla", "csum"],
                        help="plane-table gradient implementation of the JAX package")
    parser.add_argument("--share_forward", type=int, default=1,
                        help="passes A/B/E share one sample set and A/B reuse E's "
                        "static field eval detached (exact)")
    parser.add_argument("--fused_passes", type=int, default=0,
                        help="batch all render passes into shared field evals")
    parser.add_argument("--app_frac", type=float, default=0.0,
                        help="fixed-bucket appearance compaction fraction (0 = dense)")
    parser.add_argument("--app_start", type=int, default=-1,
                        help="iteration from which appearance compaction is active")
    parser.add_argument("--grad_accum", type=int, default=0,
                        help="gradient-accumulation micro-batches per step (0 = auto)")
    parser.add_argument("--remat", type=str, default="auto", choices=["auto", "on", "off"],
                        help="rematerialize field evals in backward")
    parser.add_argument("--export_th", type=int, default=1,
                        help="also export torch-compatible .th checkpoints")
    parser.add_argument("--compact_eval", type=int, default=1,
                        help="render/eval: compact occupied samples per ray")
    parser.add_argument("--alpha_mask", type=str, default="",
                        help="path to a packed occupancy mask .npz for eval early-out")
    parser.add_argument("--compact_train", type=int, default=0,
                        help="train-time occupancy compaction")
    parser.add_argument("--compact_flat", type=int, default=1,
                        help="with --compact_train: flat-bucket field evals")
    parser.add_argument("--compact_quantile", type=float, default=0.995,
                        help="per-ray occupancy quantile sizing the compaction bucket")

    cmd = list(cmd) if cmd is not None else None
    # pre-pass: expand --config file into defaults, CLI overrides win
    pre, _ = parser.parse_known_args(cmd)
    if pre.config:
        file_argv = _parse_config_file(pre.config)
        merged = file_argv + (cmd if cmd is not None else __import__("sys").argv[1:])
        args = parser.parse_args(merged)
    else:
        args = parser.parse_args(cmd)

    if args.n_lamb_sigma is None:
        args.n_lamb_sigma = [16, 4, 4]
    if args.n_lamb_sh is None:
        args.n_lamb_sh = [48, 12, 12]
    if args.upsamp_list is None:
        args.upsamp_list = [2000, 4000, 6000, 8000, 12000, 16000, 22000]
    if args.update_AlphaMask_list is None:
        args.update_AlphaMask_list = [300000000]
    return args


def parse_cmd(cmd: str) -> argparse.Namespace:
    return config_parser(shlex.split(cmd))
