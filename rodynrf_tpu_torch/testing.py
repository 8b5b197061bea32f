"""Shared tiny-shape fixtures for the port's tests and smoke runs.

The shapes are the JAX package's (rodynrf_tpu/testing.py), so a test can
build both packages from one command line and one scene and compare them.
"""

from __future__ import annotations

import contextlib

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
        f"--bf16 0"  # f32 tables: the parity tests compare at float tolerances
    )


def tiny_scene(ray_type: str = "ndc"):
    from .data import make_synthetic_scene

    return make_synthetic_scene(T=TINY["T"], H=TINY["H"], W=TINY["W"], ray_type=ray_type)


def inject_reference_init(trainer, golden_out: str):
    """Replace the trainer's random fields with the reference's own initial
    state dicts (`<golden_out>/init_{static,dynamic}.th`, recorded by
    golden/run_reference.py), with fresh optimizers: the start of the golden
    comparison (GOLDEN.md). The cameras keep the trainer's initial values."""
    import os

    import numpy as np

    from .train.checkpoints import import_th
    from .train.convert import params_to_numpy

    tree = params_to_numpy(trainer.params)
    for name in ("static", "dynamic"):
        ref, _ = import_th(os.path.join(golden_out, f"init_{name}.th"))
        for key in ref:
            if key not in tree[name]:
                raise KeyError(f"{name}: unknown parameter {key}")
        for i in range(3):
            a = np.asarray(ref["density_plane"][i]).shape
            b = tree[name]["density_plane"][i].shape
            if a != b:
                raise ValueError(f"{name} density_plane[{i}]: reference {a} vs the trainer's {b}")
        tree[name].update(ref)
    trainer.set_params(tree)


def golden_trainer(repo: str, device: str = "cpu"):
    """The golden comparison's trainer: `golden/tiny.txt` on the committed
    fixture, deterministic draws (golden_det), the reference's initial
    fields. Returns (trainer, scene)."""
    import os

    from .data.video_dataset import load_nvidia_scene
    from .train import Trainer, config_parser

    out = os.path.join(repo, "golden", "out")
    args = config_parser(["--config", os.path.join(repo, "golden", "tiny.txt"),
                          "--datadir", os.path.join(out, "fixture")])
    args.golden_det = 1
    scene = load_nvidia_scene(args.datadir, downsample=1.0, use_disp=True,
                              use_foreground_mask="motion_masks", with_gt_poses=True,
                              ray_type="ndc")
    trainer = Trainer(args, scene, device=device)
    inject_reference_init(trainer, out)
    return trainer, scene


def write_video_scene(root: str, T: int, H: int, W: int, seed: int = 0):
    """Write a synthetic scene of T frames at H×W in the Nvidia on-disk
    layout, with the port's own PNG writer: images/%03d.png (the synthetic
    scene's frames with seeded texture), motion_masks/%03d.png (gray),
    disp/%03d.npy, flow/%03d_{fwd,bwd}.npz (flow + a seeded consistency
    mask) and poses_bounds.npy. Returns the in-memory scene it was made
    from."""
    import os

    import numpy as np

    from .data import make_synthetic_scene
    from .data.imageio import write_png

    scene = make_synthetic_scene(T=T, H=H, W=W)
    rng = np.random.default_rng(seed)
    for sub in ("images", "motion_masks", "disp", "flow"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rgbs = scene.rgbs.reshape(T, H, W, 3)
    fg = scene.fg_masks.reshape(T, H, W)
    disps = scene.disps.reshape(T, H, W)
    flows = {"fwd": scene.flows_f.reshape(T, H, W, 2), "bwd": scene.flows_b.reshape(T, H, W, 2)}
    for t in range(T):
        img = np.clip(rgbs[t] + rng.normal(0.0, 0.05, rgbs[t].shape), 0.0, 1.0)
        write_png(os.path.join(root, "images", f"{t:03d}.png"), (img * 255).astype(np.uint8))
        write_png(os.path.join(root, "motion_masks", f"{t:03d}.png"),
                  (fg[t] * 255).astype(np.uint8))
        np.save(os.path.join(root, "disp", f"{t:03d}.npy"), disps[t])
        for kind, ok in (("fwd", t < T - 1), ("bwd", t > 0)):
            if ok:
                mask = (rng.random((H, W)) > 0.1).astype(np.float32)
                np.savez(os.path.join(root, "flow", f"{t:03d}_{kind}.npz"),
                         flow=flows[kind][t], mask=mask)
    # LLFF poses_bounds: [down, right, back, t | h w f] per frame + near/far
    c2w = scene.poses
    llff = np.concatenate([-c2w[..., 1:2], c2w[..., 0:1], c2w[..., 2:4]], -1)
    hwf = np.broadcast_to(np.array([H, W, scene.focal], np.float32)[None, :, None], (T, 3, 1))
    bounds = np.tile(np.array([[0.5, 5.0]], np.float32), (T, 1))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([np.concatenate([llff, hwf], -1).reshape(T, 15), bounds], 1))
    return scene


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the body with `n` intra-op CPU threads, restoring the count after.
    The TINY shapes gain nothing from more, and parallel test workers that
    each start one thread per core oversubscribe the machine."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
