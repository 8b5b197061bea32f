"""The port's command line (port of the JAX package's `train.py`): the same
flags and config files, the same dispatch (reconstruction | --render_only;
reference train.py:2661-2675).

    python -m rodynrf_tpu_torch --config configs/Nvidia_no_poses.txt
    python -m rodynrf_tpu_torch --config ... --render_only 1 --render_test 1 --render_path 1

`main(argv, device="cuda")` is the entry point; it runs on the card and
refuses without one unless the caller passes device="cpu". Occupancy masks
work as in train.py: `update_AlphaMask_list` builds one during training
(and with --compact_train 1 the step compacts against it), checkpoints
carry it, and the evaluations render with it (--compact_eval 1, the
default: the flat-bucket compact renderer); --alpha_mask <npz> renders a
checkpoint with a standalone mask. --export_mesh 1 writes the dynamic
field's surface from --ckpt X.npz as X.ply and trains nothing (it renders
too if --render_only asks). mean.txt carries LPIPS where weights are given
($LPIPS_WEIGHTS_DIR; eval/metrics.rgb_lpips).
Each function returns a small report (timings, PSNRs, paths) besides
writing what train.py writes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .core.se3 import pose_to_mtx
from .data.video_dataset import load_scene
from .eval.evaluation import evaluate, export_poses_bounds
from .eval.mesh import export_mesh_from_ckpt
from .eval.paths import evaluation_path, generate_path
from .fields.alpha_mask import load_alpha_npz
from .fields.config import FieldConfig, cal_n_samples
from .render.renderer import make_chunk_renderer
from .train.checkpoints import export_th, import_th, load_checkpoint, save_checkpoint
from .train.config import config_parser
from .train.convert import params_from_numpy
from .train.step import check_device
from .train.trainer import Trainer


class _DummyWriter:
    def add_scalar(self, *a, **k): ...
    def add_images(self, *a, **k): ...
    def close(self): ...


def _tb_writer(logfolder, disabled):
    """TensorBoard's SummaryWriter, or a writer that drops everything when
    disabled or when tensorboard is not installed."""
    if disabled:
        return _DummyWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logfolder)
    except Exception:
        return _DummyWriter()


def _current_cameras(trainer):
    """(poses [T, 3, 4] numpy, focal) of the trainer, computed on the CPU
    as `render_test` computes them from the saved checkpoint, so the final
    evaluation and a later render of the checkpoint see the same cameras."""
    with torch.no_grad():
        poses_mtx = pose_to_mtx(trainer.params["pose"].detach().cpu()).numpy()
    if trainer.args.optimize_focal_length:
        fov = float(trainer.params["fov"].detach().cpu()[0, 0])
        focal = max(trainer.H, trainer.W) / 2.0 / np.tan(fov)
    else:
        focal = trainer.focal_fixed
    return poses_mtx, float(focal)


def _save_ckpts(trainer, logfolder, expname):
    """`{expname}.npz` (+ the `.th` pair with --export_th 1). Returns
    (seconds, bytes of the .npz)."""
    t0 = time.perf_counter()
    poses_mtx, focal = _current_cameras(trainer)
    path = f"{logfolder}/{expname}.npz"
    save_checkpoint(
        path,
        {k: trainer.params[k] for k in ("static", "dynamic", "pose", "fov")},
        trainer.static_cfg, trainer.dynamic_cfg, trainer.aabb,
        extra={"focal": focal, "iteration": trainer.iteration},
        alpha_mask=trainer.alpha_mask,
    )
    if trainer.args.export_th:
        export_th(f"{logfolder}/{expname}.th", trainer.params["dynamic"], trainer.dynamic_cfg,
                  trainer.aabb, poses_mtx, focal, dynamic=True, alpha_mask=trainer.alpha_mask)
        export_th(f"{logfolder}/{expname}_static.th", trainer.params["static"],
                  trainer.static_cfg, trainer.aabb, poses_mtx, focal, dynamic=False)
    return time.perf_counter() - t0, os.path.getsize(path)


def _tb_vis_images(trainer, scene, args, writer, it):
    """Render test views into TensorBoard with the reference's image
    families (reference: train.py:2428-2580 + renderer.py:318-657):
    rgb/depth full+static+dynamic, blending, GT rgb/flow/mask, induced
    dynamic & static fwd/bwd flows, Δxyz map, monodepth."""
    from .eval.metrics import visualize_depth_numpy
    from .render.renderer import make_vis_chunk_renderer, render_image_vis
    from .utils.flow_viz import flow_to_image

    H, W = trainer.H, trainer.W
    poses_mtx, focal = _current_cameras(trainer)
    render_chunk_vis = make_vis_chunk_renderer(
        trainer.static_cfg, trainer.dynamic_cfg, args.ray_type, trainer.n_samples,
        trainer.static_cfg.step_size(np.asarray(scene.scene_bbox)), H, W,
    )

    n_vis = min(args.N_vis if args.N_vis > 0 else scene.n_frames, scene.n_frames)
    idxs = np.linspace(0, scene.n_frames - 1, n_vis).astype(int)
    ts = np.linspace(-1, 1, scene.n_frames) if scene.n_frames > 1 else np.zeros(1)
    params = {"static": trainer.params["static"], "dynamic": trainer.params["dynamic"]}
    T = scene.n_frames

    frames = []
    for i in idxs:
        pose_f = poses_mtx[min(i + 1, T - 1)]
        pose_b = poses_mtx[max(i - 1, 0)]
        frames.append(
            render_image_vis(
                render_chunk_vis, params, trainer.aabb, poses_mtx[i], pose_f, pose_b,
                focal, float(ts[i]), H, W, args.ray_type,
            )
        )

    def grid(key):
        return np.stack([f[key] for f in frames])

    def images(tag, arr):
        writer.add_images(f"test/{tag}", arr, global_step=it, dataformats="NHWC")

    images("rgb_maps", np.clip(grid("rgb"), 0, 1))
    images("rgb_maps_s", np.clip(grid("rgb_s"), 0, 1))
    images("rgb_maps_d", np.clip(grid("rgb_d"), 0, 1))
    images("blending_maps", np.repeat(np.clip(grid("blending"), 0, 1)[..., None], 3, -1))

    # depth families share one global min/max (reference: renderer.py:617-640)
    depth_fams = {k: grid(k) for k in ("depth", "depth_s", "depth_d")}
    all_depth = np.stack(list(depth_fams.values()))
    minmax = (float(all_depth.min()), float(all_depth.max()))
    for tag, fam in zip(("depth_map", "depth_map_s", "depth_map_d"), depth_fams.values()):
        images(tag, np.stack([visualize_depth_numpy(d, minmax)[0] / 255.0 for d in fam]))

    # induced flows (reference: renderer.py:585-611)
    for tag in ("induced_flow_f", "induced_flow_b", "induced_flow_s_f", "induced_flow_s_b"):
        images(tag, np.stack([flow_to_image(f[tag]) / 255.0 for f in frames]))

    # weighted scene-flow displacement, normalized (reference: renderer.py:612-615)
    deltas = grid("delta_xyz_sum")
    delta_imgs = [(d / max(np.abs(d).max(), 1e-12) + 1.0) / 2.0 for d in deltas]
    images("delta_xyz_tb", np.stack(delta_imgs))

    # GT families (reference: train.py:2540-2580 + renderer.py:641-643)
    if scene.rgbs_stack is not None:
        images("gt_maps", scene.rgbs_stack[idxs])
    if scene.flows_f is not None and scene.flows_b is not None:
        gt_flows_f = scene.flows_f.reshape(T, H, W, 2)
        gt_flows_b = scene.flows_b.reshape(T, H, W, 2)
        images("gt_flow_f", np.stack([flow_to_image(f) / 255.0 for f in gt_flows_f[idxs]]))
        images("gt_flow_b", np.stack([flow_to_image(f) / 255.0 for f in gt_flows_b[idxs]]))
    else:
        print("[vis] scene has no GT flows; skipping gt_flow_f/gt_flow_b")
    if scene.fg_masks is not None:
        gt_masks = scene.fg_masks.reshape(T, H, W)[idxs]
        images("gt_blending_maps", np.repeat(gt_masks[..., None], 3, -1))
    else:
        print("[vis] scene has no GT masks; skipping gt_blending_maps")
    if scene.disps is not None:
        disps = scene.disps.reshape(T, H, W)[idxs]
        images("monodepth_tb", np.stack([visualize_depth_numpy(d)[0] / 255.0 for d in disps]))
    else:
        print("[vis] scene has no monodepth; skipping monodepth_tb")


def _pose_diagnostics(trainer, scene, writer, it):
    """Procrustes-aligned camera errors against GT poses (reference:
    train.py:2365-2415), and the camera wireframe figure when matplotlib is
    installed."""
    from .core.se3 import evaluate_camera_alignment, prealign_cameras

    with torch.no_grad():
        poses_now = pose_to_mtx(trainer.params["pose"].detach().cpu())
        gt = torch.from_numpy(np.asarray(scene.poses, np.float32))
        aligned, _ = prealign_cameras(poses_now, gt)
        R_err, t_err = evaluate_camera_alignment(aligned, gt)
    writer.add_scalar("train/pose_R_error_deg", float(R_err.mean()) * 180 / np.pi, it)
    writer.add_scalar("train/pose_t_error", float(t_err.mean()), it)
    try:
        from .utils.camera_vis import camera_pose_figure

        img = camera_pose_figure(aligned.numpy(), np.asarray(scene.poses))
        writer.add_images("camera_poses", img[None] / 255.0, global_step=it, dataformats="NHWC")
    except ImportError:
        pass  # matplotlib optional; all other vis paths stay hard-failing


def reconstruction(args, device="cuda"):
    """Load, train, checkpoint, evaluate (reference: train.py:824-2658).
    Returns {loader_s, train_s, save_s, ckpt, ckpt_bytes, psnrs, frame_s,
    eval_s, losses, compaction}: `losses` the total loss at each progress
    line, `compaction` the step's bucket sizes at the end {k, flat, mask}."""
    t0 = time.perf_counter()
    scene = load_scene(args)
    report = {"loader_s": time.perf_counter() - t0}
    logfolder = f"{args.basedir}/{args.expname}"
    os.makedirs(logfolder, exist_ok=True)
    writer = _tb_writer(args.tblogdir or logfolder, args.no_tensorboard)

    trainer = Trainer(args, scene, device=device)
    print(f"grid {trainer.static_cfg.grid_size}, nSamples {trainer.n_samples}, "
          f"rays {scene.n_rays}, device {trainer.device}")

    t0 = time.time()
    window, losses = [], []
    start = trainer.iteration
    update_alpha_iters = set(args.update_AlphaMask_list)
    for it in range(start, args.n_iters):
        metrics = trainer.run_step()
        # occupancy-mask refresh (the reference parses update_AlphaMask_list
        # but never reads it, opt.py:211; here it builds the mask of the
        # evaluation's early-out and, with --compact_train, of the step)
        if (it + 1) in update_alpha_iters:
            trainer.update_alpha_mask()
        # metrics are read back from the device only here (train.py:210-215)
        if (it + 1) % args.progress_refresh_rate == 0:
            host = {k: float(v) for k, v in metrics.items()}
            window.append(host["psnr"])
            losses.append(host["total_loss"])
            dt = time.time() - t0
            rays_s = args.batch_size * (it + 1 - start) / dt
            print(
                f"iter {it+1:06d} loss {host['total_loss']:.4f} "
                f"psnr {np.mean(window[-10:]):.2f} rays/s {rays_s:,.0f}"
            )
            for k, v in host.items():
                writer.add_scalar(f"train/{k}", v, it)
            if args.with_GT_poses and args.optimize_poses and scene.poses is not None:
                _pose_diagnostics(trainer, scene, writer, it)
        if (it + 1) % 10000 == 0:
            _save_ckpts(trainer, logfolder, args.expname)

        # train-time TB visualization (reference: train.py:2428-2580).
        # Failures propagate: a broken vis path must fail the run, not warn.
        if args.N_vis != 0 and (it + 1) % args.vis_train_every == 0:
            _tb_vis_images(trainer, scene, args, writer, it)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    report["train_s"] = time.time() - t0
    report["losses"] = losses
    report["compaction"] = {"k": trainer.compact_k, "flat": trainer.compact_flat,
                            "mask": trainer.alpha_mask is not None}

    report["save_s"], report["ckpt_bytes"] = _save_ckpts(trainer, logfolder, args.expname)
    report["ckpt"] = f"{logfolder}/{args.expname}.npz"

    # final evaluation (train.py:2623-2641), with the trainer's mask if it
    # built one
    poses_mtx, focal = _current_cameras(trainer)
    render_chunk = make_chunk_renderer(
        trainer.static_cfg, trainer.dynamic_cfg, args.ray_type, trainer.n_samples,
        trainer.static_cfg.step_size(np.asarray(scene.scene_bbox)),
        alpha_mask=trainer.alpha_mask, compact=bool(args.compact_eval),
    )
    frame_s = []
    t0 = time.perf_counter()
    PSNRs, near_fars, _ = evaluate(
        render_chunk, trainer.params, trainer.aabb, poses_mtx, focal, scene,
        args.ray_type, save_path=f"{logfolder}/imgs_test_all", n_vis=-1,
        compute_extra_metrics=True, frame_seconds=frame_s,
    )
    report.update(psnrs=PSNRs, frame_s=frame_s, eval_s=time.perf_counter() - t0)
    if PSNRs:
        print(f"======> {args.expname} train all psnr: {np.mean(PSNRs)} <========")
    export_poses_bounds(
        os.path.join(args.datadir, "poses_bounds_RoDynRF.npy")
        if os.path.isdir(args.datadir)
        else f"{logfolder}/poses_bounds_RoDynRF.npy",
        poses_mtx, focal, trainer.H, trainer.W, args.downsample_train, near_fars,
    )
    writer.close()
    return report


def _cfg_from_kwargs(kw) -> FieldConfig:
    return FieldConfig(
        grid_size=tuple(int(g) for g in kw["gridSize"]),
        t_size=int(kw["tSize"]),
        density_n_comp=tuple(kw["density_n_comp"]),
        app_n_comp=tuple(kw["appearance_n_comp"]),
        app_dim=int(kw["app_dim"]),
        shading_mode=kw["shadingMode"],
        density_shift=float(kw["density_shift"]),
        alpha_mask_thres=float(kw["alphaMask_thres"]),
        distance_scale=float(kw["distance_scale"]),
        ray_march_weight_thres=float(kw["rayMarch_weight_thres"]),
        fea2dense_act=kw["fea2denseAct"],
        near_far=tuple(float(x) for x in kw["near_far"]),
        step_ratio=float(kw["step_ratio"]),
        pos_pe=int(kw["pos_pe"]),
        view_pe=int(kw["view_pe"]),
        fea_pe=int(kw["fea_pe"]),
        featureC=int(kw["featureC"]),
    )


def _load_reference_th_pair(ckpt_path):
    """A reference-format checkpoint pair ({exp}.th + {exp}_static.th) ->
    (params, static_cfg, dynamic_cfg, aabb, poses_mtx, focal, alpha_mask)
    (the reference render path, train.py:435-449). The optimized
    poses/focal travel inside the kwargs of both files
    (tensorBase.py:460-463)."""
    dyn_params, dyn_meta = import_th(ckpt_path)
    stat_params, stat_meta = import_th(ckpt_path.replace(".th", "_static.th"))
    kw = dyn_meta["kwargs"]
    aabb = np.asarray(kw["aabb"], np.float32)
    poses_mtx = np.asarray(kw["se3_poses"], np.float32)
    focal = float(np.asarray(kw["focal_ratio_refine"]))
    params = {"static": stat_params, "dynamic": dyn_params}
    return (params, _cfg_from_kwargs(stat_meta["kwargs"]), _cfg_from_kwargs(kw), aabb,
            poses_mtx, focal, dyn_meta.get("alpha_mask"))


def render_test(args, logfolder, device="cuda"):
    """Render from a checkpoint (reference: train.py:420-530): the test
    views with --render_test 1, the five path families with --render_path
    1. `--ckpt` may name a native .npz or a reference .th pair; the
    checkpoint's occupancy mask, or the one --alpha_mask names, masks the
    render (--compact_eval 1: the compact renderer). Returns {load_s,
    psnrs, frame_s, eval_s, flat_log}: flat_log the compact renderer's (N,
    occupied, R·S) per chunk."""
    dev = check_device(device)
    scene = load_scene(args)
    ckpt_path = args.ckpt or f"{logfolder}/{args.expname}.npz"
    t0 = time.perf_counter()
    if ckpt_path.endswith(".th"):
        (params, static_cfg, dynamic_cfg, aabb, poses_mtx, focal,
         alpha_mask) = _load_reference_th_pair(ckpt_path)
    else:
        params, static_cfg, dynamic_cfg, aabb, extra, alpha_mask = load_checkpoint(
            ckpt_path, return_alpha=True)
        with torch.no_grad():
            poses_mtx = pose_to_mtx(torch.from_numpy(np.asarray(params["pose"]))).numpy()
        focal = extra.get("focal")
    params = params_from_numpy({"static": params["static"], "dynamic": params["dynamic"]}, dev)
    step_size = static_cfg.step_size(aabb)
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=dev)
    if args.alpha_mask:
        alpha_mask = load_alpha_npz(args.alpha_mask)
    report = {"load_s": time.perf_counter() - t0}
    n_samples = min(args.nSamples, cal_n_samples(static_cfg.grid_size, args.step_ratio))
    render_chunk = make_chunk_renderer(
        static_cfg, dynamic_cfg, args.ray_type, n_samples, step_size,
        alpha_mask=alpha_mask, compact=bool(args.compact_eval))
    report["flat_log"] = render_chunk.flat_log

    near_fars = None
    if args.render_test or args.render_train:
        os.makedirs(f"{logfolder}/imgs_test_all", exist_ok=True)
        frame_s = []
        t0 = time.perf_counter()
        PSNRs, near_fars, _ = evaluate(
            render_chunk, params, aabb, poses_mtx, focal, scene, args.ray_type,
            save_path=f"{logfolder}/imgs_test_all", n_vis=-1,
            compute_extra_metrics=True, frame_seconds=frame_s,
        )
        report.update(psnrs=PSNRs, frame_s=frame_s, eval_s=time.perf_counter() - t0)
        if PSNRs:
            print(f"test psnr: {np.mean(PSNRs):.3f}")

    if args.render_path:
        # pick center-most pose (train.py:499-507)
        centers = poses_mtx[:, :, 3]
        mean_c = centers.mean(0)
        idx_center = int(np.argmin(np.sum((centers - mean_c) ** 2, -1)))
        if near_fars is None:
            _, near_fars, _ = evaluate(
                render_chunk, params, aabb, poses_mtx, focal, scene, args.ray_type,
                save_path=None, n_vis=-1,
            )
        # scene scale from rendered near bound (train.py:509)
        sc = float(near_fars[idx_center][0]) * 0.75
        paths = generate_path(poses_mtx[idx_center], focal, sc, scene.n_frames)
        for name, (poses_p, focals_p) in paths.items():
            change_time = "change" if name in ("fix_view", "change_view_time") else 0.0
            evaluation_path(
                render_chunk, params, aabb, poses_p, focals_p, scene, args.ray_type,
                f"{logfolder}/{name}", change_time=change_time,
            )
    return report


def main(argv=None, device="cuda"):
    """Parse `argv` (a list of arguments; None reads sys.argv) and dispatch
    as train.py does: --export_mesh 1 writes `<ckpt stem>.ply` from --ckpt;
    --render_only with --render_test or --render_path renders a checkpoint;
    anything else, unless a mesh was exported, trains. Returns the
    dispatched functions' report (the export's under "mesh")."""
    args = config_parser(argv)
    np.random.seed(args.seed)
    print(args)
    check_device(device)
    report = {}
    if args.export_mesh:
        if not args.ckpt:
            raise ValueError("--export_mesh 1 exports the checkpoint that --ckpt names")
        report["mesh"] = export_mesh_from_ckpt(
            args.ckpt, args.ckpt.rsplit(".", 1)[0] + ".ply", device=device)
    if args.render_only and (args.render_test or args.render_path):
        report.update(render_test(args, os.path.join(args.basedir, args.expname), device))
    elif not args.export_mesh:
        report = reconstruction(args, device)
    return report
