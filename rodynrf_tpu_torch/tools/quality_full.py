"""Quality at the production operating point (counterpart of
scripts/quality_full.py).

Convergence runs on a 480×270 synthetic dynamic scene (12 frames) with the
production flags (bf16 tables, grad-accum auto, auto layout, sequential
store), each ending in the full evaluation of every frame (PSNR/SSIM/LPIPS,
eval/evaluation.py) and rgb / depth / dynamicness strips:

  * "no_poses": configs/Nvidia_no_poses.txt's 16³ -> 640³ schedule over 7
    upsamples scaled to the budget, pose and focal optimisation on;
  * "gt_poses": configs/Nvidia.txt's 128³ -> 300³ with GT poses, TV on;
  * "gt_poses_compact": gt_poses with update_AlphaMask_list at 0.3 and 0.6
    of the budget and --compact_train 1; its final evaluation renders
    through the flat-compacted masked path.

    python -m rodynrf_tpu_torch.tools.quality_full [n_iters=10000] [which=both]
        [--out DIR] [--save_every N] [--stop_at N] [--resume] [--follow_up 1]

`which` is a run's name or "both" (no_poses, then gt_poses), as in the JAX
script. Everything goes under --out (default build/quality_full/): the
incremental `quality_full.json` (the curve after every point, the record
at the end), and per run `<name>/ckpt.npz` (the converged checkpoint; never
committed), `imgs_test_all*/` and the strips. `--save_every N` writes the
full training state (`Trainer.save_full`) to `<name>/full.npz` every N
iterations, `--stop_at N` writes it at iteration N and stops; `--resume`
continues from it, bit for bit the trajectory of an uninterrupted run
(tests/test_torch_quality.py), with the curve, events and clock readings
the JSON kept. `--follow_up 1` then exports the converged checkpoint's
mask (tools/export_alpha), its mesh (cli.main --export_mesh 1) and renders
it with that mask through the compact renderer beside the dense
evaluation. `main(argv, device="cuda")` runs on the card and refuses
without one unless the caller passes device="cpu".
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..core.se3 import pose_to_mtx
from ..data import make_synthetic_scene
from ..data.imageio import write_png
from ..device import check_device
from ..eval.evaluation import evaluate
from ..fields.alpha_mask import load_alpha_npz
from ..fields.config import cal_n_samples
from ..render.renderer import make_chunk_renderer, render_image
from ..train import Trainer, parse_cmd
from ..train.checkpoints import load_checkpoint, save_checkpoint
from ..train.convert import params_from_numpy
from . import export_alpha
from .quality_run import (REPO, Events, StepClock, card_line, cameras, check_finite,
                          expected_events, kernel_launches, mean_stats, peak_gib)

DEFAULT_OUT = REPO / "build" / "quality_full"
N_ITERS = 10000
T, H, W = 12, 270, 480

# the JAX script's runs, field for field (scripts/quality_full.py:48-94)
RUNS = {
    "no_poses": dict(
        n_voxel_init=4096,
        n_voxel_final=262144000,
        upsamp_frac=[0.15, 0.30, 0.45, 0.60, 0.70, 0.80, 0.90],
        optimize=1,
        tv_density=0.0,
        tv_app=0.0,
        dist_static=0.01,
        psnr_floor=26.0,
    ),
    "gt_poses": dict(
        n_voxel_init=2097156,
        n_voxel_final=27000000,
        upsamp_frac=[0.08, 0.12, 0.16, 0.22],
        optimize=0,
        tv_density=1.0,
        tv_app=1.0,
        dist_static=0.0,
        psnr_floor=28.0,
    ),
    "gt_poses_compact": dict(
        n_voxel_init=2097156,
        n_voxel_final=27000000,
        upsamp_frac=[0.08, 0.12, 0.16, 0.22],
        optimize=0,
        tv_density=1.0,
        tv_app=1.0,
        dist_static=0.0,
        psnr_floor=28.0,
        alpha_frac=[0.3, 0.6],
        compact_train=1,
    ),
}
# the JAX package's results on a TPU v5e (QUALITY.md; gt_poses_compact never
# finished there: scripts/quality_full.json holds only its curve)
JAX_RESULT = {"no_poses": {"eval_psnr": 35.67, "eval_ssim": 0.9657, "wall_s": 3652.8},
              "gt_poses": {"eval_psnr": 38.38, "eval_ssim": 0.9918, "wall_s": 3445.1},
              "gt_poses_compact": None}
JAX_SOURCE = "the JAX package on a TPU v5e (QUALITY.md, scripts/quality_full.json)"


def plan(name: str, n_iters: int):
    """(upsample iterations, alpha-mask iterations) of a run: its fractions
    of the budget, at least 1."""
    cfg = RUNS[name]
    return ([max(1, int(n_iters * f)) for f in cfg["upsamp_frac"]],
            [max(1, int(n_iters * f)) for f in cfg.get("alpha_frac", [])])


def recipe(name: str, n_iters: int, T: int = T) -> str:
    """The JAX script's command line (scripts/quality_full.py:126-143)."""
    cfg = RUNS[name]
    up, alpha_up = plan(name, n_iters)
    return (
        f"--expname q_{name} --datadir none --dataset_name synthetic "
        f"--n_iters {n_iters} --batch_size 1024 --N_voxel_t {T} "
        f"--N_voxel_init {cfg['n_voxel_init']} --N_voxel_final {cfg['n_voxel_final']} "
        + " ".join(f"--upsamp_list {u}" for u in up)
        + "".join(f" --update_AlphaMask_list {u}" for u in alpha_up)
        + f" --compact_train {cfg.get('compact_train', 0)}"
        + f" --step_ratio 2.0 --ray_type ndc "
        f"--model_name TensorVMSplit_TimeEmbedding --shadingMode MLP_Fea_late_view "
        f"--shadingModeStatic MLP_Fea "
        f"--n_lamb_sigma 16 --n_lamb_sigma 4 --n_lamb_sigma 4 "
        f"--n_lamb_sh 48 --n_lamb_sh 12 --n_lamb_sh 12 "
        f"--fea2denseAct relu --view_pe 0 --fea_pe 0 "
        f"--TV_weight_density {cfg['tv_density']} --TV_weight_app {cfg['tv_app']} "
        f"--distortion_weight_static {cfg['dist_static']} "
        f"--distortion_weight_dynamic 0.01 "
        f"--optimize_poses {cfg['optimize']} "
        f"--optimize_focal_length {cfg['optimize']} --use_disp 1 --bf16 1"
    )


def _strip(maps_list, key, path, norm=False):
    """A horizontal strip of per-frame maps as one PNG."""
    imgs = []
    for m in maps_list:
        a = m[key]
        if norm:
            a = (a - a.min()) / max(a.max() - a.min(), 1e-6)
        if a.ndim == 2:
            a = np.stack([a] * 3, -1)
        imgs.append((np.clip(a, 0, 1) * 255).astype(np.uint8))
    write_png(str(path), np.concatenate(imgs, axis=1))


def _finite_or_none(x):
    return round(float(x), 4) if x is not None and math.isfinite(x) else None


class Book:
    """The incremental quality_full.json: {run name: record}."""

    def __init__(self, out_root: Path):
        self.path = out_root / "quality_full.json"
        self.data = json.loads(self.path.read_text()) if self.path.exists() else {}

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.data, indent=1))


def run(name: str, n_iters: int = N_ITERS, scene=None, device="cuda", out=None,
        save_every: int = 0, stop_at=None, resume: bool = False, extra: str = "",
        log=print) -> dict:
    """Train run `name` (its recipe plus the flags in `extra`) on `scene`
    (default: the JAX script's 12×270×480 synthetic scene), fire its
    alpha-mask updates, evaluate and write the strips; returns the record
    (also in quality_full.json). With `stop_at` the run stops there after
    writing its full state and returns {"name", "stopped_at", ...};
    `resume` continues from that state."""
    dev = check_device(device)
    cfg = RUNS[name]
    if scene is None:
        scene = make_synthetic_scene(T=T, H=H, W=W)
    sW, sH = scene.img_wh
    args = parse_cmd(recipe(name, n_iters, scene.n_frames) + (f" {extra}" if extra else ""))
    out_root = Path(out) if out is not None else DEFAULT_OUT
    run_dir = out_root / name
    run_dir.mkdir(parents=True, exist_ok=True)
    book = Book(out_root)
    full_path = run_dir / "full.npz"
    prior = {}
    if resume:
        if not full_path.exists():
            raise FileNotFoundError(f"--resume: no full checkpoint at {full_path}")
        args.ckpt = str(full_path)
        prior = book.data.get(name, {}).get("progress", {})
    tr = Trainer(args, scene, device=dev)
    if resume and prior.get("iteration") != tr.iteration:
        raise ValueError(f"{book.path} records iteration {prior.get('iteration')} for {name}, "
                         f"the full checkpoint {tr.iteration}")

    events = Events(tr, prior.get("events"))
    clock = StepClock(dev, prior.get("windows"))
    curve = [tuple(p) for p in prior.get("psnr_curve", [])]
    masks = [tuple(p) for p in prior.get("alpha_masks", [])]
    launches_prior = prior.get("launches", {})
    resumed_at = list(prior.get("resumed_at", [])) + ([tr.iteration] if resume else [])
    launches0 = kernel_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    alpha_set = set(args.update_AlphaMask_list)
    every = max(n_iters // 40, 1)
    stop = n_iters if stop_at is None else min(int(stop_at), n_iters)

    def progress(wall):
        return {"iteration": tr.iteration, "psnr_curve": curve, "events": events.as_dict(),
                "windows": clock.windows, "alpha_masks": masks, "wall_s": wall,
                "resumed_at": resumed_at,
                "launches": {k: v - launches0[k] + launches_prior.get(k, 0)
                             for k, v in kernel_launches().items()}}

    def save_state(wall):
        tr.save_full(str(full_path))
        book.data.setdefault(name, {})["progress"] = {
            **progress(wall), "full_state_bytes": full_path.stat().st_size}
        book.save()

    t0 = time.time()
    clock.start()
    for it in range(tr.iteration, stop):
        grid = tr.static_cfg.grid_size
        m = tr.run_step()
        crossed = events.after(tr, it)
        if (it + 1) in alpha_set:  # mirrors the CLI loop's firing
            masks.append((it + 1, tr.update_alpha_mask()))
            crossed = True  # the mask build sits in this clock window
        clock.tick(grid, crossed)
        if (it + 1) % 100 == 0:  # the JAX script's 100-iteration fetch
            check_finite(m, f"{name} iteration {it + 1}")
        if (it + 1) % every == 0:
            p = check_finite(m, f"{name} iteration {it + 1}")["psnr"]
            curve.append((it + 1, round(p, 2)))
            log(f"[{name}] iter {it + 1}/{n_iters} grid "
                f"{'x'.join(map(str, tr.static_cfg.grid_size))} train psnr {p:.2f} "
                f"({time.time() - t0:.0f}s)")
            book.data.setdefault(name, {})["psnr_curve"] = curve
            book.save()
        if save_every and (it + 1) % save_every == 0 and it + 1 < stop:
            clock.close()
            save_state(prior.get("wall_s", 0.0) + time.time() - t0)
            clock.start()
    clock.close()
    wall = prior.get("wall_s", 0.0) + time.time() - t0
    if stop < n_iters:
        save_state(wall)
        log(f"[{name}] stopped at iteration {stop}; full state in {full_path}")
        return {"name": name, "stopped_at": stop, "full_state": str(full_path),
                **book.data[name]["progress"]}
    launches = progress(wall)["launches"]
    peak = peak_gib(dev)

    # the converged checkpoint (never committed)
    params = tr.full_params()
    poses_mtx, focal = cameras(tr, learned_focal=bool(cfg["optimize"]))
    ckpt = run_dir / "ckpt.npz"
    save_checkpoint(str(ckpt), params, tr.static_cfg, tr.dynamic_cfg, tr.aabb,
                    extra={"n_iters": n_iters, "run": name, "n_frames": scene.n_frames,
                           "focal": focal, "iteration": tr.iteration},
                    alpha_mask=tr.alpha_mask)

    # the evaluation: through the flat-compacted masked path when the run
    # built a mask
    render_chunk = make_chunk_renderer(
        tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples,
        tr.static_cfg.step_size(np.asarray(scene.scene_bbox)),
        alpha_mask=tr.alpha_mask, compact=tr.alpha_mask is not None)
    save_path = run_dir / "imgs_test_all"
    frame_s = []
    t1 = time.time()
    psnrs, _, _ = evaluate(render_chunk, params, tr.aabb, poses_mtx, focal, scene, "ndc",
                           save_path=str(save_path), n_vis=-1, compute_extra_metrics=True,
                           frame_seconds=frame_s)
    eval_s = time.time() - t1
    stats = mean_stats(save_path) + [None] * 4

    # rgb / depth / dynamicness strips over 6 evenly spaced frames
    ts_per_frame = np.linspace(-1.0, 1.0, scene.n_frames)
    frame_ids = np.linspace(0, scene.n_frames - 1, 6).astype(int)
    maps_list = [render_image(render_chunk, params, tr.aabb, poses_mtx[i], focal,
                              float(ts_per_frame[i]), sH, sW, "ndc") for i in frame_ids]
    _strip(maps_list, "rgb", run_dir / "strip_rgb.png")
    _strip(maps_list, "depth", run_dir / "strip_depth.png", norm=True)
    _strip(maps_list, "blending", run_dir / "strip_dynamicness.png")

    eval_psnr = float(np.mean(psnrs))
    jax_ref = JAX_RESULT[name]
    res = {
        # the JAX script's keys (scripts/quality_full.py:216-237)
        "n_iters": n_iters,
        "grid_final": list(tr.static_cfg.grid_size),
        "n_samples": int(tr.n_samples),
        "compact_k": int(tr.compact_k),
        "mask_occupancy": (round(float(tr.alpha_mask.alpha_volume.double().mean()), 4)
                           if tr.alpha_mask is not None else None),
        "grad_accum": int(tr._grad_accum()),
        "psnr_curve": curve,
        "eval_psnr": round(eval_psnr, 2),
        "eval_ssim": _finite_or_none(stats[1]),
        "eval_lpips_alex": _finite_or_none(stats[2]),
        "eval_lpips_vgg": _finite_or_none(stats[3]),
        "wall_s": round(wall, 1),
        "floor": cfg["psnr_floor"],
        # the port's own
        "floor_met": eval_psnr >= cfg["psnr_floor"],
        "eval_psnr_unrounded": eval_psnr,
        "eval_psnrs": [float(p) for p in psnrs],
        "eval_s": eval_s,
        "eval_ms_per_frame_median": float(np.median(frame_s)) * 1e3,
        "compact_flat": int(tr.compact_flat),
        "alpha_masks": masks,
        **clock.summary(),
        "peak_gib": peak,
        "events": events.as_dict(),
        "events_expected": expected_events(args),
        "launches": launches,
        "resumed_at": resumed_at,
        "jax": None if jax_ref is None else {
            **jax_ref, "source": JAX_SOURCE, "gap_db": eval_psnr - jax_ref["eval_psnr"]},
        "ckpt": str(ckpt),
        "ckpt_bytes": ckpt.stat().st_size,
        "focal": focal,
        "scene": {"T": scene.n_frames, "H": sH, "W": sW},
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
        "torch": torch.__version__,
    }
    book.data[name] = res
    book.save()
    log(f"[{name}] {json.dumps(res)[:300]}")
    return res


def follow_up(rec: dict, name: str, scene=None, device="cuda", out=None) -> dict:
    """On the run's converged checkpoint: the exported mask
    (tools/export_alpha at its defaults), the mesh (`cli.main
    --export_mesh 1`), and every frame rendered with that mask through the
    compact renderer (what `--render_only 1 --alpha_mask <npz>
    --compact_eval 1` renders) beside the run's dense evaluation of the same
    parameters. Stored under the record's "follow_up"."""
    from ..cli import main as cli_main

    dev = check_device(device)
    if scene is None:
        scene = make_synthetic_scene(T=T, H=H, W=W)
    out_root = Path(out) if out is not None else DEFAULT_OUT
    run_dir = out_root / name
    ckpt = rec["ckpt"]
    t0 = time.time()
    mask = export_alpha.export(ckpt, str(run_dir / "alpha_mask.npz"), device=dev)
    mask["s"] = time.time() - t0
    t0 = time.time()
    mesh = cli_main(["--export_mesh", "1", "--ckpt", ckpt], device=str(dev))["mesh"]
    mesh["s"] = time.time() - t0

    params, static_cfg, dynamic_cfg, aabb, extra = load_checkpoint(ckpt)
    args = parse_cmd(recipe(name, rec["n_iters"], scene.n_frames))
    n_samples = min(args.nSamples, cal_n_samples(static_cfg.grid_size, args.step_ratio))
    fields = params_from_numpy({"static": params["static"], "dynamic": params["dynamic"]}, dev)
    with torch.no_grad():
        poses_mtx = pose_to_mtx(torch.from_numpy(np.asarray(params["pose"]))).numpy()
    render_chunk = make_chunk_renderer(
        static_cfg, dynamic_cfg, "ndc", n_samples, static_cfg.step_size(aabb),
        alpha_mask=load_alpha_npz(mask["out"]), compact=True)
    frame_s = []
    t0 = time.time()
    psnrs, _, _ = evaluate(render_chunk, fields, torch.as_tensor(aabb, device=dev), poses_mtx,
                           extra["focal"], scene, "ndc", save_path=str(run_dir / "imgs_masked"),
                           n_vis=-1, frame_seconds=frame_s)
    masked = {"eval_psnr": float(np.mean(psnrs)), "eval_psnrs": [float(p) for p in psnrs],
              "dense_eval_psnr": rec["eval_psnr_unrounded"],
              "gap_to_dense_db": float(np.mean(psnrs)) - rec["eval_psnr_unrounded"],
              "ms_per_frame_median": float(np.median(frame_s)) * 1e3,
              "dense_ms_per_frame_median": rec["eval_ms_per_frame_median"],
              "flat_log_chunks": len(render_chunk.flat_log), "s": time.time() - t0}
    res = {"alpha_mask": mask, "mesh": mesh, "masked_eval": masked}
    book = Book(out_root)
    book.data.setdefault(name, {})["follow_up"] = res
    book.save()
    return res


def main(argv=None, device="cuda") -> dict:
    p = argparse.ArgumentParser(prog="python -m rodynrf_tpu_torch.tools.quality_full")
    p.add_argument("n_iters", nargs="?", type=int, default=N_ITERS)
    p.add_argument("which", nargs="?", default="both", choices=["both", *RUNS])
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--save_every", type=int, default=0,
                   help="write the full training state every N iterations (0: never)")
    p.add_argument("--stop_at", type=int, default=None,
                   help="write the full training state at iteration N and stop")
    p.add_argument("--resume", action="store_true",
                   help="continue from the run's full training state")
    p.add_argument("--follow_up", type=int, default=0,
                   help="1: export the mask and the mesh of the converged checkpoint and "
                        "render it with the mask")
    a = p.parse_args(argv)
    check_device(device)
    names = ["no_poses", "gt_poses"] if a.which == "both" else [a.which]
    results = {}
    for name in names:
        rec = run(name, a.n_iters, device=device, out=a.out, save_every=a.save_every,
                  stop_at=a.stop_at, resume=a.resume)
        if "stopped_at" not in rec and a.follow_up:
            rec["follow_up"] = follow_up(rec, name, device=device, out=a.out)
            print(json.dumps({"follow_up": {name: rec["follow_up"]}}), flush=True)
        print(json.dumps({"quality_full": {name: rec}}), flush=True)
        results[name] = rec
    low = [f"{n} eval PSNR {r['eval_psnr']} below floor {r['floor']}"
           for n, r in results.items() if "stopped_at" not in r and not r["floor_met"]]
    if low:
        raise AssertionError("; ".join(low))
    return results


if __name__ == "__main__":
    main()
