"""Extended mixed-regime quality run of the port (counterpart of
scripts/quality_run.py).

Crosses every upsample stage on both ray types with pose and focal
optimisation on, for thousands of iterations, so the schedule interactions a
short run cannot see (focal activation at upsamp_list[3], the half-time
pose freeze, the per-stage optimizer resets) are exercised; ends in the
full evaluation of every frame and checks the eval PSNR against the JAX
script's floors.

    python -m rodynrf_tpu_torch.tools.quality_run [n_iters=3000] [--ray_type ndc|contract|both]
        [--seed S] [--out DIR]

Writes one JSON record per ray type into --out (default build/quality/),
`quality_<ray_type>_s<seed>.json`, with the JAX script's keys and the run's
seed, samples per ray, ms/step (median over 20-step windows, whole run and
per grid), peak memory, the iterations at which each schedule event fired,
the table-gradient kernels' launches over the run, the JAX package's result
beside it and the card's nvidia-smi line; the evaluation's images and the
final checkpoint go into `quality_<ray_type>_s<seed>/`. `main(argv,
device="cuda")` runs on the card and refuses without one unless the caller
passes device="cpu"; `run(...)` takes a smaller scene.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core.se3 import pose_to_mtx
from ..data import make_synthetic_scene
from ..device import check_device
from ..eval.evaluation import evaluate
from ..render.renderer import make_chunk_renderer
from ..train import Trainer, parse_cmd
from ..train.checkpoints import save_checkpoint

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "quality"
N_ITERS = 3000
SCENE = dict(T=8, H=96, W=128)
DEFAULT_SEED = 20211202  # the recipe's --seed default, as the JAX script runs
# the JAX script's floors (scripts/quality_run.py:34)
PSNR_FLOOR = {"ndc": 28.0, "contract": 24.0}
# the JAX package's results on a TPU v5e (git show 5bc8e06:QUALITY.md)
JAX_RESULT = {"ndc": {"eval_psnr": 36.98, "eval_ssim": 0.9602},
              "contract": {"eval_psnr": 28.89, "eval_ssim": 0.9354}}
CLOCK_WINDOW = 20  # steps per host-synchronised timing window


def upsamp_list(n_iters: int) -> list:
    """The JAX script's upsample iterations: 1/6, 1/3, 1/2 and 2/3 of the run."""
    return [n_iters // 6, n_iters // 3, n_iters // 2, 2 * n_iters // 3]


def recipe(ray_type: str, n_iters: int, T: int = SCENE["T"]) -> str:
    """The JAX script's command line (scripts/quality_run.py:45-58)."""
    up = upsamp_list(n_iters)
    return (
        f"--expname quality_{ray_type} --datadir none --dataset_name synthetic "
        f"--n_iters {n_iters} --batch_size 1024 --N_voxel_t {T} "
        f"--N_voxel_init {32**3} --N_voxel_final {128**3} "
        + " ".join(f"--upsamp_list {u}" for u in up)
        + f" --step_ratio 2.0 --ray_type {ray_type} "
        f"--model_name TensorVMSplit_TimeEmbedding --shadingMode MLP_Fea_late_view "
        f"--shadingModeStatic MLP_Fea "
        f"--n_lamb_sigma 16 --n_lamb_sigma 4 --n_lamb_sigma 4 "
        f"--n_lamb_sh 48 --n_lamb_sh 12 --n_lamb_sh 12 "
        f"--fea2denseAct relu --view_pe 0 --fea_pe 0 "
        f"--TV_weight_density 1.0 --TV_weight_app 1.0 --L1_weight_inital 8e-5 "
        f"--distortion_weight_static 0.01 --distortion_weight_dynamic 0.01 "
        f"--optimize_poses 1 --optimize_focal_length 1 --use_disp 1"
    )


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None
    without one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def kernel_launches() -> dict:
    """The two table-gradient kernels' launch counters."""
    from ..ops.coalesced import coalesce_table_grad
    from ..ops.segsum import segment_rows_sum_factored

    return {"coalesce_table_grad": coalesce_table_grad.launches,
            "segment_rows_sum_factored": segment_rows_sum_factored.launches}


def expected_events(args) -> dict:
    """The iterations whose end fires each schedule event under the
    trainer's schedule (train/schedule.py): every distinct upsample
    iteration; the focal optimizer's activation at the first upsample from
    upsamp_list[3] on; the pose freeze at the first iteration past
    n_iters // 2 that does not upsample (an upsample resets the pose lr)."""
    n = int(args.n_iters)
    ups = sorted({int(u) for u in args.upsamp_list if int(u) < n})
    focal = None
    if args.optimize_focal_length and args.lr_upsample_reset and len(args.upsamp_list) > 3:
        focal = next((u for u in ups if u >= args.upsamp_list[3]), None)
    freeze = None
    if args.optimize_poses:
        freeze = next((i for i in range(n // 2 + 1, n) if i not in ups), None)
    return {"upsample": ups, "focal_on": focal, "pose_freeze": freeze}


class Events:
    """The schedule events a trainer crosses, each by the iteration whose
    end fired it (observed, not computed: a grid growth empties one entry of
    the voxel plan; the focal and pose learning rates are read after the
    step). The pose freeze is the first zero pose lr past n_iters // 2:
    before it the lr may underflow to 0 by its decay (pose_gamma's span is
    1 when the last upsample lies past half the run, so it falls 300× a
    step), and an upsample sets it back."""

    def __init__(self, tr, seen=None):
        seen = seen or {}
        self.upsample = list(seen.get("upsample", []))
        self.focal_on = seen.get("focal_on")
        self.pose_freeze = seen.get("pose_freeze")
        self._left = len(tr.n_voxel_list)

    def after(self, tr, it: int) -> bool:
        """Record what iteration `it` fired; True if it upsampled."""
        crossed = len(tr.n_voxel_list) < self._left
        self._left = len(tr.n_voxel_list)
        if crossed:
            self.upsample.append(it)
        if self.focal_on is None and tr.schedule.lr_focal > 0.0:
            self.focal_on = it
        if (self.pose_freeze is None and tr.schedule.optimize_poses
                and it > tr.schedule.n_iters // 2 and tr.schedule.lr_pose == 0.0):
            self.pose_freeze = it
        return crossed

    def as_dict(self) -> dict:
        return {"upsample": self.upsample, "focal_on": self.focal_on,
                "pose_freeze": self.pose_freeze}


class StepClock:
    """ms/step over windows of CLOCK_WINDOW steps, each closed by a device
    synchronisation (the step makes none). A window that holds an upsample
    (its step ends with the grid growth and the step's rebuild) is kept out
    of the medians."""

    def __init__(self, device: torch.device, windows=None):
        self.device = device
        self.windows = list(windows or [])  # (grid "XxYxZ", ms/step, steps, crossing)
        self._n, self._cross, self._grid = 0, False, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0, self._n, self._cross = time.perf_counter(), 0, False

    def tick(self, grid, crossed: bool):
        if self._n == 0:
            self._grid = "x".join(str(int(g)) for g in grid)
        self._n += 1
        self._cross |= crossed
        if self._n == CLOCK_WINDOW or crossed:
            self.close()

    def close(self):
        if self._n:
            self._sync()
            ms = (time.perf_counter() - self._t0) * 1e3 / self._n
            self.windows.append((self._grid, ms, self._n, self._cross))
        self.start()

    def summary(self) -> dict:
        steady = [w for w in self.windows if not w[3]]
        by_grid = {}
        for g, ms, _, _ in steady:
            by_grid.setdefault(g, []).append(ms)
        return {"ms_per_step_median": float(np.median([w[1] for w in steady])) if steady
                else None,
                "ms_per_step_by_grid": {g: float(np.median(v)) for g, v in by_grid.items()},
                "ms_per_step_crossing": [w[1] for w in self.windows if w[3]],
                "clock_window_steps": CLOCK_WINDOW}


def cameras(tr, learned_focal: bool):
    """(poses [T, 3, 4] numpy, focal) of the trainer's cameras, computed on
    the CPU; the focal from the learned field of view, or the scene's."""
    with torch.no_grad():
        poses_mtx = pose_to_mtx(tr.params["pose"].detach().cpu()).numpy()
    if learned_focal:
        fov = float(tr.params["fov"].detach().cpu()[0, 0])
        return poses_mtx, float(max(tr.H, tr.W) / 2.0 / np.tan(fov))
    return poses_mtx, float(tr.focal_fixed)


def check_finite(metrics: dict, label: str) -> dict:
    """Host floats of a step's metrics; FloatingPointError if one is not
    finite."""
    host = {k: float(v) for k, v in metrics.items()}
    bad = sorted(k for k, v in host.items() if not math.isfinite(v))
    if bad:
        raise FloatingPointError(f"{label}: non-finite {bad}")
    return host


def peak_gib(device: torch.device):
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def mean_stats(save_path: Path):
    """[psnr, ssim, lpips_alex, lpips_vgg] of evaluate's mean.txt, NaN -> None."""
    stats = np.atleast_1d(np.loadtxt(save_path / "mean.txt"))
    return [float(s) if math.isfinite(float(s)) else None for s in stats]


def run(ray_type: str, n_iters: int = N_ITERS, scene=None, device="cuda",
        seed: int = DEFAULT_SEED, out=None, extra: str = "", log=print) -> dict:
    """Train the recipe (plus the flags in `extra`) on `scene` (default:
    the JAX script's 8×96×128 synthetic scene) for n_iters iterations,
    evaluate every frame, write the checkpoint and the JSON record; returns
    the record. The floor is recorded, not asserted (main asserts it)."""
    dev = check_device(device)
    if scene is None:
        scene = make_synthetic_scene(**SCENE, ray_type=ray_type)
    W, H = scene.img_wh
    args = parse_cmd(recipe(ray_type, n_iters, scene.n_frames) + (f" {extra}" if extra else ""))
    args.seed = int(seed)  # the trainer's generator and both ray samplers
    out_root = Path(out) if out is not None else DEFAULT_OUT
    run_dir = out_root / f"quality_{ray_type}_s{seed}"

    tr = Trainer(args, scene, device=dev)
    events, clock = Events(tr), StepClock(dev)
    launches0 = kernel_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    curve, first = [], None
    every = max(n_iters // 20, 1)
    t0 = time.time()
    clock.start()
    for it in range(n_iters):
        grid = tr.static_cfg.grid_size
        m = tr.run_step()
        clock.tick(grid, events.after(tr, it))
        if (it + 1) % every == 0:
            host = check_finite(m, f"{ray_type} iteration {it + 1}")
            curve.append((it + 1, round(host["psnr"], 2)))
            first = host["psnr"] if first is None else first
            log(f"[{ray_type}] iter {it + 1}/{n_iters} train psnr {host['psnr']:.2f}")
    clock.close()
    final = check_finite(m, f"{ray_type} last iteration")
    wall = time.time() - t0
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    peak = peak_gib(dev)

    poses_mtx, focal = cameras(tr, learned_focal=True)
    params = tr.full_params()
    render_chunk = make_chunk_renderer(
        tr.static_cfg, tr.dynamic_cfg, ray_type, tr.n_samples,
        tr.static_cfg.step_size(np.asarray(scene.scene_bbox)))
    save_path = run_dir / "imgs_test_all"
    t1 = time.time()
    psnrs, _, _ = evaluate(render_chunk, params, tr.aabb, poses_mtx, focal, scene, ray_type,
                           save_path=str(save_path), n_vis=-1, compute_extra_metrics=True)
    eval_s = time.time() - t1
    stats = mean_stats(save_path)
    ckpt = run_dir / "ckpt.npz"
    save_checkpoint(str(ckpt), params, tr.static_cfg, tr.dynamic_cfg, tr.aabb,
                    extra={"n_iters": n_iters, "run": f"quality_{ray_type}", "seed": int(seed),
                           "n_frames": scene.n_frames, "focal": focal,
                           "iteration": tr.iteration})

    eval_psnr = float(np.mean(psnrs))
    jax_ref = JAX_RESULT[ray_type]
    rec = {
        # the JAX script's keys (scripts/quality_run.py:89-98)
        "ray_type": ray_type,
        "n_iters": n_iters,
        "grid_final": list(tr.static_cfg.grid_size),
        "train_psnr_curve": curve,
        "eval_psnr_mean": round(eval_psnr, 2),
        "eval_ssim_mean": round(stats[1], 4) if len(stats) > 1 and stats[1] is not None
        else None,
        "wall_s": round(wall, 1),
        "floor": PSNR_FLOOR[ray_type],
        # the port's own
        "floor_met": eval_psnr >= PSNR_FLOOR[ray_type],
        "seed": int(seed),
        "scene": {"T": scene.n_frames, "H": H, "W": W},
        "n_samples": int(tr.n_samples),
        **clock.summary(),
        "peak_gib": peak,
        "events": events.as_dict(),
        "events_expected": expected_events(args),
        "launches": launches,
        "first_logged_train_psnr": first,
        "final_metrics": final,
        "eval_psnrs": [float(p) for p in psnrs],
        "eval_psnr": eval_psnr,
        "eval_s": eval_s,
        "focal": focal,
        "jax": {**jax_ref, "source": "the JAX package on a TPU v5e (git show "
                                     "5bc8e06:QUALITY.md)",
                "gap_db": eval_psnr - jax_ref["eval_psnr"]},
        "ckpt": str(ckpt),
        "ckpt_bytes": ckpt.stat().st_size,
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
        "torch": torch.__version__,
    }
    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / f"quality_{ray_type}_s{seed}.json", "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def main(argv=None, device="cuda") -> list:
    p = argparse.ArgumentParser(prog="python -m rodynrf_tpu_torch.tools.quality_run")
    p.add_argument("n_iters", nargs="?", type=int, default=N_ITERS)
    p.add_argument("--ray_type", choices=["ndc", "contract", "both"], default="both")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    a = p.parse_args(argv)
    check_device(device)
    types = ["ndc", "contract"] if a.ray_type == "both" else [a.ray_type]
    results = []
    for t in types:
        rec = run(t, a.n_iters, device=device, seed=a.seed, out=a.out)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    low = [f"{r['ray_type']} eval PSNR {r['eval_psnr_mean']} below floor {r['floor']}"
           for r in results if not r["floor_met"]]
    if low:
        raise AssertionError("; ".join(low))
    return results


if __name__ == "__main__":
    main()
