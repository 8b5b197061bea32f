#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rodynrf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):
  1. the card: name and power limit from nvidia-smi, torch's device name;
  2. build every CUDA kernel of the train step from csrc/ (one nvcc per
     source, started together), with the build time;
  3. hold each kernel to its plain PyTorch version on the card, at the
     shapes the train step gives it, on inputs made from the step's own
     sample points: kernel, plain and library-call times beside the
     memory-bandwidth bound;
  4. the main path: `Trainer.run_step` of the Nvidia recipe
     (configs/Nvidia_no_poses.txt, f32, strided tables) at the 300³ grid
     (331×368×220, 270 samples per ray, batch 1024) on a synthetic 12-frame
     270×480 scene with random weights from the seed: 2 warm + 5 timed steps,
     every loss finite, and the kernel launch counter equal to launches per
     step × steps;
     then one more step under torch.profiler (device-busy share, top kernels);
  5. a small-input reference: the TINY step on the card against the same
     step on the CPU (the plain versions the CPU tests hold to the JAX
     package), losses at 1e-4;
  6. one JSON line of kernels, the nvidia-smi line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

CONFIG = [
    "--config", str(Path(__file__).resolve().parent / "configs" / "Nvidia_no_poses.txt"),
    "--dataset_name", "synthetic",
    "--bf16", "0", "--vm_layout", "strided", "--N_voxel_init", "27000000",
]
SCENE = dict(T=12, H=270, W=480)
WARM_STEPS, TIMED_STEPS = 2, 5
KERNEL_RTOL = 1e-4  # of max|plain|: f32 sums of ≤ a few hundred terms, another order


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def coalesce_bound_ms(M: int, R: int, C: int):
    """Least time for the table gradient: each input read once (rows int32,
    w4 [M,4] f32, ct [M,C] f32), the output [R,4C] f32 written once, over
    the memory rate; 4·M·C FMAs over the f32 rate. Returns (ms, bound_by)."""
    bytes_moved = 4 * M + 16 * M + 4 * M * C + 16 * R * C
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = 2 * 4 * M * C / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def coalesce_cases(tr, gen):
    """(name, rows, w4, ct, R) at every table-gradient shape of the train
    step (static and dynamic field, orientations 0-2): rows/weights from the first batch's sample points (static: pass
    E's samples; dynamic: their warped positions), ct drawn from `gen`."""
    from rodynrf_tpu_torch.core.se3 import pose_to_mtx
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.fields import static as stat
    from rodynrf_tpu_torch.ops.fused_vm import plane_rows_weights
    from rodynrf_tpu_torch.render.sampling import sample_xyz
    from rodynrf_tpu_torch.train.schedule import PermutationSampler
    from rodynrf_tpu_torch.train.step import _rays_from_idx, focal_from_fov

    S = tr.step_fn.S
    p = tr.params
    ids = PermutationSampler(tr.scene.n_rays, tr.args.batch_size, tr.args.seed).nextids()
    ray_idx = torch.as_tensor(ids).to(tr.device)
    with torch.no_grad():
        focal = focal_from_fov(p["fov"][0, 0], S.H, S.W)
        rays, _, _, _ = _rays_from_idx(ray_idx, pose_to_mtx(p["pose"]), focal, S)
        xyz, _, _ = sample_xyz(rays, S.n_samples, S.ray_type, S.static_cfg.near_far,
                               tr.aabb, S.step_size, None, det_jitter=True)
        flat = xyz.reshape(-1, 3)
        t_flat = tr.data["ts"][ray_idx][:, None].expand(xyz.shape[:2]).reshape(-1)
        warped = dyn.normalize_coord(dyn.warp_coordinate(p["dynamic"], flat, t_flat, tr.aabb),
                                     tr.aabb)
        packs = {
            "static": (stat.pack_tables(p["static"], S.static_cfg),
                       dyn.normalize_coord(flat, tr.aabb)),
            "dynamic": (dyn.pack_tables(p["dynamic"], S.dynamic_cfg), warped),
        }
    cases = []
    for field, o in [(f, o) for f in ("static", "dynamic") for o in range(3)]:
        packed, pts = packs[field]
        idx, w = plane_rows_weights(packed, pts, o)
        rows, w4 = torch.cat(idx).contiguous(), torch.cat(w).contiguous()
        R, C = packed.tables[o].shape[0], packed.tables[o].shape[1] // 4
        ct = torch.randn((rows.shape[0], C), generator=gen, device=tr.device)
        cases.append((f"{field} o{o}", rows, w4, ct, R))
    return cases


def check_kernels(tr):
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad, coalesce_table_grad_plain

    gen = torch.Generator(device=tr.device).manual_seed(0)
    results = []
    for name, rows, w4, ct, R in coalesce_cases(tr, gen):
        M, C = ct.shape
        got = coalesce_table_grad(rows, w4, ct, R)
        want = coalesce_table_grad_plain(rows, w4, ct, R)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = KERNEL_RTOL * scale
        upd = (w4[:, :, None] * ct[:, None, :]).reshape(M, 4 * C)
        acc = torch.zeros((R, 4 * C), device=tr.device)
        case = dict(
            case=name, M=M, R=R, C=C, max_abs_err=err, tol=tol,
            ms=cuda_ms(lambda: coalesce_table_grad(rows, w4, ct, R)),
            plain_ms=cuda_ms(lambda: coalesce_table_grad_plain(rows, w4, ct, R)),
            # yardstick: index_add_ of the materialised [M, 4C] product
            library_ms=cuda_ms(lambda: acc.index_add_(0, rows, upd)),
        )
        case["bound_ms"], case["bound_by"] = coalesce_bound_ms(M, R, C)
        log(f"[kernel] coalesce_table_grad {name}: M={M} R={R} C={C} "
            f"max_abs_err={err:.3e} (tol {tol:.3e}, max|plain| {scale:.3e}) "
            f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
            f"index_add_ {case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"coalesce kernel disagrees with its plain version at {name}")
        results.append(case)
        del upd, acc
    return results


def launches_per_step(S) -> int:
    """Table-gradient launches in one step: one per orientation of every
    field evaluation that carries a gradient (one gather covers all strides).
    Sequential passes: static E (+ F, G, FF, BB with pose optimisation),
    dynamic A, B, C, D; A/B reuse E's static eval detached."""
    static_evals = 1 + (4 if S.optimize_poses else 0)
    return 3 * (static_evals + 4)


def profile_step(tr, top: int = 12):
    """One more train step under torch.profiler: device-busy share of the
    step's wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        tr.run_step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_launches = sum(e.count for e in kernels)
    log(f"[profile] one step: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_launches} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"[profile]   {dev_us(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_launches": n_launches}


def small_input_reference():
    """TINY step on the card vs on the CPU from the same weights. The first
    step's losses agree to 1e-4 (f32 sums in another order); the second's to
    1e-3, since Adam's scale-free update turns ulp-level gradient
    differences into lr-sized steps of the parameters between the two."""
    from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene
    from rodynrf_tpu_torch.train import Trainer, parse_cmd
    from rodynrf_tpu_torch.train.convert import params_to_numpy, params_from_numpy

    def make(device):
        args = parse_cmd(tiny_cmd("ndc", 1) + " --vm_layout strided")
        args.golden_det = 1
        return Trainer(args, tiny_scene("ndc"), device=device)

    cpu, gpu = make("cpu"), make("cuda")
    gpu.set_params(params_from_numpy(params_to_numpy(cpu.params), "cuda"))
    worst_by_step = []
    for step, limit in enumerate((1e-4, 1e-3)):
        mc = {k: float(v) for k, v in cpu.run_step().items()}
        mg = {k: float(v) for k, v in gpu.run_step().items()}
        worst = 0.0
        for k, v in mc.items():
            rel = abs(mg[k] - v) / max(abs(v), 1e-7)
            worst = max(worst, rel)
            if not rel <= limit:
                raise AssertionError(f"TINY step {step} {k}: card {mg[k]} vs CPU {v}")
        log(f"[reference] TINY step {step} on the card vs the CPU: {len(mc)} losses, "
            f"worst relative difference {worst:.2e} (limit {limit:g})")
        worst_by_step.append(worst)
    return worst_by_step


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import rodynrf_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from rodynrf_tpu_torch.data import make_synthetic_scene
    from rodynrf_tpu_torch.ops import cuda_build
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad
    from rodynrf_tpu_torch.train import Trainer, parse_cmd

    # 1. the card
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} x{count}")

    # 2. build
    t0 = time.time()
    reports = cuda_build.build(["coalesce"])
    log(f"[build] {time.time() - t0:.1f} s (compiled: {sorted(reports) or 'none, cached'})")
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + " | ".join(sorted(set(regs))))

    # the main path's trainer (the kernel checks draw their inputs from it)
    args = parse_cmd(" ".join(CONFIG))
    scene = make_synthetic_scene(**SCENE, ray_type=args.ray_type)
    t0 = time.time()
    tr = Trainer(args, scene)
    S = tr.step_fn.S
    log(f"[train] grid {S.static_cfg.grid_size}, {S.n_samples} samples/ray, batch "
        f"{args.batch_size}, {scene.n_frames} frames {scene.img_wh[0]}x{scene.img_wh[1]}, "
        f"set-up {time.time() - t0:.1f} s")
    if S.n_samples != 270 or tuple(S.static_cfg.grid_size) != (331, 368, 220):
        raise AssertionError("not the 300³ operating point")

    # 3. kernels against their plain versions
    cases = check_kernels(tr)
    evals = {"static": 1 + (4 if S.optimize_poses else 0), "dynamic": 4}
    per_step_ms = sum(c["ms"] * evals[c["case"].split()[0]] for c in cases)
    log(f"[kernel] coalesce_table_grad per train step (evals x shapes above): "
        f"{per_step_ms:.2f} ms")

    # 4. the main path
    per_step = launches_per_step(S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    coalesce_table_grad.launches = 0
    history = []
    for _ in range(WARM_STEPS):
        history.append(tr.run_step())
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(TIMED_STEPS):
        history.append(tr.run_step())
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / TIMED_STEPS
    launches = coalesce_table_grad.launches
    peak = torch.cuda.max_memory_allocated()
    n_steps = WARM_STEPS + TIMED_STEPS
    for i, m in enumerate(history):
        vals = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i}: non-finite {bad}")
        log(f"[train] step {i}: total_loss {vals['total_loss']:.6f} mse {vals['mse']:.6f} "
            f"psnr {vals['psnr']:.3f} ({len(vals)} finite metrics)")
    log(f"[train] {step_s * 1e3:.1f} ms/step, {args.batch_size / step_s:.1f} rays/s, "
        f"peak memory {peak / 2**30:.2f} GiB ({smi})")
    if launches != per_step * n_steps:
        raise AssertionError(f"coalesce launches {launches} != {per_step} x {n_steps} steps")
    log(f"[train] coalesce_table_grad launches: {launches} = {per_step}/step x {n_steps}")

    # where the step's device time goes (after the counts were read)
    prof = profile_step(tr)

    # 5. small-input reference
    tiny_worst = small_input_reference()

    # 6. report
    main_case = max(cases, key=lambda c: c["M"] * c["C"])
    kernels = [{
        "name": "coalesce_table_grad",
        "route": "cuda",
        "source": "rodynrf_tpu_torch/csrc/coalesce.cu",
        "replaces": "rodynrf_tpu/ops/coalesced.py:259",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "case": main_case["case"],
        "cases": cases,
    }]
    main_path = {
        "ms_per_step": step_s * 1e3, "rays_per_s": args.batch_size / step_s,
        "peak_gib": peak / 2**30, "steps": n_steps, "timed_steps": TIMED_STEPS,
        "coalesce_launches": launches, "coalesce_launches_per_step": per_step,
        "coalesce_ms_per_step": per_step_ms, **prof,
        # the profiled step's device time over the unprofiled steps' wall
        # time: the step's work is the same every step, so this estimates
        # the device's idle share without the profiler's own overhead
        "idle_share_est": 1.0 - prof["device_busy_ms"] / (step_s * 1e3),
        "tiny_worst_rel": tiny_worst, "card": smi,
    }
    log(json.dumps({"main_path": main_path}))
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.time() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
