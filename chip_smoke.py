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
     sample points: the coalesce kernel at the six strided table-gradient
     shapes of the f32 path, the segment-sum kernel at the three merged
     shapes of the default path; kernel, plain and library-call times beside
     the memory-bandwidth bound;
  4. the f32 strided path: `Trainer.run_step` of the Nvidia recipe
     (configs/Nvidia_no_poses.txt with --bf16 0 --vm_layout strided) at the
     300³ grid (331×368×220, 270 samples per ray, batch 1024) on a synthetic
     12-frame 270×480 scene with random weights from the seed: 2 warm + 5
     timed steps, every loss finite, kernel launches equal to launches per
     step × steps; one more step under torch.profiler;
  4b. the default path: the same recipe with its defaults --bf16 1
     --vm_layout auto, which put the dynamic field on the merged layout
     (segment-sum kernel) and the static field on the strided one (coalesce
     kernel): the same steps, counts and profile;
  4c. one full-width upsample on the default path's trainer: the step at
     upsamp_list[0], whose end grows the grid and re-chooses the layouts,
     then 2 more steps with launch counts that match the chosen layouts;
  5. a small-input reference: the TINY step on the card against the same
     step on the CPU (the plain versions the CPU tests hold to the JAX
     package): f32 strided, bf16 auto, and bf16 across the TINY upsample;
  6. a `main_path` JSON line per path, one JSON line of kernels, the
     nvidia-smi line, and the result line.

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

RECIPE = [
    "--config", str(Path(__file__).resolve().parent / "configs" / "Nvidia_no_poses.txt"),
    "--dataset_name", "synthetic", "--N_voxel_init", "27000000",
]
CONFIG_F32 = RECIPE + ["--bf16", "0", "--vm_layout", "strided"]
CONFIG_DEFAULT = RECIPE  # --bf16 1 --vm_layout auto: the recipe's defaults
SCENE = dict(T=12, H=270, W=480)
WARM_STEPS, TIMED_STEPS = 2, 5
KERNEL_RTOL = 1e-4  # of max|plain|: f32 sums of ≤ a few hundred terms, another order
KERNELS = ("coalesce", "segsum")


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


def segsum_bound_ms(M: int, R: int, C: int, elem_bytes: int):
    """Least time for the segment sum: idx and perm (int32) and upd read
    once, the output [R, C] f32 written once, over the memory rate; M·C
    adds over the f32 rate. Returns (ms, bound_by)."""
    bytes_moved = 8 * M + elem_bytes * M * C + 4 * R * C
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = M * C / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sample_points(tr):
    """The first batch's sample points (pass E's, jitter-free) normalised
    for the static field, and their warped positions for the dynamic one."""
    from rodynrf_tpu_torch.core.se3 import pose_to_mtx
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.render.sampling import sample_xyz
    from rodynrf_tpu_torch.train.schedule import PermutationSampler
    from rodynrf_tpu_torch.train.step import _rays_from_idx, focal_from_fov

    S, p = tr.step_fn.S, tr.params
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
    return dyn.normalize_coord(flat, tr.aabb), warped


def coalesce_cases(tr, gen):
    """(name, rows, w4, ct, R) at every strided table-gradient shape of the
    trainer's step (static and dynamic field, orientations 0-2), rows and
    weights from the first batch's sample points, ct drawn from `gen`."""
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.fields import static as stat
    from rodynrf_tpu_torch.ops.fused_vm import plane_rows_weights

    S, p = tr.step_fn.S, tr.params
    pts_static, warped = sample_points(tr)
    with torch.no_grad():
        packs = {
            "static": (stat.pack_tables(p["static"], S.static_cfg), pts_static),
            "dynamic": (dyn.pack_tables(p["dynamic"], S.dynamic_cfg), warped),
        }
    cases = []
    for field, o in [(f, o) for f in ("static", "dynamic") for o in range(3)]:
        packed, pts = packs[field]
        assert packed.meta["layout"] == "strided"
        idx, w = plane_rows_weights(packed, pts, o)
        rows, w4 = torch.cat(idx).contiguous(), torch.cat(w).contiguous()
        R, C = packed.tables[o].shape[0], packed.tables[o].shape[1] // 4
        ct = torch.randn((rows.shape[0], C), generator=gen, device=tr.device)
        cases.append((f"{field} o{o}", rows, w4, ct, R))
    return cases


def segsum_cases(tr, gen):
    """(name, rows, u, R) at the three merged table-gradient shapes of the
    default path's dynamic field: rows from the merged row map at the warped
    sample points, u = w · ct with the step's corner weights w and a seeded
    ct, rounded to the table dtype (bf16) as merged_sample's backward does."""
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.ops.fused_vm import merged_rows_weights

    S = tr.step_fn.S
    _, warped = sample_points(tr)
    with torch.no_grad():
        packed = dyn.pack_tables(tr.params["dynamic"], S.dynamic_cfg)
    assert packed.meta["layout"] == "merged"
    cases = []
    for o in range(3):
        table = packed.tables[o]
        rows, w = merged_rows_weights(packed, warped, o)
        M, nS = w.shape[0], w.shape[1]
        C = table.shape[1] // (nS * 4)
        ct = torch.randn((M, nS, C), generator=gen, device=tr.device)
        u = (w[:, :, :, None] * ct[:, :, None, :]).to(table.dtype).reshape(M, nS * 4 * C)
        cases.append((f"dynamic merged o{o}", rows.contiguous(), u, table.shape[0]))
        del ct
    return cases


def _report(kind, name, case, scale):
    log(f"[kernel] {kind} {name}: M={case['M']} R={case['R']} C={case['C']} "
        f"max_abs_err={case['max_abs_err']:.3e} (tol {case['tol']:.3e}, max|plain| {scale:.3e}) "
        f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
        f"library {case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms")
    if not case["max_abs_err"] <= case["tol"]:
        raise AssertionError(f"{kind} kernel disagrees with its plain version at {name}")


def check_coalesce(tr):
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad, coalesce_table_grad_plain

    gen = torch.Generator(device=tr.device).manual_seed(0)
    results = []
    for name, rows, w4, ct, R in coalesce_cases(tr, gen):
        M, C = ct.shape
        got = coalesce_table_grad(rows, w4, ct, R)
        want = coalesce_table_grad_plain(rows, w4, ct, R)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        upd = (w4[:, :, None] * ct[:, None, :]).reshape(M, 4 * C)
        acc = torch.zeros((R, 4 * C), device=tr.device)
        case = dict(
            case=name, M=M, R=R, C=C, max_abs_err=float((got - want).abs().max()),
            tol=KERNEL_RTOL * scale,
            ms=cuda_ms(lambda: coalesce_table_grad(rows, w4, ct, R)),
            plain_ms=cuda_ms(lambda: coalesce_table_grad_plain(rows, w4, ct, R)),
            # yardstick: index_add_ of the materialised [M, 4C] product
            library_ms=cuda_ms(lambda: acc.index_add_(0, rows, upd)),
        )
        case["bound_ms"], case["bound_by"] = coalesce_bound_ms(M, R, C)
        _report("coalesce_table_grad", name, case, scale)
        results.append(case)
        del upd, acc, got, want
    return results


def check_segsum(tr):
    from rodynrf_tpu_torch.ops.segsum import segment_rows_sum, segment_rows_sum_plain

    gen = torch.Generator(device=tr.device).manual_seed(1)
    results = []
    for name, rows, u, R in segsum_cases(tr, gen):
        M, C = u.shape
        got = segment_rows_sum(rows, u, R)
        want = segment_rows_sum_plain(rows, u, R)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        plain_ms = cuda_ms(lambda: segment_rows_sum_plain(rows, u, R))
        case = dict(
            case=name, M=M, R=R, C=C, dtype=str(u.dtype).replace("torch.", ""),
            max_abs_err=float((got - want).abs().max()), tol=KERNEL_RTOL * scale,
            # the kernel time includes the stable sort of the rows
            ms=cuda_ms(lambda: segment_rows_sum(rows, u, R)),
            # the plain version is one index_add_ call: it is the yardstick too
            plain_ms=plain_ms, library_ms=plain_ms,
        )
        case["bound_ms"], case["bound_by"] = segsum_bound_ms(M, R, C, u.element_size())
        _report("segment_rows_sum", name, case, scale)
        results.append(case)
        del got, want, u
    return results


def launches_per_step(S, layouts) -> dict:
    """Table-gradient launches in one step, per kernel: one per orientation
    of every field evaluation that carries a gradient (one gather covers all
    strides); a strided field's go to the coalesce kernel, a merged field's
    to the segment-sum kernel. Sequential passes: static E (+ F, G, FF, BB
    with pose optimisation), dynamic A, B, C, D; A/B reuse E's static eval
    detached."""
    evals = {"static": 1 + (4 if S.optimize_poses else 0), "dynamic": 4}
    out = {k: 0 for k in KERNELS}
    for field, n in evals.items():
        out["segsum" if layouts[field] == "merged" else "coalesce"] += 3 * n
    return out


def counters():
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad
    from rodynrf_tpu_torch.ops.segsum import sorted_segment_rows_sum

    return {"coalesce": coalesce_table_grad.launches,
            "segsum": sorted_segment_rows_sum.launches}


def reset_counters():
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad
    from rodynrf_tpu_torch.ops.segsum import sorted_segment_rows_sum

    coalesce_table_grad.launches = 0
    sorted_segment_rows_sum.launches = 0


def run_steps(tr, n: int, label: str):
    """n train steps; raises on a non-finite metric. Returns the metrics."""
    history = [tr.run_step() for _ in range(n)]
    torch.cuda.synchronize()
    for m in history:
        vals = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{label}: non-finite {bad}")
        log(f"[{label}] total_loss {vals['total_loss']:.6f} mse {vals['mse']:.6f} "
            f"psnr {vals['psnr']:.3f} ({len(vals)} finite metrics)")
    return history


def drive_path(tr, path: str, smi: str, kernel_ms_per_step: float):
    """The main path of one configuration: counts set to 0, 2 warm + 5 timed
    steps, counts read, then one profiled step. Prints and returns its
    `main_path` record."""
    S = tr.step_fn.S
    layouts = tr.table_layouts()
    per_step = launches_per_step(S, layouts)
    n_steps = WARM_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    run_steps(tr, WARM_STEPS, f"{path} warm")
    t0 = time.time()
    run_steps(tr, TIMED_STEPS, f"{path} timed")
    step_s = (time.time() - t0) / TIMED_STEPS
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{path}] {step_s * 1e3:.1f} ms/step, {tr.args.batch_size / step_s:.1f} rays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, layouts {layouts}, launches {launches} ({smi})")
    for k in KERNELS:
        if launches[k] != per_step[k] * n_steps:
            raise AssertionError(f"{path}: {k} launches {launches[k]} != {per_step[k]} x "
                                 f"{n_steps} steps")
        if per_step[k] == 0 and path == "default":
            raise AssertionError(f"the default path launched no {k} kernel")
    # where the step's device time goes (after the counts were read)
    prof = profile_step(tr)
    record = {
        "path": path, "layouts": layouts, "grid": list(S.static_cfg.grid_size),
        "n_samples": S.n_samples, "ms_per_step": step_s * 1e3,
        "rays_per_s": tr.args.batch_size / step_s, "peak_gib": peak / 2**30,
        "steps": n_steps, "timed_steps": TIMED_STEPS, "launches": launches,
        "launches_per_step": per_step, "table_grad_kernel_ms_per_step": kernel_ms_per_step,
        **prof,
        # the profiled step's device time over the unprofiled steps' wall
        # time: the step's work is the same every step, so this estimates
        # the device's idle share without the profiler's own overhead
        "idle_share_est": 1.0 - prof["device_busy_ms"] / (step_s * 1e3),
        "card": smi,
    }
    log(json.dumps({"main_path": record}))
    return record


def cross_upsample(tr, smi: str):
    """The default path across its first upsample: the step at
    upsamp_list[0] (old layouts) ends with the upsample; then 2 steps with
    the layouts the port's rule re-chose. Prints and returns the record."""
    S_old, old_layouts = tr.step_fn.S, tr.table_layouts()
    tr.iteration = tr.args.upsamp_list[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    run_steps(tr, 1, "upsample step")
    cross_s = time.time() - t0
    crossing = counters()
    if crossing != launches_per_step(S_old, old_layouts):
        raise AssertionError(f"upsample step launches {crossing} != "
                             f"{launches_per_step(S_old, old_layouts)}")
    S, layouts = tr.step_fn.S, tr.table_layouts()
    grid = list(S.static_cfg.grid_size)
    if grid == list(S_old.static_cfg.grid_size) or list(S.dynamic_cfg.grid_size) != grid:
        raise AssertionError(f"the upsample did not grow the grid: {grid}")
    log(f"[upsample] grid {list(S_old.static_cfg.grid_size)} -> {grid}, samples/ray "
        f"{S_old.n_samples} -> {S.n_samples}, layouts {old_layouts} -> {layouts}")
    per_step = launches_per_step(S, layouts)
    reset_counters()
    t0 = time.time()
    run_steps(tr, 2, "after upsample")
    after_s = (time.time() - t0) / 2
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    if launches != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"after the upsample: launches {launches} != 2 x {per_step}")
    record = {
        "path": "default_upsample", "grid_before": list(S_old.static_cfg.grid_size),
        "grid": grid, "n_samples_before": S_old.n_samples, "n_samples": S.n_samples,
        "layouts_before": old_layouts, "layouts": layouts,
        "crossing_step_s": cross_s, "crossing_launches": crossing,
        "ms_per_step_after": after_s * 1e3, "launches_after": launches,
        "launches_per_step": per_step, "peak_gib": peak / 2**30, "card": smi,
    }
    log(f"[upsample] 2 steps after: {after_s * 1e3:.1f} ms/step, launches {launches}, "
        f"peak memory {peak / 2**30:.2f} GiB ({smi})")
    log(json.dumps({"main_path": record}))
    return record


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
    """TINY step on the card vs on the CPU from the same weights, for the f32
    strided path, the bf16 auto path (dynamic merged) and the bf16 path
    across the TINY upsample at iteration 8. A step from identical weights
    agrees to 1e-4 (f32 sums in another order); a step after one update to
    1e-3, since Adam's scale-free update turns ulp-level gradient
    differences into lr-sized steps of the parameters between the two."""
    from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene
    from rodynrf_tpu_torch.train import Trainer, parse_cmd
    from rodynrf_tpu_torch.train.convert import params_to_numpy, params_from_numpy

    def pair(flags):
        made = []
        for device in ("cpu", "cuda"):
            args = parse_cmd(tiny_cmd("ndc", 1) + flags)
            args.golden_det = 1
            made.append(Trainer(args, tiny_scene("ndc"), device=device))
        cpu, gpu = made
        gpu.set_params(params_from_numpy(params_to_numpy(cpu.params), "cuda"))
        return cpu, gpu

    def compare(label, cpu, gpu, limits):
        worst_by_step = []
        for step, limit in enumerate(limits):
            mc = {k: float(v) for k, v in cpu.run_step().items()}
            mg = {k: float(v) for k, v in gpu.run_step().items()}
            worst = 0.0
            for k, v in mc.items():
                rel = abs(mg[k] - v) / max(abs(v), 1e-7)
                worst = max(worst, rel)
                if not rel <= limit:
                    raise AssertionError(f"TINY {label} step {step} {k}: card {mg[k]} vs CPU {v}")
            log(f"[reference] TINY {label} step {step} (iteration {cpu.iteration - 1}) on the "
                f"card vs the CPU: {len(mc)} losses, worst relative difference {worst:.2e} "
                f"(limit {limit:g})")
            worst_by_step.append(worst)
        return worst_by_step

    out = {}
    out["f32_strided"] = compare("f32 strided", *pair(" --vm_layout strided"), (1e-4, 1e-3))
    cpu, gpu = pair(" --bf16 1")
    if not cpu.table_layouts() == gpu.table_layouts() == {"static": "strided",
                                                           "dynamic": "merged"}:
        raise AssertionError(f"TINY bf16 auto layouts {gpu.table_layouts()}")
    out["bf16_auto"] = compare("bf16 auto", cpu, gpu, (1e-4, 1e-3))
    cpu, gpu = pair(" --bf16 1")
    grid0 = gpu.static_cfg.grid_size
    cpu.iteration = gpu.iteration = cpu.args.upsamp_list[0]
    out["bf16_upsample"] = compare("bf16 across the upsample", cpu, gpu, (1e-4, 1e-3))
    if gpu.static_cfg.grid_size == grid0 or gpu.static_cfg.grid_size != cpu.static_cfg.grid_size:
        raise AssertionError("the TINY upsample did not grow both grids alike")
    if gpu.table_layouts() != cpu.table_layouts():
        raise AssertionError("card and CPU chose different layouts after the TINY upsample")
    return out


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import rodynrf_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from rodynrf_tpu_torch.data import make_synthetic_scene
    from rodynrf_tpu_torch.ops import cuda_build
    from rodynrf_tpu_torch.train import Trainer, parse_cmd

    # 1. the card
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} x{count}")

    # 2. build
    t0 = time.time()
    reports = cuda_build.build(KERNELS)
    log(f"[build] {time.time() - t0:.1f} s (compiled: {sorted(reports) or 'none, cached'})")
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + " | ".join(sorted(set(regs))))

    # the two paths' trainers (the kernel checks draw their inputs from them)
    scene = make_synthetic_scene(**SCENE, ray_type=parse_cmd(" ".join(RECIPE)).ray_type)
    trainers = {}
    for path, config in (("f32_strided", CONFIG_F32), ("default", CONFIG_DEFAULT)):
        args = parse_cmd(" ".join(config))
        t0 = time.time()
        tr = trainers[path] = Trainer(args, scene)
        S = tr.step_fn.S
        log(f"[train] {path}: grid {S.static_cfg.grid_size}, {S.n_samples} samples/ray, batch "
            f"{args.batch_size}, bf16 {args.bf16}, vm_layout {args.vm_layout} -> "
            f"{tr.table_layouts()}, {scene.n_frames} frames {scene.img_wh[0]}x{scene.img_wh[1]}, "
            f"set-up {time.time() - t0:.1f} s")
        if S.n_samples != 270 or tuple(S.static_cfg.grid_size) != (331, 368, 220):
            raise AssertionError("not the 300³ operating point")
    if trainers["default"].table_layouts() != {"static": "strided", "dynamic": "merged"}:
        raise AssertionError("the default path must put the dynamic field on the merged "
                             "layout and the static field on the strided one")

    # 3. kernels against their plain versions
    coalesce = check_coalesce(trainers["f32_strided"])
    segsum = check_segsum(trainers["default"])
    evals = {"static": 1 + 4 * trainers["default"].step_fn.S.optimize_poses, "dynamic": 4}
    f32_ms = sum(c["ms"] * evals[c["case"].split()[0]] for c in coalesce)
    default_ms = (sum(c["ms"] * evals["static"] for c in coalesce if c["case"].startswith("static"))
                  + sum(c["ms"] * evals["dynamic"] for c in segsum))
    log(f"[kernel] table-gradient kernels per train step (evals x shapes above): f32 strided "
        f"{f32_ms:.2f} ms (coalesce only); default {default_ms:.2f} ms (static coalesce at its "
        f"f32 cases + dynamic segment sum)")

    # 4, 4b, 4c. the main paths
    records = [drive_path(trainers["f32_strided"], "f32_strided", smi, f32_ms)]
    del trainers["f32_strided"]
    torch.cuda.empty_cache()
    records.append(drive_path(trainers["default"], "default", smi, default_ms))
    records.append(cross_upsample(trainers["default"], smi))
    del trainers
    torch.cuda.empty_cache()

    # 5. small-input reference
    tiny_worst = small_input_reference()
    log(json.dumps({"tiny_worst_rel": tiny_worst}))

    # 6. report
    def launches(kernel):
        return sum(r.get("launches", {}).get(kernel, 0) + r.get("crossing_launches", {}).get(
            kernel, 0) + r.get("launches_after", {}).get(kernel, 0) for r in records)

    def entry(name, kernel, source, replaces, cases):
        main_case = max(cases, key=lambda c: c["M"] * c["C"])
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches(kernel),
            "launches_by_path": {r["path"]: r.get("launches", r.get("launches_after"))[kernel]
                                 for r in records},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "case": main_case["case"], "cases": cases,
        }

    kernels = [
        entry("coalesce_table_grad", "coalesce", "rodynrf_tpu_torch/csrc/coalesce.cu",
              "rodynrf_tpu/ops/coalesced.py:259", coalesce),
        entry("segment_rows_sum", "segsum", "rodynrf_tpu_torch/csrc/segsum.cu",
              "rodynrf_tpu/ops/pallas_segsum.py:44", segsum),
    ]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was launched no time on the main paths")
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.time() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
