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
     shapes (bf16 output at the static field's, as on the default path),
     the segment-sum kernel's factored form at the three merged shapes of
     the default path; the bf16 output equal to the f32 output rounded, bit
     for bit. Per shape: the split (the radix sort and each of the three
     launches, timed alone), the kernel time (sort included; median and
     spread of 5 CUDA-event windows of 20 calls), the plain version's and
     the index_add_ yardstick's times, the bound of the contract, and the
     backward's whole table-gradient section, new route against the
     earlier composition (32-bit stable sort, int32 cast, f32 output, cast;
     for the merged form also the u pass) timed in turns, with the device
     launches of one call of each from the profiler;
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
  7. the CLI at full width: a synthetic 12-frame scene written in the
     Nvidia on-disk layout at 540×960 with the port's PNG writer, then
     `rodynrf_tpu_torch.cli.main` of configs/Nvidia_no_poses.txt at 300³
     with --downsample_train 2 (every resize of the loader to 270×480),
     3 steps, checkpoints, the evaluation of all 12 frames; then
     --render_only from the saved .npz, which must give the same per-frame
     PSNRs, and one step resumed from it. Kernel launches counted over the
     CLI's training. A `render` and a `cli` JSON line;
  8. the golden gates on the card: the first-step gradients of
     golden/tiny.txt on the committed fixture against the reference's
     (golden/out/grads_ref.npz, 72 tensors, relative error <= 1e-3), and
     the reference's final .th pair rendered through the port against the
     reference's own PNGs (>= 50 dB each);
  9. compaction at full width (the recipe at 300³, bf16 auto):
     9a. `Trainer.update_alpha_mask()` of a default trainer (its random
         weights; a 192³ × 12 mask): seconds, occupancy, peak GiB;
     9b. a fresh trainer with --compact_train 1 loads the committed
         converged-scene mask (golden/out_quality/no_poses/alpha_mask.npz)
         and enables compaction (K, F from the probe): 2 warm + 5 timed
         compacted steps with counts and a profile (a `main_path` line,
         path `compact`); each kernel held to its plain version at the
         step's compacted shapes, with its time, the plain and index_add_
         times and the bound;
     9c. a trainer with --app_frac 0.25 --app_start 0, no mask: 2 steps,
         launches counted (the split packs launch each kernel twice per
         orientation);
     9d. (inside phase 7, on its checkpoint) --render_only with the
         committed mask and --compact_eval 1: one 8192-ray chunk held to
         the superset-masked dense oracle, and a `render_compact` line
         (ms/frame, rays/s, the flat bucket's N and occupied share per
         chunk, peak GiB);
  10. the step's memory options (the JAX trainer's auto rules, ported):
     10a. (after 4c) three more paths at 300³, each with counts, steps and
         a profile like 4b: `accum4` (the recipe's default: its 640³
         N_voxel_final makes --grad_accum 0 take 4 micro-batches of 256
         rays), `fused` (--fused_passes 1, pass_chunk and remat auto) and
         `remat` (--remat on). The paths 4-4c, 7 and 9 pass --grad_accum 1
         --remat off: the single batch of 1024 rays in store mode that
         their records hold (on one batch the auto rule would
         rematerialize);
     10b. (after 9) the recipe as it stands, 16³ to 640³: the first grid
         and each of the seven upsamples, 2 steps each, with one `walk_size`
         line per grid (samples per ray, policies, table bytes, ms/step,
         peak reset per size); at 640³ one step on a single batch of 1024
         rays (--grad_accum 1) rematerialized, as the auto rule resolves it,
         and one in store mode, each with its peak; a profiled step and a
         full checkpoint save;
     10c. both kernels held to their plain versions at one 640³
         micro-batch's shapes (the segment sum at the merged layout's:
         'auto' puts the 640³ dynamic field on the strided one);
     10d. (inside phase 5) the TINY accumulated, batched and
         rematerialized steps on the card against the CPU;
  6. (printed last) a `main_path` JSON line per path, one JSON line of
     kernels, the nvidia-smi line, and the result line.

`python3 chip_smoke.py --kernels-only` runs phases 1-3 alone and prints the
cases as one `kernel_cases` JSON line.

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
# The recipe's N_voxel_final (640³) makes the auto rules take 4
# micro-batches (grad_accum 0 -> 4) and, on one batch, rematerialization;
# the 300³ operating points of PERF.md §5 are single batches of 1024 rays in
# store mode, so they ask for that.
ONE_BATCH = ["--grad_accum", "1", "--remat", "off"]
CONFIG_F32 = RECIPE + ONE_BATCH + ["--bf16", "0", "--vm_layout", "strided"]
CONFIG_DEFAULT = RECIPE + ONE_BATCH  # --bf16 1 --vm_layout auto: the recipe's defaults
# phase 10a: the step's memory options at 300³, beside the default path
CONFIG_MEMORY = {
    "accum4": RECIPE,  # the auto rules: 4 micro-batches of 256 rays, store mode
    "fused": RECIPE + ["--grad_accum", "1", "--fused_passes", "1"],  # pass_chunk, remat auto
    "remat": RECIPE + ["--grad_accum", "1", "--remat", "on"],
}
# phase 10b: the recipe as it stands (16³ -> 640³ over upsamp_list), every
# auto policy on
CONFIG_WALK = RECIPE[:4]
WALK_STEPS = 2
WALK_FINAL_GRID = (706, 786, 471)  # 640³ over the synthetic scene's aabb
SCENE = dict(T=12, H=270, W=480)
CLI_SCENE = dict(T=12, H=540, W=960)  # on disk; --downsample_train 2 -> 270×480
CLI_STEPS = 3
CLI_VOXELS = "27000000"  # the 300³ grid, as phases 4-4c
# the committed converged-scene occupancy mask (192³ × 12, 38.8% occupied)
MASK_NPZ = str(Path(__file__).resolve().parent / "golden" / "out_quality" / "no_poses"
               / "alpha_mask.npz")
CONFIG_COMPACT = RECIPE + ONE_BATCH + ["--compact_train", "1"]
CONFIG_APP = RECIPE + ONE_BATCH + ["--app_frac", "0.25", "--app_start", "0"]
ORACLE_RTOL, ORACLE_ATOL = 2e-5, 2e-6  # compact chunk vs its dense oracle (the JAX contract)
GOLDEN_GRAD_RTOL, GOLDEN_MIN_PSNR = 1e-3, 50.0
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


def median_ms(fn, windows: int = 5, reps: int = 20):
    """Median and spread (max - min) in ms of `windows` CUDA-event windows
    of `reps` launches each, after 3 warm launches."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2], times[-1] - times[0]


def device_profile(fn, reps: int = 20):
    """(device ms per call, device activities per call) of fn from
    torch.profiler: the summed time of every kernel, memset and copy it ran
    on the card over `reps` calls, after 3 warm calls. Unlike CUDA events it
    leaves out the gaps where the card waits for the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(3):  # a profiler run now and then records no device activity: redo it
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) or 0.0 for e in events)
    return busy_us / 1e3 / reps, sum(e.count for e in events) / reps


def log_activities(label: str, fn) -> None:
    """The device activities of one call of fn, by name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            log(f"[launches] {label}: x{e.count} "
                f"{(getattr(e, 'self_device_time_total', 0.0) or 0.0):8.1f} us  {e.key[:100]}")


def in_turns(old, new):
    """Two callables timed in turns (old, new, new, old), by CUDA events and
    by the profiler's device time: {"old"/"new": [event ms, device ms]},
    each the mean of its two turns."""
    runs = [(median_ms(f)[0], device_profile(f)[0]) for f in (old, new, new, old)]
    mean = lambda a, b: [(x + y) / 2 for x, y in zip(a, b)]
    return {"old": mean(runs[0], runs[3]), "new": mean(runs[1], runs[2])}


def _stages(launch):
    """One call's pieces alone on preallocated buffers (stage bits of
    csrc/segreduce.cuh `Call`: 8 the radix sort, 1 zero fill, 2 chunk walk,
    both in the one launch the call makes of them, 4 fixup)."""
    return {"sort": lambda: launch(8), "zero_rows": lambda: launch(1),
            "chunk_walk": lambda: launch(2), "zero_and_walk": lambda: launch(3),
            "fixup": lambda: launch(4)}


def split_ms(pieces: dict) -> dict:
    """{piece: [event median ms, spread ms, device ms]} for each callable,
    timed alone."""
    return {k: [*median_ms(fn), device_profile(fn)[0]] for k, fn in pieces.items()}


def _log_split(kind, name, split):
    log(f"[split] {kind} {name}: " + ", ".join(
        f"{k} {m:.4f} ms (±{s:.4f}; device {d:.4f})" for k, (m, s, d) in split.items()))


def stable_sort_int32(rows):
    """The earlier route's sort: torch's stable sort over all 32 key bits
    with an int64 permutation, then its cast to int32."""
    keys, perm = torch.sort(rows, stable=True)
    return keys, perm.to(torch.int32)


def coalesce_bound_ms(M: int, R: int, C: int, out_bytes: int):
    """Least time for the table gradient: each input read once (rows int32,
    w4 [M,4] f32, ct [M,C] f32), the output [R,4C] written once in its dtype
    (out_bytes a value), over the memory rate; 4·M·C products and adds over
    the f32 rate. Returns (ms, bound_by)."""
    bytes_moved = 4 * M + 16 * M + 4 * M * C + out_bytes * 4 * R * C
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = 2 * 4 * M * C / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def factored_bound_ms(M: int, R: int, nS: int, C: int, out_bytes: int):
    """Least time for the factored segment sum: idx (int32), w [M,nS,4] f32
    and ct [M,nS,C] f32 read once, the output [R, nS·4·C] written once in
    its dtype, over the memory rate; nS·4·C products and adds per entry over
    the f32 rate. Returns (ms, bound_by)."""
    W = nS * 4 * C
    bytes_moved = 4 * M + 16 * nS * M + 4 * M * nS * C + out_bytes * R * W
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = 2 * M * W / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_summary(report: str):
    """[(kernel, "N registers, S bytes spilled")] from nvcc's -Xptxas -v
    report, names demangled by c++filt where the toolkit's host has it."""
    import re
    import shutil

    out, fn = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn and "spill stores" in ln:
            out[fn]["spill"] = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif fn and "Used" in ln and "registers" in ln:
            out[fn]["regs"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    names = list(out)
    if names and shutil.which("c++filt"):
        shown = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(shown) == len(names):
            names = [n.replace("segreduce::", "").replace("(anonymous namespace)::", "")
                     for n in shown]
    return [(n.split("(")[0] if "(" in n else n,
             f"{v.get('regs', '?')} registers, {v.get('spill', 0)} bytes spilled")
            for n, v in zip(names, out.values())]


def sample_points(tr, n_rays=None):
    """The first batch's sample points (pass E's, jitter-free) normalised
    for the static field, and their warped positions for the dynamic one;
    the batch's first `n_rays` rays (default all: one micro-batch's with
    accumulation)."""
    from rodynrf_tpu_torch.core.se3 import pose_to_mtx
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.render.sampling import sample_xyz
    from rodynrf_tpu_torch.train.schedule import PermutationSampler
    from rodynrf_tpu_torch.train.step import _rays_from_idx, focal_from_fov

    S, p = tr.step_fn.S, tr.params
    ids = PermutationSampler(tr.scene.n_rays, tr.args.batch_size, tr.args.seed).nextids()
    ray_idx = torch.as_tensor(ids[:n_rays]).to(tr.device)
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


def compact_points(tr):
    """The points the compacted step's field evaluations sample: the first
    batch's pass-E geometry (jitter-free) masked by the union occupancy of
    the train and random times, compacted to the [R, K] bucket and, with
    the flat bucket on, to its F·R slots; normalised for the static field,
    and warped for the dynamic one. Returns ((static points, warped
    points), {name: the selection op at this geometry, for timing})."""
    from rodynrf_tpu_torch.core.se3 import pose_to_mtx
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.render.pipeline import _flat_index
    from rodynrf_tpu_torch.render.sampling import sample_xyz
    from rodynrf_tpu_torch.train.schedule import PermutationSampler
    from rodynrf_tpu_torch.train.step import (_compact_samp, _occupancy, _rays_from_idx,
                                              focal_from_fov)

    S, p = tr.step_fn.S, tr.params
    ids = PermutationSampler(tr.scene.n_rays, tr.args.batch_size, tr.args.seed).nextids()
    ids2 = PermutationSampler(tr.scene.n_rays, tr.args.batch_size, tr.args.seed + 1).nextids()
    ray_idx, ray_rand = (torch.as_tensor(i).to(tr.device) for i in (ids, ids2))
    ops = {}
    with torch.no_grad():
        focal = focal_from_fov(p["fov"][0, 0], S.H, S.W)
        rays, _, _, _ = _rays_from_idx(ray_idx, pose_to_mtx(p["pose"]), focal, S)
        xyz, z, valid = sample_xyz(rays, S.n_samples, S.ray_type, S.static_cfg.near_far,
                                   tr.aabb, S.step_size, None, det_jitter=True)
        ts, ts_rand = tr.data["ts"][ray_idx], tr.data["ts"][ray_rand]
        ops["occupancy"] = lambda: _occupancy(tr.data, xyz, ts, valid, S.alpha_shape)
        occ = (_occupancy(tr.data, xyz, ts, valid, S.alpha_shape)
               | _occupancy(tr.data, xyz, ts_rand, valid, S.alpha_shape))
        ops["compact_samp"] = lambda: _compact_samp(xyz, z, occ, rays, S.ray_type, S.compact_k)
        (xyz_c, _, keep, _), _ = ops["compact_samp"]()
        R, K = keep.shape
        flat = xyz_c.reshape(-1, 3)
        t_flat = ts[:, None].expand(R, K).reshape(-1)
        if S.compact_flat:
            ops["flat_index"] = lambda: _flat_index(keep, S.compact_flat * R)
            _, idx_safe, rid = ops["flat_index"]()
            flat, t_flat = flat[idx_safe], ts[rid]
        warped = dyn.normalize_coord(dyn.warp_coordinate(p["dynamic"], flat, t_flat, tr.aabb),
                                     tr.aabb)
    return (dyn.normalize_coord(flat, tr.aabb), warped), ops


def coalesce_cases(tr, gen, points=None, fields=("static", "dynamic")):
    """(name, rows, w4, ct, R) at every strided table-gradient shape of the
    trainer's step (the fields' orientations 0-2), rows and weights from
    `points` (default: the first batch's sample points), ct drawn from
    `gen`."""
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.fields import static as stat
    from rodynrf_tpu_torch.ops.fused_vm import plane_rows_weights

    S, p = tr.step_fn.S, tr.params
    pts_static, warped = points if points is not None else sample_points(tr)
    with torch.no_grad():
        packs = {
            "static": (stat.pack_tables(p["static"], S.static_cfg), pts_static),
            "dynamic": (dyn.pack_tables(p["dynamic"], S.dynamic_cfg), warped),
        }
    cases = []
    for field, o in [(f, o) for f in fields for o in range(3)]:
        packed, pts = packs[field]
        assert packed.meta["layout"] == "strided"
        idx, w = plane_rows_weights(packed, pts, o)
        rows, w4 = torch.cat(idx).contiguous(), torch.cat(w).contiguous()
        R, C = packed.tables[o].shape[0], packed.tables[o].shape[1] // 4
        ct = torch.randn((rows.shape[0], C), generator=gen, device=tr.device)
        cases.append((f"{field} o{o}", rows, w4, ct, R))
    return cases


def segsum_cases(tr, gen, points=None, cfg=None):
    """(name, rows, w, ct, R, table dtype) at the three merged table-gradient
    shapes of the default path's dynamic field (or of `cfg`): rows from the
    merged row map at the warped sample points (`points`, default the first
    batch's), the step's corner weights w and a seeded ct."""
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.ops.fused_vm import merged_rows_weights

    S = tr.step_fn.S
    _, warped = points if points is not None else sample_points(tr)
    with torch.no_grad():
        packed = dyn.pack_tables(tr.params["dynamic"], cfg or S.dynamic_cfg)
    assert packed.meta["layout"] == "merged"
    cases = []
    for o in range(3):
        table = packed.tables[o]
        rows, w = merged_rows_weights(packed, warped, o)
        M, nS = w.shape[0], w.shape[1]
        C = table.shape[1] // (nS * 4)
        ct = torch.randn((M, nS, C), generator=gen, device=tr.device)
        cases.append((f"dynamic merged o{o}", rows.contiguous(), w.contiguous(), ct,
                      table.shape[0], table.dtype))
    return cases


def _report(kind, name, case, scale):
    sec = case["section"]
    log(f"[kernel] {kind} {name}: M={case['M']} R={case['R']} C={case['C']} out {case['out']} "
        f"max_abs_err={case['max_abs_err']:.3e} (tol {case['tol']:.3e}, max|plain| {scale:.3e}), "
        f"{case['out']} = f32 rounded bit for bit: {case['out_bit_exact']}; kernel "
        f"{case['ms']:.4f} ms (±{case['ms_spread']:.4f}; device {case['device_ms']:.4f}), plain "
        f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms; section old {sec['old'][0]:.4f} ms (device "
        f"{sec['old'][1]:.4f}, {case['launches_old']:g} launches) -> new {sec['new'][0]:.4f} ms "
        f"(device {sec['new'][1]:.4f}, {case['launches_new']:g} launches)")
    if not case["max_abs_err"] <= case["tol"]:
        raise AssertionError(f"{kind} kernel disagrees with its plain version at {name}")
    if not case["out_bit_exact"]:
        raise AssertionError(f"{kind} {name}: the {case['out']} output is not the f32 output "
                             "rounded")


def check_coalesce(tr):
    """The coalesce kernel at the six strided shapes, writing the table dtype
    of the default path (bf16 for the static field, f32 for the dynamic one,
    which is strided on the f32 path only)."""
    from rodynrf_tpu_torch.ops import coalesced as tco
    from rodynrf_tpu_torch.ops.segsum import key_bits, new_scratch

    gen = torch.Generator(device=tr.device).manual_seed(0)
    lib = tco._lib()
    f32 = torch.float32
    results = []
    for name, rows, w4, ct, R in coalesce_cases(tr, gen):
        M, C = ct.shape
        out = torch.bfloat16 if name.startswith("static") else f32
        got32 = tco.coalesce_table_grad(rows, w4, ct, R)
        got = tco.coalesce_table_grad(rows, w4, ct, R, out)
        want = tco.coalesce_table_grad_plain(rows, w4, ct, R)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        scratch = new_scratch(lib, M, key_bits(R - 1), 4 * C, ct.device)
        buf = torch.empty_like(got)
        split = split_ms(_stages(lambda bit: tco._launch(
            lib, w4, ct, R, out, rows=rows, stages=bit, scratch=scratch, out=buf)))
        _log_split("coalesce_table_grad", name, split)
        new = lambda: tco.coalesce_table_grad(rows, w4, ct, R, out)

        def old():  # the earlier call site: 32-bit stable sort, int32 cast, f32 out, cast
            k, p = stable_sort_int32(rows)
            return tco._launch(lib, w4, ct, R, f32, keys=k, perm=p).to(out)

        if not results:  # what one call runs on the card, new route and earlier one
            log_activities(f"coalesce {name} new", new)
            log_activities(f"coalesce {name} old", old)
        upd = (w4[:, :, None] * ct[:, None, :]).reshape(M, 4 * C)
        acc = torch.zeros((R, 4 * C), device=tr.device)
        ms, spread = median_ms(new)
        device_ms, launches_new = device_profile(new)
        case = dict(
            case=name, M=M, R=R, C=C, out=str(out).replace("torch.", ""),
            max_abs_err=float((got32 - want).abs().max()), tol=KERNEL_RTOL * scale,
            out_bit_exact=bool(torch.equal(got, got32.to(out))),
            ms=ms, ms_spread=spread, device_ms=device_ms,
            ms_f32=median_ms(lambda: tco.coalesce_table_grad(rows, w4, ct, R))[0],
            plain_ms=median_ms(lambda: tco.coalesce_table_grad_plain(rows, w4, ct, R, out))[0],
            # yardstick: index_add_ of the materialised [M, 4C] product
            library_ms=median_ms(lambda: acc.index_add_(0, rows, upd))[0],
            split=split, section=in_turns(old, new),
            launches_new=launches_new, launches_old=device_profile(old)[1],
        )
        case["bound_ms"], case["bound_by"] = coalesce_bound_ms(M, R, C, got.element_size())
        _report("coalesce_table_grad", name, case, scale)
        results.append(case)
        del upd, acc, got, got32, want, scratch, buf
    return results


def check_segsum(tr):
    """The segment-sum kernel at the three merged shapes: the factored form
    the default path runs (bf16 table), and the upd form of the earlier call
    site, held to their plain versions."""
    from rodynrf_tpu_torch.ops import segsum as tseg

    gen = torch.Generator(device=tr.device).manual_seed(1)
    lib = tseg._lib()
    results = []
    for name, rows, w, ct, R, dtype in segsum_cases(tr, gen):
        M, nS, C = ct.shape
        W = nS * 4 * C
        u = tseg.factored_update(w, ct, dtype)
        got32 = tseg.segment_rows_sum_factored(rows, w, ct, R, dtype, torch.float32)
        got = tseg.segment_rows_sum_factored(rows, w, ct, R, dtype)
        want = tseg.segment_rows_sum_factored_plain(rows, w, ct, R, dtype, torch.float32)
        upd_err = float((tseg.segment_rows_sum(rows, u, R) - want).abs().max())
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        scratch = tseg.new_scratch(lib, M, tseg.key_bits(R), W, ct.device)
        buf = torch.empty_like(got)
        split = split_ms(_stages(lambda bit: tseg._launch_factored(
            lib, w, ct, R, dtype, dtype, rows=rows, stages=bit, scratch=scratch, out=buf)))
        _log_split("segment_rows_sum", name, split)
        new = lambda: tseg.segment_rows_sum_factored(rows, w, ct, R, dtype)

        def old():  # the earlier call site: form u, 32-bit sort, upd form in f32, cast
            k, p = stable_sort_int32(rows)
            return tseg.sorted_segment_rows_sum(k, tseg.factored_update(w, ct, dtype), R,
                                                p).to(dtype)

        if not results:
            log_activities(f"segsum {name} new", new)
            log_activities(f"segsum {name} old", old)
        ms, spread = median_ms(new)
        device_ms, launches_new = device_profile(new)
        case = dict(
            case=name, M=M, R=R, C=W, nS=nS, dtype=str(dtype).replace("torch.", ""),
            out=str(dtype).replace("torch.", ""),
            max_abs_err=float((got32 - want).abs().max()), tol=KERNEL_RTOL * scale,
            upd_form_max_abs_err=upd_err,
            out_bit_exact=bool(torch.equal(got, got32.to(dtype))),
            ms=ms, ms_spread=spread, device_ms=device_ms,
            plain_ms=median_ms(
                lambda: tseg.segment_rows_sum_factored_plain(rows, w, ct, R, dtype))[0],
            # yardstick: index_add_ in f32 of the pre-formed u
            library_ms=median_ms(lambda: tseg.segment_rows_sum_plain(rows, u, R))[0],
            split=split, section=in_turns(old, new),
            launches_new=launches_new, launches_old=device_profile(old)[1],
        )
        case["bound_ms"], case["bound_by"] = factored_bound_ms(M, R, nS, C, got.element_size())
        _report("segment_rows_sum", name, case, scale)
        if not upd_err <= case["tol"]:
            raise AssertionError(f"the upd-form kernel disagrees with its plain version at {name}")
        results.append(case)
        del got, got32, want, u, ct, scratch, buf
    return results


def _kernel_case(label, kind, name, field, M, R, C, out, err, scale, ms, plain_ms, library_ms,
                 bound):
    case = dict(case=name, field=field, M=M, R=R, C=C, out=str(out).replace("torch.", ""),
                max_abs_err=err, tol=KERNEL_RTOL * scale, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1])
    log(f"[{label} kernel] {kind} {name}: M={M} R={R} C={C} out {case['out']} "
        f"max_abs_err={err:.3e} (tol {case['tol']:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    if not err <= case["tol"]:
        raise AssertionError(f"{kind} kernel disagrees with its plain version at the "
                             f"{label} shape {name}")
    return case


def check_kernels_at(tr, points, label, merged_cfg=None):
    """Both kernels held to their plain versions at the shapes a step's
    field evaluations give them (M = the rows at `points`: the compacted
    step's, `compact_points`, or one micro-batch's, `sample_points`): the
    coalesce kernel at each strided field's three orientations, in the
    table dtype; the factored segment sum at the merged field's three, or
    at those of `merged_cfg` when the step's dynamic field is strided.
    Kernel, plain and index_add_ times (CUDA events) and the bound."""
    from rodynrf_tpu_torch.ops import coalesced as tco
    from rodynrf_tpu_torch.ops import segsum as tseg

    S = tr.step_fn.S
    layouts = tr.table_layouts()
    gen = torch.Generator(device=tr.device).manual_seed(2)
    cases = []
    strided = tuple(f for f in ("static", "dynamic") if layouts[f] == "strided")
    for name, rows, w4, ct, R in coalesce_cases(tr, gen, points, strided):
        M, C = ct.shape
        cfg = S.static_cfg if name.startswith("static") else S.dynamic_cfg
        out = cfg.gather_dtype or torch.float32
        got = tco.coalesce_table_grad(rows, w4, ct, R)
        want = tco.coalesce_table_grad_plain(rows, w4, ct, R)
        torch.cuda.synchronize()
        upd = (w4[:, :, None] * ct[:, None, :]).reshape(M, 4 * C)
        acc = torch.zeros((R, 4 * C), device=tr.device)
        cases.append(_kernel_case(
            label, "coalesce_table_grad", name, name.split()[0], M, R, C, out,
            float((got - want).abs().max()), float(want.abs().max()),
            median_ms(lambda: tco.coalesce_table_grad(rows, w4, ct, R, out))[0],
            median_ms(lambda: tco.coalesce_table_grad_plain(rows, w4, ct, R, out))[0],
            median_ms(lambda: acc.index_add_(0, rows, upd))[0],
            coalesce_bound_ms(M, R, C, torch.empty((), dtype=out).element_size())))
        del upd, acc, got, want
    if layouts["dynamic"] == "merged" or merged_cfg is not None:
        cfg = None if layouts["dynamic"] == "merged" else merged_cfg
        for name, rows, w, ct, R, dtype in segsum_cases(tr, gen, points, cfg):
            M, nS, C = ct.shape
            got = tseg.segment_rows_sum_factored(rows, w, ct, R, dtype, torch.float32)
            want = tseg.segment_rows_sum_factored_plain(rows, w, ct, R, dtype, torch.float32)
            torch.cuda.synchronize()
            u = tseg.factored_update(w, ct, dtype)
            cases.append(_kernel_case(
                label, "segment_rows_sum", name, "dynamic", M, R, nS * 4 * C, dtype,
                float((got - want).abs().max()), float(want.abs().max()),
                median_ms(lambda: tseg.segment_rows_sum_factored(rows, w, ct, R, dtype))[0],
                median_ms(lambda: tseg.segment_rows_sum_factored_plain(rows, w, ct, R,
                                                                        dtype))[0],
                median_ms(lambda: tseg.segment_rows_sum_plain(rows, u, R))[0],
                factored_bound_ms(M, R, nS, C, torch.empty((), dtype=dtype).element_size())))
            del got, want, u
    return cases


def drive_compaction(scene, smi: str, device: str = "cuda"):
    """Phase 9a-9c. Returns (records for the report: the `compact` and
    `app_frac` paths, {mask_build, compact kernel cases}). (`device` and
    the module's CONFIG_* let the phase be rehearsed on the CPU at a small
    size.)"""
    from rodynrf_tpu_torch.fields.alpha_mask import load_alpha_npz
    from rodynrf_tpu_torch.train import Trainer, parse_cmd

    # 9a. the mask build of a default trainer, at its random weights
    tr = Trainer(parse_cmd(" ".join(CONFIG_DEFAULT)), scene, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    occ = tr.update_alpha_mask()
    torch.cuda.synchronize()
    build_s = time.time() - t0
    shape = list(tr.alpha_mask.alpha_volume.shape)
    want = [min(g, 192) for g in tr.dynamic_cfg.grid_size][::-1] + [scene.n_frames]
    if shape != want or tr.alpha_mask.alpha_volume.dtype != torch.uint8:
        raise AssertionError(f"mask build: volume {shape} {tr.alpha_mask.alpha_volume.dtype}")
    mask_build = {"seconds": build_s, "volume": shape, "occupancy": occ,
                  "grid": list(tr.dynamic_cfg.grid_size),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi}
    log(f"[compact] 9a mask build: {build_s:.2f} s for {shape} at grid "
        f"{mask_build['grid']}, occupancy {occ:.4f}, peak {mask_build['peak_gib']:.2f} GiB "
        f"({smi})")
    log(json.dumps({"mask_build": mask_build}))
    del tr
    torch.cuda.empty_cache()

    # 9b. the compacted step on the committed converged-scene mask
    tr = Trainer(parse_cmd(" ".join(CONFIG_COMPACT)), scene, device=device)
    tr.alpha_mask = load_alpha_npz(MASK_NPZ).to(tr.device)
    torch.cuda.synchronize()
    t0 = time.time()
    tr._enable_train_compaction()
    torch.cuda.synchronize()
    enable_s = time.time() - t0
    S = tr.step_fn.S
    if not (S.use_alpha_mask and S.compact_k > 0):
        raise AssertionError("train compaction did not enable on the committed mask")
    log(f"[compact] 9b committed mask {list(tr.alpha_mask.alpha_volume.shape)} occupancy "
        f"{float(tr.alpha_mask.alpha_volume.float().mean()):.4f}: K={S.compact_k} "
        f"flat={S.compact_flat} of {S.n_samples} samples/ray (probe + enable {enable_s:.2f} s)")
    points, ops = compact_points(tr)
    cases = check_kernels_at(tr, points, "compact")
    with torch.no_grad():  # the selection ops of one pass, at the step's shapes
        op_ms = {k: median_ms(fn)[0] for k, fn in ops.items()}
    log(f"[compact] selection ops of one pass ({tr.args.batch_size} rays x {S.n_samples} "
        "samples): " + ", ".join(f"{k} {v:.4f} ms" for k, v in op_ms.items()) + f" ({smi})")
    evals = {"static": 1 + 4 * S.optimize_poses, "dynamic": 4}
    kernel_ms = sum(c["ms"] * evals[c["field"]] for c in cases)
    log(f"[compact] table-gradient kernels per compacted step (evals x shapes above): "
        f"{kernel_ms:.2f} ms ({smi})")
    rec = drive_path(tr, "compact", smi, kernel_ms)
    if not all(rec["launches"][k] > 0 for k in KERNELS):
        raise AssertionError(f"the compacted step launched {rec['launches']}")
    rec.update(compact_k=S.compact_k, compact_flat=S.compact_flat, probe_s=enable_s,
               flat_rows_per_eval=S.compact_flat * tr.args.batch_size, selection_op_ms=op_ms)
    del tr
    torch.cuda.empty_cache()

    # 9c. appearance top-K compaction, no mask: the split packs
    tr = Trainer(parse_cmd(" ".join(CONFIG_APP)), scene, device=device)
    S, layouts = tr.step_fn.S, tr.table_layouts()
    if not (S.static_cfg.app_frac > 0 and isinstance(layouts["dynamic"], dict)):
        raise AssertionError(f"appearance compaction is not active: {layouts}")
    per_step = launches_per_step(S, layouts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    run_steps(tr, 2, "app_frac")
    app_s = (time.time() - t0) / 2
    launches = counters()
    if launches != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"app_frac: launches {launches} != 2 x {per_step}")
    app = {"path": "app_frac", **policies(S), "layouts": layouts,
           "app_topk": S.dynamic_cfg.app_topk(S.n_samples),
           "n_samples": S.n_samples, "ms_per_step": app_s * 1e3, "steps": 2,
           "launches": launches, "launches_per_step": per_step,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi}
    log(f"[compact] 9c app_frac 0.25: K={app['app_topk']} of {S.n_samples}, layouts {layouts}, "
        f"{app_s * 1e3:.1f} ms/step (2 steps, first included), launches {launches}, peak "
        f"{app['peak_gib']:.2f} GiB ({smi})")
    log(json.dumps({"main_path": app}))
    del tr
    torch.cuda.empty_cache()
    return [rec, app], {"mask_build": mask_build, "compact_cases": cases}


def launches_per_step(S, layouts) -> dict:
    """Table-gradient launches in one step, per kernel: one per orientation
    of every field evaluation that carries a gradient (one gather covers all
    strides), times the micro-batches; a strided field's go to the coalesce
    kernel, a merged field's to the segment-sum kernel. Sequential passes:
    static E (+ F, G, FF, BB with pose optimisation), dynamic A, B, C, D; A/B
    reuse E's static eval detached. Batched passes: one static evaluation
    with a gradient, one dynamic evaluation per chunk of pass_chunk of the
    passes A, B, C, D. A field's split pack (appearance compaction) launches
    its density part in each of those evaluations and its appearance part
    only where a loss reads the rgb (sequential: static E, dynamic A; batched:
    the static evaluation and each dynamic chunk holding A or B, whose rows
    share the dual compositor), each part by its own layout."""
    if S.fused_passes:
        chunk = S.pass_chunk if 0 < S.pass_chunk < 4 else 4
        evals = {"static": 1, "dynamic": -(-4 // chunk)}
        app = {"static": 1, "dynamic": -(-2 // chunk)}
    else:
        evals = {"static": 1 + (4 if S.optimize_poses else 0), "dynamic": 4}
        app = {"static": 1, "dynamic": 1}
    out = {k: 0 for k in KERNELS}
    for field, n in evals.items():
        parts = layouts[field] if isinstance(layouts[field], dict) else {"": layouts[field]}
        for part, layout in parts.items():
            kernel = "segsum" if layout == "merged" else "coalesce"
            out[kernel] += 3 * (app[field] if part == "app" else n) * S.grad_accum
    return out


def policies(S) -> dict:
    """The step's resolved memory options (Trainer auto rules)."""
    return {"grad_accum": S.grad_accum, "remat": S.remat, "fused_passes": S.fused_passes,
            "pass_chunk": S.pass_chunk}


def counters():
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad
    from rodynrf_tpu_torch.ops.segsum import segment_rows_sum_factored

    return {"coalesce": coalesce_table_grad.launches,
            "segsum": segment_rows_sum_factored.launches}


def reset_counters():
    from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad
    from rodynrf_tpu_torch.ops import segsum

    coalesce_table_grad.launches = 0
    segsum.segment_rows_sum_factored.launches = 0
    segsum.sorted_segment_rows_sum.launches = 0


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


def drive_path(tr, path: str, smi: str, kernel_ms_per_step):
    """The main path of one configuration: counts set to 0, 2 warm + 5 timed
    steps, counts read, then one profiled step. Prints and returns its
    `main_path` record (`kernel_ms_per_step`: the kernel checks' sum for
    this step's shapes, or None where they were not timed)."""
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
        f"peak memory {peak / 2**30:.2f} GiB, layouts {layouts}, {policies(S)}, launches "
        f"{launches} ({smi})")
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
        **policies(S), "n_samples": S.n_samples, "ms_per_step": step_s * 1e3,
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
        "path": "default_upsample", **policies(S), "grid_before": list(S_old.static_cfg.grid_size),
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


def profile_step(tr, top: int = 16):
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
    # the table-gradient kernels: the radix sort's, and csrc/segreduce.cuh's
    table_grad = [e for e in kernels if any(
        k in e.key for k in ("DeviceRadixSort", "segreduce::", "zero_and_walk", "fixup<"))]
    tg_ms = sum(dev_us(e) for e in table_grad) / 1e3
    log(f"[profile] table-gradient kernels (sort + reduction): {tg_ms:.2f} ms, "
        f"{sum(e.count for e in table_grad)} launches")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_launches": n_launches, "table_grad_device_ms": tg_ms}


def small_input_reference(device: str = "cuda"):
    """TINY step on the card vs on the CPU from the same weights, for the f32
    strided path, the memory options (accumulation, batched passes,
    rematerialization; phase 10d), the bf16 auto path (dynamic merged) and
    the bf16 path across the TINY upsample at iteration 8. (`device` lets
    the phase be rehearsed on the CPU.) A step from identical weights
    agrees to 1e-4 (f32 sums in another order); a step after one update to
    1e-3, since Adam's scale-free update turns ulp-level gradient
    differences into lr-sized steps of the parameters between the two."""
    from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene
    from rodynrf_tpu_torch.train import Trainer, parse_cmd
    from rodynrf_tpu_torch.train.convert import params_to_numpy, params_from_numpy

    def pair(flags):
        made = []
        for dev in ("cpu", device):
            args = parse_cmd(tiny_cmd("ndc", 1) + flags)
            args.golden_det = 1
            made.append(Trainer(args, tiny_scene("ndc"), device=dev))
        cpu, gpu = made
        gpu.set_params(params_from_numpy(params_to_numpy(cpu.params), device))
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
    # 10d: the memory options (two micro-batches of 32 rays, batched passes,
    # rematerialization), bf16 auto as the recipe runs them
    for name, flags in (("accum", " --bf16 1 --grad_accum 2"),
                        ("fused", " --bf16 1 --fused_passes 1"), ("remat", " --bf16 1 --remat on")):
        cpu, gpu = pair(flags)
        if policies(cpu.step_fn.S) != policies(gpu.step_fn.S):
            raise AssertionError(f"TINY {name}: card and CPU resolved different policies")
        out[name] = compare(name, cpu, gpu, (1e-4, 1e-3))
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


def drive_cli(smi: str, per_step: dict, grid, n_samples: int, device: str = "cuda"):
    """Phase 7: the CLI end to end on a scene written to disk. Returns the
    CLI run's main-path record (launch counts) after printing the `render`
    and `cli` lines. (`device` and the module's CLI_* sizes let the phase be
    rehearsed on the CPU at a small size.)"""
    import shutil
    import tempfile

    from rodynrf_tpu_torch.cli import main as cli_main
    from rodynrf_tpu_torch.data.video_dataset import load_scene
    from rodynrf_tpu_torch.testing import write_video_scene
    from rodynrf_tpu_torch.train import Trainer, config_parser

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        t0 = time.time()
        write_video_scene(str(root / "scene"), **CLI_SCENE)
        write_s = time.time() - t0
        argv = [RECIPE[0], RECIPE[1], "--datadir", str(root / "scene"),
                "--basedir", str(root / "log"), "--expname", "cli",
                "--downsample_train", "2", "--N_voxel_init", CLI_VOXELS,
                "--n_iters", str(CLI_STEPS), "--no_tensorboard", "1", "--render_test", "1",
                "--render_path", "0", "--N_vis", "0", "--progress_refresh_rate", "1",
                *ONE_BATCH]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.time()
        rep = cli_main(argv, device)
        cli_s = time.time() - t0
        launches = counters()
        peak_cli = torch.cuda.max_memory_allocated()
        want = {k: v * CLI_STEPS for k, v in per_step.items()}
        if launches != want:
            raise AssertionError(f"CLI run: kernel launches {launches} != {want}")
        if not all(math.isfinite(x) for x in rep["losses"]) or len(rep["losses"]) != CLI_STEPS:
            raise AssertionError(f"CLI run: losses {rep['losses']}")
        if len(rep["psnrs"]) != CLI_SCENE["T"] or not all(
                math.isfinite(p) for p in rep["psnrs"]):
            raise AssertionError(f"CLI run: evaluation PSNRs {rep['psnrs']}")
        for f in ("cli.npz", "cli.th", "cli_static.th", "imgs_test_all/mean.txt",
                  "imgs_test_all/011.png", "imgs_test_all_static/rgbd/011.npy"):
            if not (root / "log" / "cli" / f).is_file():
                raise AssertionError(f"CLI run wrote no {f}")
        log(f"[cli] scene written in {write_s:.1f} s; main: {cli_s:.1f} s (loader "
            f"{rep['loader_s']:.2f} s, {CLI_STEPS} steps {rep['train_s']:.2f} s, save "
            f"{rep['save_s']:.2f} s, evaluation {rep['eval_s']:.2f} s), launches {launches}, "
            f"losses {rep['losses']}, PSNRs {[round(float(p), 4) for p in rep['psnrs']]}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rrep = cli_main(argv + ["--render_only", "1", "--ckpt", rep["ckpt"]], device)
        render_s = time.time() - t0
        peak_render = torch.cuda.max_memory_allocated()
        if rrep["psnrs"] != rep["psnrs"]:
            raise AssertionError(f"render_only PSNRs {rrep['psnrs']} != the final evaluation's "
                                 f"{rep['psnrs']}")
        chunk_profile = (profile_render_chunk(rep["ckpt"], CLI_SCENE["H"] // 2,
                                              CLI_SCENE["W"] // 2, n_samples)
                         if device == "cuda" else {})
        render_compact = drive_compact_render(argv, rep, smi, device)

        args = config_parser(argv + ["--ckpt", rep["ckpt"], "--n_iters", str(CLI_STEPS + 1)])
        t0 = time.time()
        tr = Trainer(args, load_scene(args), device=device)
        resume_s = time.time() - t0
        if tr.iteration != CLI_STEPS:
            raise AssertionError(f"resumed at iteration {tr.iteration}, not {CLI_STEPS}")
        resumed_loss = float(tr.run_step()["total_loss"])
        if not math.isfinite(resumed_loss):
            raise AssertionError(f"the resumed step's loss is {resumed_loss}")
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    H, W = CLI_SCENE["H"] // 2, CLI_SCENE["W"] // 2
    frame_ms = sorted(1e3 * t for t in rrep["frame_s"])
    med = frame_ms[len(frame_ms) // 2]
    render = {
        "frames": len(frame_ms), "H": H, "W": W, "grid": list(grid), "n_samples": n_samples,
        "chunk": 8192, "layouts": "bf16, static strided, dynamic merged (eval budget)",
        "ms_per_frame_median": med, "rays_per_s": H * W / (med / 1e3),
        "frame_ms": [1e3 * t for t in rrep["frame_s"]], "peak_gib": peak_render / 2**30,
        "render_only_s": render_s, "chunk_profile": chunk_profile, "card": smi,
    }
    cli = {
        "scene_write_s": write_s, "loader_s": rep["loader_s"], "train_s": rep["train_s"],
        "steps": CLI_STEPS, "losses": rep["losses"], "save_s": rep["save_s"],
        "ckpt_bytes": rep["ckpt_bytes"], "load_s": rrep["load_s"], "eval_s": rep["eval_s"],
        "main_s": cli_s, "psnrs": rep["psnrs"], "render_only_psnrs_equal": True,
        "resume_s": resume_s, "resumed_first_loss": resumed_loss,
        "peak_gib_cli_run": peak_cli / 2**30, "launches": launches, "card": smi,
    }
    log(json.dumps({"render": render}))
    log(json.dumps({"cli": cli}))
    log(json.dumps({"render_compact": render_compact}))
    return {"path": "cli", "launches": launches, "launches_per_step": per_step}


def drive_compact_render(argv, rep, smi: str, device: str):
    """Phase 9d: --render_only of phase 7's checkpoint with the committed
    mask and --compact_eval 1 (every frame, the flat bucket per chunk), then
    one 8192-ray chunk of frame 0 held to the superset-masked dense oracle.
    Returns the `render_compact` record."""
    import numpy as np

    from rodynrf_tpu_torch.cli import main as cli_main
    from rodynrf_tpu_torch.core.se3 import pose_to_mtx
    from rodynrf_tpu_torch.fields.alpha_mask import load_alpha_npz
    from rodynrf_tpu_torch.fields.config import cal_n_samples
    from rodynrf_tpu_torch.render.renderer import make_chunk_renderer, rays_for_view
    from rodynrf_tpu_torch.train import config_parser
    from rodynrf_tpu_torch.train.checkpoints import load_checkpoint
    from rodynrf_tpu_torch.train.convert import params_from_numpy

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    crep = cli_main(argv + ["--render_only", "1", "--ckpt", rep["ckpt"], "--alpha_mask",
                            MASK_NPZ, "--compact_eval", "1"], device)
    render_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(crep["psnrs"]) != CLI_SCENE["T"] or not all(math.isfinite(p) for p in crep["psnrs"]):
        raise AssertionError(f"compact render PSNRs {crep['psnrs']}")
    flat = crep["flat_log"]
    # chunks no larger than one bucket quantum (16384 samples) render dense
    if not flat or not all(n < rs for n, _, rs in flat if rs > 16384):
        raise AssertionError(f"the compact render ran no flat bucket: {flat[:4]}")

    params, st, dy, aabb, extra = load_checkpoint(rep["ckpt"])
    pose = pose_to_mtx(torch.from_numpy(np.asarray(params["pose"])))[0].numpy()
    p = params_from_numpy({k: params[k] for k in ("static", "dynamic")}, device)
    aabb_t = torch.as_tensor(aabb, device=device)
    H, W = CLI_SCENE["H"] // 2, CLI_SCENE["W"] // 2
    args = config_parser(argv)
    n_samples = min(args.nSamples, cal_n_samples(st.grid_size, args.step_ratio))
    chunk = make_chunk_renderer(st, dy, "ndc", n_samples, st.step_size(aabb),
                                alpha_mask=load_alpha_npz(MASK_NPZ), compact=True)
    rays = rays_for_view(pose, extra["focal"], H, W, "ndc", device=device)[:8192]
    ts = torch.full((rays.shape[0],), -1.0, device=device)
    packs = chunk.pack(p)
    got = chunk(p, packs, aabb_t, rays, ts)
    want = chunk.dense_superset(p, packs, aabb_t, rays, ts)
    gaps, exact = {}, True
    for name in got._fields:
        if name == "delta_xyz":  # averages the kept samples only, by definition
            continue
        a, b = getattr(got, name), getattr(want, name)
        gaps[name] = float((a - b).abs().max())
        exact = exact and bool(torch.equal(a, b))
        if not torch.allclose(a, b, rtol=ORACLE_RTOL, atol=ORACLE_ATOL):
            raise AssertionError(f"compact chunk {name} differs from its oracle: {gaps[name]}")
    N, total, RS = chunk.flat_log[-1]
    log(f"[render_compact] oracle chunk: N {N} for {total} occupied of {RS} samples; "
        f"bit for bit {exact}; largest gap {max(gaps.values()):.3e}")
    frame_ms = sorted(1e3 * t for t in crep["frame_s"])
    med = frame_ms[len(frame_ms) // 2]
    record = {
        "frames": len(frame_ms), "H": H, "W": W, "n_samples": n_samples, "chunk": 8192,
        "mask": MASK_NPZ.split("/golden/")[-1], "ms_per_frame_median": med,
        "rays_per_s": H * W / (med / 1e3), "frame_ms": [1e3 * t for t in crep["frame_s"]],
        "flat_N": [n for n, _, _ in flat], "occupied_share": [c / rs for _, c, rs in flat],
        "peak_gib": peak / 2**30, "render_only_s": render_s, "psnrs": crep["psnrs"],
        "oracle": {"N": N, "occupied": total, "samples": RS, "bit_exact": exact, "gaps": gaps},
        "card": smi,
    }
    log(f"[render_compact] {med:.1f} ms/frame (median of {len(frame_ms)}), "
        f"{record['rays_per_s']:.0f} rays/s, flat N {min(record['flat_N'])}-"
        f"{max(record['flat_N'])}, occupied share "
        f"{min(record['occupied_share']):.4f}-{max(record['occupied_share']):.4f} per chunk, "
        f"peak {peak / 2**30:.2f} GiB ({smi})")
    return record



def profile_render_chunk(ckpt: str, H: int, W: int, n_samples: int, top: int = 12):
    """One 8192-ray chunk of the CLI checkpoint's render under
    torch.profiler (after a warm call): its wall time, device-busy time and
    launches, and the kernels that take the most device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rodynrf_tpu_torch.core.se3 import pose_to_mtx
    from rodynrf_tpu_torch.render.renderer import make_chunk_renderer, rays_for_view
    from rodynrf_tpu_torch.train.checkpoints import load_checkpoint
    from rodynrf_tpu_torch.train.convert import params_from_numpy

    params, st, dy, aabb, extra = load_checkpoint(ckpt)
    pose = pose_to_mtx(torch.from_numpy(np.asarray(params["pose"])))[0].numpy()
    p = params_from_numpy({k: params[k] for k in ("static", "dynamic")}, "cuda")
    aabb_t = torch.as_tensor(aabb, device="cuda")
    chunk = make_chunk_renderer(st, dy, "ndc", n_samples, st.step_size(aabb))
    rays = rays_for_view(pose, extra["focal"], H, W, "ndc", device="cuda")[:8192]
    ts = torch.zeros(rays.shape[0], device="cuda")
    packs = chunk.pack(p)
    chunk(p, packs, aabb_t, rays, ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        chunk(p, packs, aabb_t, rays, ts)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"[render] one 8192-ray chunk under the profiler: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, {sum(e.count for e in kernels)} device launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"[render]   {dev_us(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_launches": sum(e.count for e in kernels)}


def drive_memory_paths(scene, smi: str, device: str = "cuda"):
    """Phase 10a: the step's memory options at 300³, each its own trainer
    and main path (counts, 2 warm + 5 timed steps, a profiled step): the
    auto rule's 4 micro-batches, the batched passes (pass_chunk and remat
    auto), rematerialization. Returns their records."""
    from rodynrf_tpu_torch.train import Trainer, parse_cmd

    want = {"accum4": dict(grad_accum=4, fused_passes=False, remat=False),
            "fused": dict(grad_accum=1, fused_passes=True),
            "remat": dict(grad_accum=1, fused_passes=False, remat=True)}
    records = []
    for path, config in CONFIG_MEMORY.items():
        tr = Trainer(parse_cmd(" ".join(config)), scene, device=device)
        got = policies(tr.step_fn.S)
        if any(got[k] != v for k, v in want[path].items()):
            raise AssertionError(f"{path}: resolved {got}, want {want[path]}")
        records.append(drive_path(tr, path, smi, None))
        del tr
        torch.cuda.empty_cache()
    return records


def table_bytes(tr) -> dict:
    """Bytes of the fields' plane and line parameters (f32) and of the
    gather tables one step packs from them (layout and dtype of the step)."""
    from rodynrf_tpu_torch.fields import dynamic as dyn
    from rodynrf_tpu_torch.fields import static as stat
    from rodynrf_tpu_torch.train.step import is_spatial, named_leaves

    params = sum(t.numel() * t.element_size() for p, t in named_leaves(
        {"static": tr.params["static"], "dynamic": tr.params["dynamic"]}) if is_spatial(p))

    def packed_bytes(packed):
        if isinstance(packed, dict):
            return sum(packed_bytes(v) for v in packed.values())
        tabs = list(packed.tables) + [t for ts in packed.line_tables for t in ts]
        return sum(t.numel() * t.element_size() for t in tabs)

    S = tr.step_fn.S
    with torch.no_grad():
        packed = (packed_bytes(stat.pack_tables(tr.params["static"], S.static_cfg))
                  + packed_bytes(dyn.pack_tables(tr.params["dynamic"], S.dynamic_cfg)))
    return {"params": params, "packed": packed}


def walk_schedule(scene, smi: str, device: str = "cuda"):
    """Phase 10b-10c: configs/Nvidia_no_poses.txt as it stands (N_voxel_init
    16³, seven upsamples to 640³), every auto policy on. At the first grid
    and after each upsample (the step at upsamp_list[k], whose end grows the
    grid): WALK_STEPS steps, with per size the grid, samples per ray, the
    resolved policies, the table bytes, ms/step and the peak (reset per
    size). At 640³: one step on a single batch of 1024 rays,
    rematerialized (what --grad_accum 1 resolves to) and in store mode,
    each with its peak; one profiled step, a full checkpoint save (seconds,
    bytes), and both kernels held to their plain versions at one
    micro-batch's shapes (10c; the segment sum at the merged layout's, since
    'auto' puts the 640³ dynamic field on the strided one). Returns (the
    walk's record, the 10c kernel cases)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from rodynrf_tpu_torch.train import Trainer, parse_cmd
    from rodynrf_tpu_torch.train.step import make_train_step

    args = parse_cmd(" ".join(CONFIG_WALK))
    tr = Trainer(args, scene, device=device)
    sizes = []
    reset_counters()
    for k in range(len(args.upsamp_list) + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cross_s = None
        if k > 0:  # the step at upsamp_list[k - 1] ends with the upsample
            tr.iteration = args.upsamp_list[k - 1]
            t0 = time.time()
            run_steps(tr, 1, f"walk upsample {k}")
            torch.cuda.synchronize()
            cross_s = time.time() - t0
        cross_peak = torch.cuda.max_memory_allocated()
        S, layouts = tr.step_fn.S, tr.table_layouts()
        per_step = launches_per_step(S, layouts)
        tb = table_bytes(tr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counters()
        t0 = time.time()
        run_steps(tr, WALK_STEPS, f"walk {list(S.static_cfg.grid_size)}")
        step_s = (time.time() - t0) / WALK_STEPS
        after = counters()
        got = {n: after[n] - before[n] for n in KERNELS}
        if got != {n: WALK_STEPS * v for n, v in per_step.items()}:
            raise AssertionError(f"walk at {list(S.static_cfg.grid_size)}: launches {got} != "
                                 f"{WALK_STEPS} x {per_step}")
        size = {"grid": list(S.static_cfg.grid_size), "n_samples": S.n_samples, **policies(S),
                "layouts": layouts, "table_bytes": tb, "ms_per_step": step_s * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "crossing_step_s": cross_s, "crossing_peak_gib": cross_peak / 2**30,
                "launches_per_step": per_step}
        log(f"[walk] grid {size['grid']}, {S.n_samples} samples/ray, {policies(S)}, layouts "
            f"{layouts}, tables {tb['params'] / 2**30:.3f} GiB of parameters, "
            f"{tb['packed'] / 2**30:.3f} GiB packed; {size['ms_per_step']:.1f} ms/step, peak "
            f"{size['peak_gib']:.2f} GiB (the upsample step's {size['crossing_peak_gib']:.2f}) "
            f"({smi})")
        log(json.dumps({"walk_size": size}))
        sizes.append(size)
    if tuple(tr.step_fn.S.static_cfg.grid_size) != WALK_FINAL_GRID:
        raise AssertionError(f"the walk ended at {tr.step_fn.S.static_cfg.grid_size}, not "
                             f"{WALK_FINAL_GRID}")

    # 640³ on a single batch (--grad_accum 1): rematerialized, as the auto
    # rule resolves it for one batch, then in store mode
    S_walk, layouts = tr.step_fn.S, tr.table_layouts()
    one_batch = []
    for remat in (True, False):
        S1 = dataclasses.replace(S_walk, grad_accum=1, remat=remat)
        tr.step_fn = make_train_step(S1, tr.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counters()
        t0 = time.time()
        run_steps(tr, 1, f"640 one batch remat {remat}")
        step_s = time.time() - t0
        after = counters()
        got = {n: after[n] - before[n] for n in KERNELS}
        if got != launches_per_step(S1, layouts):
            raise AssertionError(f"640³ one batch: launches {got} != "
                                 f"{launches_per_step(S1, layouts)}")
        rec = {**policies(S1), "step_s": step_s,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"[walk] 640³ on one batch of {tr.args.batch_size} rays, remat {remat}: one step "
            f"{step_s:.2f} s, peak {rec['peak_gib']:.2f} GiB ({smi})")
        one_batch.append(rec)
    tr.step_fn = make_train_step(S_walk, tr.device)
    launches = counters()

    # 640³: a profiled step, then a full checkpoint save
    prof = profile_step(tr)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_walk_"))
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        tr.save_full(str(root / "walk_640.npz"))
        save_s = time.time() - t0
        save_bytes = os.path.getsize(root / "walk_640.npz")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[walk] 640³: profiled step device busy {prof['device_busy_ms']:.1f} ms, "
        f"{prof['device_launches']} launches; full checkpoint save {save_s:.2f} s, "
        f"{save_bytes / 2**20:.1f} MiB ({smi})")

    # 10c: the kernels at one micro-batch's shapes at 640³
    S = tr.step_fn.S
    points = sample_points(tr, tr.args.batch_size // S.grad_accum)
    merged = dataclasses.replace(S.dynamic_cfg, vm_layout="merged")
    cases = check_kernels_at(tr, points, "640", merged_cfg=merged)
    record = {"path": "walk_640", **policies(S), "sizes": sizes, "launches": launches,
              "one_batch_640": one_batch,
              "profile_640": prof, "save_full_s": save_s, "save_full_bytes": save_bytes,
              "card": smi}
    log(json.dumps({"main_path": {k: v for k, v in record.items() if k != "sizes"}}))
    del tr
    torch.cuda.empty_cache()
    return record, cases


def golden_gates(smi: str, device: str = "cuda"):
    """Phase 8: the reference's first-step gradients and its .th renders,
    on the card."""
    import numpy as np

    from rodynrf_tpu_torch.cli import _load_reference_th_pair
    from rodynrf_tpu_torch.data.imageio import read_png
    from rodynrf_tpu_torch.eval.metrics import psnr
    from rodynrf_tpu_torch.render.renderer import make_chunk_renderer, render_image
    from rodynrf_tpu_torch.testing import golden_trainer
    from rodynrf_tpu_torch.train.checkpoints import dynamic_state_dict, static_state_dict
    from rodynrf_tpu_torch.train.convert import params_from_numpy

    repo = Path(__file__).resolve().parent
    out = repo / "golden" / "out"
    tr, scene = golden_trainer(str(repo), device=device)
    rec = np.load(out / "ref_record.npz")
    sc = {"iteration": 0, "focal_fixed": tr.focal_fixed, **tr.schedule.scalars(0)}
    grads, _ = tr.step_fn.grads_and_metrics(
        tr.params, tr.aabb, tr.data, torch.as_tensor(rec["ray_idx"][0]).to(device),
        torch.as_tensor(rec["ray_idx_rand"][0]).to(device), tr.gen, sc)
    ours = {f"static/{k}": v for k, v in static_state_dict(grads["static"], tr.static_cfg).items()}
    ours.update({f"dynamic/{k}": v
                 for k, v in dynamic_state_dict(grads["dynamic"], tr.dynamic_cfg).items()})
    ours["pose"] = grads["pose"].cpu().numpy()
    ours["fov"] = grads["fov"].cpu().numpy()
    ref = np.load(out / "grads_ref.npz")
    rel = {n: float(np.abs(ref[n] - ours[n]).max() / (np.abs(ref[n]).max() + 1e-12))
           for n in ref.files}
    worst = max(rel, key=rel.get)
    log(f"[golden] first-step gradients on the card: {len(rel)} tensors, worst relative "
        f"error {rel[worst]:.3e} ({worst}), limit {GOLDEN_GRAD_RTOL:g}")
    if len(rel) != 72 or rel[worst] > GOLDEN_GRAD_RTOL:
        raise AssertionError(f"golden gradients: {len(rel)} tensors, worst {worst} "
                             f"{rel[worst]:.3e}")

    exp = out / "ref_log" / "golden_tiny"
    params, st_cfg, dy_cfg, aabb, poses, focal, _ = _load_reference_th_pair(
        str(exp / "golden_tiny.th"))
    render_chunk = make_chunk_renderer(st_cfg, dy_cfg, "ndc", st_cfg.n_samples(aabb),
                                       st_cfg.step_size(aabb))
    params = params_from_numpy(params, device)
    aabb_t = torch.as_tensor(aabb, device=device)
    W, H = scene.img_wh
    ts = np.linspace(-1.0, 1.0, scene.n_frames)
    psnrs = []
    for i in range(scene.n_frames):
        maps = render_image(render_chunk, params, aabb_t, poses[i], focal, float(ts[i]), H, W,
                            "ndc", chunk=1024)
        ref_png = read_png(str(exp / "imgs_test_all" / f"{i:03d}.png")).astype(np.float32) / 255.0
        psnrs.append(float(psnr(maps["rgb"], ref_png)))
    log(f"[golden] the reference's final .th rendered by the port on the card against its own "
        f"PNGs: {[round(p, 3) for p in psnrs]} dB (limit {GOLDEN_MIN_PSNR:g}) ({smi})")
    if min(psnrs) < GOLDEN_MIN_PSNR:
        raise AssertionError(f"golden .th render: {psnrs} dB")
    return {"grad_worst_rel": rel[worst], "grad_worst": worst, "th_render_psnr": psnrs}


def main() -> int:
    t_start = time.time()
    kernels_only = "--kernels-only" in sys.argv[1:]
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
        for fn, info in ptxas_summary(rep):
            log(f"[build] {name}: {fn}: {info}")

    scene = make_synthetic_scene(**SCENE, ray_type=parse_cmd(" ".join(RECIPE)).ray_type)
    # the two paths' trainers (the kernel checks draw their inputs from them)
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
    f32_ms = sum(c["ms_f32"] * evals[c["case"].split()[0]] for c in coalesce)
    default_cases = [c for c in coalesce if c["case"].startswith("static")] + segsum

    def per_default_step(get):
        return sum(get(c) * evals[c["case"].split()[0]] for c in default_cases)

    default_ms = per_default_step(lambda c: c["ms"])
    log(f"[kernel] table-gradient kernels per train step (evals x shapes above): f32 strided "
        f"{f32_ms:.2f} ms (coalesce, f32 out); default {default_ms:.2f} ms (static coalesce, "
        f"bf16 out, + dynamic factored segment sum); the default step's table-gradient "
        f"sections, device time: {per_default_step(lambda c: c['section']['old'][1]):.2f} ms "
        f"by the earlier composition -> {per_default_step(lambda c: c['section']['new'][1]):.2f}"
        f" ms ({smi})")

    if kernels_only:  # phases 1-3 alone, for measuring the kernels
        log(json.dumps({"kernel_cases": {"coalesce": coalesce, "segsum": segsum}}))
        return 0

    # 4, 4b, 4c. the main paths
    records = [drive_path(trainers["f32_strided"], "f32_strided", smi, f32_ms)]
    del trainers["f32_strided"]
    torch.cuda.empty_cache()
    records.append(drive_path(trainers["default"], "default", smi, default_ms))
    records.append(cross_upsample(trainers["default"], smi))
    del trainers
    torch.cuda.empty_cache()

    # 10a. the memory options at 300³, in the same call as the default path
    records.extend(drive_memory_paths(scene, smi))

    # 5. small-input reference
    tiny_worst = small_input_reference()
    log(json.dumps({"tiny_worst_rel": tiny_worst}))

    # 7. the CLI at full width (same recipe and grid as the default path)
    default = records[1]
    records.append(drive_cli(smi, default["launches_per_step"], default["grid"],
                             default["n_samples"]))
    torch.cuda.empty_cache()

    # 8. the golden gates on the card
    log(json.dumps({"golden": golden_gates(smi)}))

    # 9. compaction at full width (9d ran inside phase 7)
    compact_records, compact_info = drive_compaction(scene, smi)
    records.extend(compact_records)

    # 10b-10c. the recipe's upsample schedule to 640³, the kernels there
    walk, cases_640 = walk_schedule(scene, smi)
    records.append(walk)

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
            "library_ms": main_case["library_ms"], "device_ms": main_case["device_ms"],
            "split": main_case["split"], "section": main_case["section"],
            "case": main_case["case"], "cases": cases,
            "compact_cases": [c for c in compact_info["compact_cases"]
                              if c["case"].startswith("dynamic merged") == (kernel == "segsum")],
            "cases_640": [c for c in cases_640
                          if c["case"].startswith("dynamic merged") == (kernel == "segsum")],
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
