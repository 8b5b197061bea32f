#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rodynrf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):
  1. the card: name and power limit from nvidia-smi, torch's device name;
  2. build every CUDA kernel from csrc/ (the train step's and the JPEG
     decoder's; one nvcc per source, started together), with the build time;
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
         and one in store mode, each with its peak; a profiled step (no
         checkpoint save at 640³: the CPU tests hold save_full and its exact
         resume, phase 7 saves and resumes at 300³);
     10c. both kernels held to their plain versions at one 640³
         micro-batch's shapes (the segment sum at the merged layout's:
         'auto' puts the 640³ dynamic field on the strided one);
     10d. (inside phase 5) the TINY accumulated, batched and
         rematerialized steps on the card against the CPU;
  11. (after 7) preprocessing on the card: phase 7's scene written again
     from its seed, its synthetic flow, disparity and masks removed;
     11a. `python -m rodynrf_tpu_torch.preprocess flow` with a RAFT
         checkpoint of seeded random weights in the official layout (the
         >=2-D weights halved), at a 768 long side (432x768), 20
         refinements: ms per pair (median, first pair excluded), peak GiB,
         every flow finite;
     11b. `... depth` with a DPT-Large checkpoint of random weights at
         lower_bound_size(540, 960) = 384x704: ms per frame (median, first
         excluded), peak GiB, parameter bytes;
     11c. `... mask` from 11a's flows, LMedS on the card: seconds per
         frame, the masks' mean share, how many of the maps LMedS accepted
         an F on (at least one, or the phase fails; no semantic half: no
         Mask-RCNN weights);
     11d. load_scene reads 11a-c's files and the phase-7 recipe (300³,
         one batch in store mode) takes 3 steps on them: every loss finite,
         kernel launches equal to launches per step x steps;
     11e. RAFT (128x128, 4 refinements) and the narrow DPT of
         tests/test_preprocess.py:93 (96x128) on the card against the CPU
         (max EPE <= 1e-3 px, max relative error <= 1e-4), and the LMedS
         mask of one flow on both from one generator seed (>= 99% of
         pixels agree); then at the scene's full size (540x960) the flow of
         a synthetic two-view scene with an independently moving patch on
         the card alone (the CPU's fit at this size is not repeated): F
         accepted, the mask covers the patch (>= 90% of it, <= 10% of the
         static pixels); one `preprocess` JSON line;
  12. (inside phase 7, after its --render_only) mesh export and LPIPS:
     12a. `cli.main([... "--export_mesh", "1", "--ckpt", <phase 7's .npz>])`
         at the full 331×368×220 grid: seconds of dense_alpha,
         marching_tetrahedra and write_ply, V, F, PLY bytes, peak GiB, the
         alpha volume's max and share above the 0.005 level (random weights
         may give no surface);
     12b. the reference's trained basin field (golden/out_basin/.../
         golden_basin.th) exported at its own grid and grown to 331×368×220
         (`upsample_dynamic_field`): the same readings, F > 0 for both; card
         against CPU: dense_alpha at the basin grid within 1e-5,
         marching_tetrahedra bit for bit on the card's basin volume and on
         a 96³ crop of the grown one;
     12c. LPIPS (alex, vgg) with seeded random weights in the `lpips`
         layout ($LPIPS_WEIGHTS_DIR set for this phase only): ms per
         270×480 frame over the 12 rendered frames against their ground
         truth (median, first excluded), a frame to itself 0, card against
         CPU on a 96×128 crop within 1e-4 relative; then a --render_only
         evaluation (committed mask, --compact_eval 1) whose mean.txt must
         carry finite lpips_alex and lpips_vgg. Neither kernel runs; one
         `mesh_lpips` JSON line;
  13. (after 10b) the distributed step (parallel/, train/step.py's mesh
     path) on the card, last, in a NCCL process group this script starts:
     13a. world size 1, the default path at 300³ (one batch of 1024, store
         mode): a trainer on the 1-rank data mesh and two non-distributed
         ones from the same seed take 3 steps in turns on the same batches
         and draws under torch's deterministic algorithms; every loss and
         gradient leaf of the distributed step within 1e-6 of the first
         non-distributed one's, or within twice the second's difference from
         it where that is larger (the line says how many leaves are equal bit
         for bit); then 3 timed steps of the distributed and the first
         trainer as the card runs by default: ms/step of both; the
         distributed steps' table-gradient launches (the counts set to 0
         before each of its steps), one flattened gradient all-reduce's time;
         a `main_path` line with path `dp1`;
     13b. the same with --shard_grids 1 (at world size 1 each shard is the
         whole grid, but the gather, the reduce-scatter and Adam on the
         shard run): 3 deterministic steps against 13a's, 3 timed, its
         peak; path `dp1_shard_grids`;
     13c. with more than one card: cli.main at 300³ on phase 7's on-disk
         scene, 3 steps on one card (twice) and on every card (--n_devices
         0, one spawned NCCL worker per card), on two paths. float32
         strided (every rank's gradient reaches the average unrounded):
         every step's loss within 1e-5 of one card's, or within 4 times one
         card's own difference at that step where that is larger. The
         default path (bf16 merged dynamic tables, which each rank rounds to
         bf16 before the average): the first step's loss (the same
         parameters and batch) within 1e-5, every step's difference printed
         beside float32's; steady ms/step, rays/s, rank 0's peak; then one
         640³ step with --shard_grids 1 at the recipe's auto grad_accum. On
         one card a line says it was not run and why;
  14. (before 13) configs/DAVIS.txt from JPEG frames: a DAVIS-layout scene
     of 8 frames at 1920×1080 written as baseline 4:2:0 JPEG (quality 90,
     `testing.write_jpeg`, from the synthetic scene's frames), and one of 8
     frames at 854×480 (DAVIS's 480p) as progressive 4:2:0 JPEG
     (`write_jpeg(progressive=True)`: libjpeg's standard 10-scan script);
     14a. the JPEG kernels (csrc/jpeg_entropy.cu, csrc/jpeg_progressive.cu,
         csrc/jpeg_idct.cu) against their plain versions on the CPU, bit for
         bit (blocks, status words, planes, pixels): the committed baseline
         fixtures (tests/data/jpeg) as one batch, one frame, the same frame
         re-encoded with a restart marker every 8 MCUs, every fixture
         (baseline and progressive) as one batch, the progressive scene's
         frames as one batch; each kernel's ms (CUDA events, each through
         its wrapper; the progressive decode's split by round from the
         profiler's kernel events), the plain versions' CPU ms, each
         kernel's byte bound; then each scene's 8 frames as one batch
         (`decode_jpegs` end to end, and each kernel);
     14b. `preprocess flow | depth --out_dir dpt | mask`, each with --zfill 5,
         from phase 11's kind of random checkpoints: flow and depth read the
         frames as one batch through the kernels (one launch of each);
     14c. `cli.main` of the recipe at its 16³ start on 14b's products with
         --downsample_train 2 (960×540 rays; every frame decoded by the
         kernels, resized by pil_resize): 3 steps, the evaluation of the 8
         frames, the checkpoint; then one more scene load and a trainer's 2 warm + 3
         timed steps on it at 16³ and at 256³ (--N_voxel_init 16777216,
         --render_test 0): finite losses, launch
         counts equal to launches per step × steps for the layouts auto
         chose, `main_path` lines `davis_cli`, `davis_16`, `davis_256`;
     14d. the progressive scene through `load_scene` on the card (one
         batch: no baseline launch, one progressive launch per round, one
         IDCT and one colour pass) equal bit for bit to `load_scene` on the
         CPU, then `cli.main` for 1 step (--render_test 0; the CLI's final
         evaluation of the training frames runs, as the reference's does):
         a finite loss and PSNRs, launch counts as above, `main_path` line
         `davis_progressive`; then --render_only from its checkpoint, which
         must give the final evaluation's PSNRs; one `davis` JSON line;
  15. (after 14) tools/quality_run's recipe (ndc, pose and focal, 32³ ->
     128³) on its 8×96×128 scene for 150 iterations, the JAX script's
     fractions of the budget: upsamples at 25, 50, 75 and 100, the focal
     activation at 100, the pose freeze after 75, each checked at its
     iteration; both table-gradient kernels launched (counts set to 0
     before); the evaluation of the 8 frames (PSNR above the first logged
     train PSNR, every metric finite); tools/export_alpha of the checkpoint
     on the card (occupancy) and at 32³ on the card and on the CPU (the
     masks equal except where the pooled alpha lies within 1e-5 of the
     threshold); one `quality` JSON line and a `main_path` line, path
     `quality`;
  6. (printed last) a `main_path` JSON line per path, one JSON line of
     kernels, the nvidia-smi line, and the result line.

`python3 chip_smoke.py --kernels-only` runs phases 1-3 alone and prints the
cases as one `kernel_cases` JSON line; `python3 chip_smoke.py
--parallel-only` runs phases 1, 2 and 13; `--davis-only` phases 1, 2 and 14;
`--quality-only` phases 1, 2 and 15.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
# the CLI phases count kernel launches in this process: one process, whatever
# the card count (phase 13c trains on every card)
ONE_PROCESS = ["--n_devices", "1"]
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
# phase 11: preprocessing at the reference's sizes (RAFT at a 768 long side
# with 20 refinements, DPT-Large at the lower-bound size), with the names the
# Nvidia loader reads (flow/%03d_*.npz, disp/%03d.npy)
PRE_LONG_SIDE, PRE_ITERS, PRE_ZFILL = 768, 20, 3
PRE_DPT = {}  # DPTConfig arguments: DPT-Large
NARROW_DPT = dict(dim=64, heads=4, blocks=4, hooks=(0, 1, 2, 3), reassemble=(16, 32, 64, 64),
                  features=32)  # tests/test_preprocess.py:93
RAFT_EPE_LIMIT, DPT_REL_LIMIT, LMEDS_AGREE_MIN = 1e-3, 1e-4, 0.99  # 11e, card vs CPU
PATCH_HIT_MIN, STATIC_HIT_MAX = 0.9, 0.1  # 11e at full size: mask share on / off the patch
# phase 12: the reference's trained basin field (2,000 iterations of
# golden/basin.txt), the crop held card vs CPU, and the card-vs-CPU limits
BASIN_TH = str(Path(__file__).resolve().parent / "golden" / "out_basin" / "ref_log"
               / "golden_basin" / "golden_basin.th")
MESH_CROP = 96
MESH_PROFILE_SLAB = 16  # x-planes of the grown field under the profiler: 16·368·220 = 20 chunks
MESH_ALPHA_ATOL = 1e-5  # alpha in [0, 1]; f32 field products in another order
LPIPS_REL_LIMIT, LPIPS_CPU_HW, LPIPS_SELF_MAX = 1e-4, (96, 128), 1e-9
# phase 13: the distributed step at the default path's 300³ point
DP_STEPS = 3
# of max|non-distributed gradient| per leaf, and of each loss; where the
# card's own run-to-run difference (a second non-distributed trainer from
# the same seed) is larger, twice that
DP_GRAD_RTOL = 1e-6
DP_ALLREDUCE_REPS = 20
# 13c: every card's loss against one card's at each step: the bound of
# tests/test_torch_parallel_cli.py (two gloo ranks against one process, float32
# sums in another order), or MULTI_OWN_FACTOR times one card's own difference
# from a second one-card run where that is larger. Held at every step on the
# float32 strided path; on the default path at the first step (the same
# parameters and batch), since each rank rounds its bf16 merged-table gradient
# before the average (the contract tests/test_torch_parallel.py holds the
# step to) and Adam's first updates follow the gradients' signs
MULTI_LOSS_RTOL, MULTI_OWN_FACTOR = 1e-5, 4.0
CONFIG_MULTI = {"f32_strided": ["--bf16", "0", "--vm_layout", "strided"], "default": []}
# phase 14: configs/DAVIS.txt (contract rays, fea_pe 6, time-embedded static
# shading, its 16³ -> 256³ grid) on a DAVIS-layout scene of baseline JPEG
# frames at DAVIS's 1080p, preprocessed on the card; the JPEG kernels
DAVIS_RECIPE = ["--config", str(Path(__file__).resolve().parent / "configs" / "DAVIS.txt")]
DAVIS_SCENE = dict(T=8, H=1080, W=1920)
DAVIS_QUALITY, DAVIS_RESTART = 90, 8  # write_jpeg's quality; MCUs per restart interval
DAVIS_CLI_STEPS, DAVIS_WARM, DAVIS_TIMED = 3, 2, 3
DAVIS_VOXELS_256 = "16777216"  # 256³, the recipe's N_voxel_final
JPEG_SOURCES = ("jpeg_entropy", "jpeg_progressive", "jpeg_idct")
JPEG_KERNELS = ("jpeg_entropy", "jpeg_progressive", "jpeg_idct", "jpeg_color")
# 14a/14d: a DAVIS-layout scene of progressive frames at DAVIS's 480p
# (testing.write_jpeg's libjpeg standard script), as the loader's one batch
DAVIS_PROGRESSIVE = dict(T=8, H=480, W=854)
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
# phase 15: tools/quality_run's recipe (ndc, pose + focal) on its 8×96×128
# scene for QUALITY_ITERS iterations: the JAX script's upsample fractions of
# the budget (1/6, 1/3, 1/2, 2/3) put the upsamples at 25, 50, 75 and 100,
# the focal activation at 100 and the pose freeze after 75
QUALITY_ITERS = 150
QUALITY_EVENTS = {"upsample": [25, 50, 75, 100], "focal_on": 100, "pose_freeze": 76}
QUALITY_EXPORT_DIM = 32  # export_alpha's max_dim for the card-vs-CPU comparison
QUALITY_MASK_ATOL = 1e-5  # masks may differ only where alpha lies this near the threshold


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
                *ONE_BATCH, *ONE_PROCESS]
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
        drive_mesh_lpips(argv, rep["ckpt"], root / "log", grid, smi, device)
        chunk_profile = (profile_render_chunk(rep["ckpt"], CLI_SCENE["H"] // 2,
                                              CLI_SCENE["W"] // 2, n_samples)
                         if device == "cuda" else {})
        render_compact = drive_compact_render(argv, rep, smi, device)

        args = config_parser(argv + ["--ckpt", rep["ckpt"], "--n_iters", str(CLI_STEPS + 1)])
        t0 = time.time()
        tr = Trainer(args, load_scene(args, device), device=device)
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


def write_lpips_dump(path: Path, net: str, seed: int) -> None:
    """Seeded random LPIPS weights in the `lpips` package's state-dict
    layout: convolutions U(±1/√fan_in), the lin heads U(0, 0.1) (trained
    heads are non-negative), the scaling layer's constants."""
    from rodynrf_tpu_torch.eval.lpips import LPIPS

    g = torch.Generator().manual_seed(seed)
    sd = LPIPS(net).state_dict()
    for k, v in sd.items():
        if k.startswith("lin"):
            v.uniform_(0.0, 0.1, generator=g)
        elif k.startswith("net."):
            w = sd[k.replace(".bias", ".weight")]
            bound = 1.0 / math.sqrt(w[0].numel())
            v.uniform_(-bound, bound, generator=g)
    torch.save(sd, path)


def profile_call(label: str, fn, top: int = 6) -> dict:
    """One call of fn under torch.profiler (after a warm call): its wall
    time, device-busy time, device launches, the idle share, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"[{label}] under the profiler: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"{launches} device launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"[{label}]   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_launches": launches,
            "idle_share": 1 - busy_ms / wall_ms}


def drive_mesh_lpips(argv, ckpt: str, logdir: Path, grid, smi: str, device: str = "cuda"):
    """Phase 12 on phase 7's checkpoint and frames: 12a the CLI's mesh
    export at full width; 12b the reference's trained basin field exported
    at its own grid and grown to `grid`, card against CPU; 12c LPIPS of the
    rendered frames with seeded random weights, then a --render_only
    evaluation whose mean.txt must carry finite LPIPS columns. Neither
    table-gradient kernel runs. Prints and returns the `mesh_lpips`
    record."""
    import os
    import tempfile

    from rodynrf_tpu_torch.cli import _load_reference_th_pair
    from rodynrf_tpu_torch.cli import main as cli_main
    from rodynrf_tpu_torch.data.imageio import read_png
    from rodynrf_tpu_torch.data.video_dataset import load_scene
    from rodynrf_tpu_torch.eval import mesh
    from rodynrf_tpu_torch.eval.metrics import rgb_lpips
    from rodynrf_tpu_torch.fields.dynamic import upsample_dynamic_field
    from rodynrf_tpu_torch.train import config_parser
    from rodynrf_tpu_torch.train.checkpoints import save_checkpoint
    from rodynrf_tpu_torch.train.convert import params_from_numpy, params_to_numpy

    t_phase = time.time()
    launches_before = counters()
    record = {"card": smi}

    def with_peak(fn, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return {**fn(*a, **k), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    # 12a. --export_mesh 1 of phase 7's checkpoint (random weights)
    record["full_width"] = with_peak(
        lambda: cli_main(argv + ["--export_mesh", "1", "--ckpt", ckpt], device)["mesh"])
    log(f"[mesh] 12a full width {record['full_width']} ({smi})")

    # 12b. the reference's trained basin field, at its grid and grown to `grid`
    params, st_cfg, dy_cfg, aabb, _, focal, _ = _load_reference_th_pair(BASIN_TH)
    rest = {"pose": np.zeros((1, 9), np.float32), "fov": np.zeros((1, 1), np.float32)}
    basin = str(logdir / "basin.npz")
    save_checkpoint(basin, {**params, **rest}, st_cfg, dy_cfg, aabb, extra={"focal": focal})
    with torch.no_grad():
        grown_dy = params_to_numpy(
            upsample_dynamic_field(params_from_numpy(params["dynamic"], "cpu"), grid))
    grown_cfg = dy_cfg.with_grid(grid)
    grown = str(logdir / "basin_grown.npz")
    save_checkpoint(grown, {**params, "dynamic": grown_dy, **rest}, st_cfg, grown_cfg, aabb,
                    extra={"focal": focal})
    for name, path in (("basin", basin), ("basin_grown", grown)):
        record[name] = with_peak(mesh.export_mesh_from_ckpt, path, path[:-4] + ".ply",
                                 device=device)
        log(f"[mesh] 12b {name} {record[name]} ({smi})")
        if record[name]["faces"] == 0:
            raise AssertionError(f"the trained {name} field gave an empty surface")

    # card against CPU: dense_alpha at the basin grid; marching_tetrahedra on
    # the card's basin volume and on a crop of the grown one
    a_card = mesh.dense_alpha(params_from_numpy(params["dynamic"], device), dy_cfg, aabb)
    a_cpu = mesh.dense_alpha(params_from_numpy(params["dynamic"], "cpu"), dy_cfg, aabb)
    alpha_err = float((a_card.cpu() - a_cpu).abs().max())
    grown_t = params_from_numpy(grown_dy, device)
    a_grown = mesh.dense_alpha(grown_t, grown_cfg, aabb)
    if device == "cuda":  # a slab of 20 chunks of 65,536 points
        slab = (MESH_PROFILE_SLAB, *grid[1:])
        record["dense_alpha_profile"] = profile_call(
            "mesh", lambda: mesh.dense_alpha(grown_t, grown_cfg, aabb, grid_size=slab))
        record["dense_alpha_profile"]["points"] = int(np.prod(slab))
    # the crop around the densest voxel, where the surface is
    peak_at = np.unravel_index(int(a_grown.argmax()), tuple(grid))
    c = [min(max(0, int(p) - MESH_CROP // 2), max(0, g - MESH_CROP)) for p, g in zip(peak_at, grid)]
    crop = a_grown[c[0]:c[0] + MESH_CROP, c[1]:c[1] + MESH_CROP, c[2]:c[2] + MESH_CROP].clone()
    del a_grown
    equal, sizes = {}, {}
    for name, vol in (("basin", a_card), ("grown_crop", crop)):
        v_card, f_card = mesh.marching_tetrahedra(vol, mesh.LEVEL)
        v_cpu, f_cpu = mesh.marching_tetrahedra(vol.cpu(), mesh.LEVEL)
        equal[name] = bool(torch.equal(v_card.cpu(), v_cpu) and torch.equal(f_card.cpu(), f_cpu))
        sizes[name] = {"shape": list(vol.shape), "vertices": len(v_cpu), "faces": len(f_cpu)}
    sizes["grown_crop"]["origin"] = c
    record["card_vs_cpu"] = {"dense_alpha_max_abs": alpha_err, "limit": MESH_ALPHA_ATOL,
                             "marching_equal": equal, "marching_sizes": sizes}
    log(f"[mesh] 12b card vs CPU: {record['card_vs_cpu']}")
    if alpha_err > MESH_ALPHA_ATOL or not all(equal.values()):
        raise AssertionError(f"mesh card vs CPU: {record['card_vs_cpu']}")
    if sizes["grown_crop"]["faces"] == 0:
        raise AssertionError("the grown basin's crop holds no surface")

    # 12c. LPIPS with seeded random weights, for this phase only
    wdir = Path(tempfile.mkdtemp(prefix="lpips_", dir=logdir))
    for seed, net in enumerate(("alex", "vgg")):
        write_lpips_dump(wdir / f"lpips_{net}.pth", net, seed)
    scene = load_scene(config_parser(argv), device)
    frames = [read_png(str(logdir / "cli" / "imgs_test_all" / f"{i:03d}.png")).astype(np.float32)
              / 255.0 for i in range(len(scene.rgbs_stack))]
    saved = os.environ.get("LPIPS_WEIGHTS_DIR")
    os.environ["LPIPS_WEIGHTS_DIR"] = str(wdir)
    try:
        lp = {}
        for net in ("alex", "vgg"):
            ms, vals = [], []
            for gt, im in zip(scene.rgbs_stack, frames):
                t0 = time.perf_counter()
                vals.append(rgb_lpips(gt, im, net, device=device))  # float(): synchronised
                ms.append(1e3 * (time.perf_counter() - t0))
            gt, im = scene.rgbs_stack[0], frames[0]
            h, w = min(LPIPS_CPU_HW[0], gt.shape[0]), min(LPIPS_CPU_HW[1], gt.shape[1])
            card, cpu = (rgb_lpips(gt[:h, :w], im[:h, :w], net, device=d) for d in (device, "cpu"))
            prof = (profile_call("lpips", lambda: rgb_lpips(gt, im, net, device=device))
                    if device == "cuda" else {})
            lp[net] = {"ms_per_frame_median": float(np.median(ms[1:])), "first_ms": ms[0],
                       "values": vals, "self_distance": rgb_lpips(gt, gt, net, device=device),
                       "crop_card": card, "crop_cpu": cpu, "profile": prof,
                       "card_vs_cpu_rel": abs(card - cpu) / abs(cpu), "cpu_crop": [h, w]}
            if (not all(math.isfinite(v) for v in vals)
                    or abs(lp[net]["self_distance"]) > LPIPS_SELF_MAX):
                raise AssertionError(f"LPIPS {net}: {lp[net]}")
            if lp[net]["card_vs_cpu_rel"] > LPIPS_REL_LIMIT:
                raise AssertionError(f"LPIPS {net} card vs CPU: {lp[net]['card_vs_cpu_rel']}")
        t0 = time.time()
        cli_main(argv + ["--render_only", "1", "--ckpt", ckpt, "--alpha_mask", MASK_NPZ,
                         "--compact_eval", "1"], device)
        mean = np.loadtxt(logdir / "cli" / "imgs_test_all" / "mean.txt")
        lp["render_only_s"] = time.time() - t0
    finally:
        if saved is None:
            del os.environ["LPIPS_WEIGHTS_DIR"]
        else:
            os.environ["LPIPS_WEIGHTS_DIR"] = saved
    lp["mean_txt"] = {"psnr": mean[0], "ssim": mean[1], "lpips_alex": mean[2],
                      "lpips_vgg": mean[3]}
    lp["limit_rel"] = LPIPS_REL_LIMIT
    if len(mean) != 4 or not np.isfinite(mean).all():
        raise AssertionError(f"mean.txt {mean}")
    record["lpips"] = lp
    record["phase_s"] = time.time() - t_phase
    log(f"[lpips] alex {lp['alex']['ms_per_frame_median']:.2f} ms/frame, vgg "
        f"{lp['vgg']['ms_per_frame_median']:.2f} ms/frame at {frames[0].shape[0]}x"
        f"{frames[0].shape[1]}; mean.txt {lp['mean_txt']} ({smi})")
    if counters() != launches_before:
        raise AssertionError(f"phase 12 launched a table-gradient kernel: {counters()}")
    log(json.dumps({"mesh_lpips": record}))
    return record


def write_raft_checkpoint(path: Path, seed: int = 7) -> Path:
    """A RAFT checkpoint with seeded random weights in the official layout
    (DataParallel `module.` keys), the ≥2-D weights halved so that 20
    refinements of random weights stay finite (tests/test_weight_conversion.py
    does the same)."""
    from rodynrf_tpu_torch.preprocess.raft import RAFT

    torch.manual_seed(seed)
    model = RAFT()
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim > 1:
                p.mul_(0.5)
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, path)
    return path


def random_dpt(cfg, seed: int, device: str = "cpu"):
    """A DPTDepthModel of seeded random weights with zero biases (the JAX
    package's init_dpt_params rule: with torch's default random biases the
    final ReLU gives an all-zero depth map)."""
    from rodynrf_tpu_torch.preprocess.dpt import DPTDepthModel

    torch.manual_seed(seed)
    with torch.device(device):
        model = DPTDepthModel(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.pretrained.model.pos_embed.normal_(0.0, 0.02)
        model.pretrained.model.cls_token.normal_(0.0, 0.02)
    return model


def write_dpt_checkpoint(path: Path, cfg, device: str, seed: int = 11) -> int:
    """A DPT checkpoint of random_dpt's weights in the official layout (the
    ViT's ImageNet classifier included); returns the model's parameter
    bytes."""
    model = random_dpt(cfg, seed, device)
    with torch.device(device):
        sd = dict(model.state_dict())
        sd["pretrained.model.head.weight"] = torch.zeros(1000, cfg.dim)
        sd["pretrained.model.head.bias"] = torch.zeros(1000)
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    return sum(p.numel() * p.element_size() for p in model.parameters())


def drive_preprocess(smi: str, per_step: dict, device: str = "cuda"):
    """Phase 11 on phase 7's on-disk scene (written again from its seed):
    its synthetic flow, disparity and masks removed, 11a RAFT flow, 11b DPT disparity, 11c motion masks (each
    through `python -m rodynrf_tpu_torch.preprocess`'s main, from random
    checkpoints in the official layouts), 11d three steps of the phase-7
    recipe on what they wrote (launch counts checked), 11e the networks and
    the LMedS on the card against the CPU. Returns the 11d main-path record
    and the `preprocess` line's readings. (`device` and the module's PRE_*
    sizes let the phase be rehearsed on the CPU at a small size.)"""
    import shutil
    import tempfile

    from rodynrf_tpu_torch.testing import write_video_scene

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_preprocess_"))
    try:
        write_video_scene(str(root / "scene"), **CLI_SCENE)
        for sub in ("flow", "disp", "motion_masks"):
            shutil.rmtree(root / "scene" / sub)
        return _preprocess_and_train(root / "scene", smi, per_step, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _preprocess_and_train(scene: Path, smi: str, per_step: dict, device: str):
    from rodynrf_tpu_torch.data.video_dataset import load_scene
    from rodynrf_tpu_torch.preprocess import generate_depth
    from rodynrf_tpu_torch.preprocess import main as preprocess
    from rodynrf_tpu_torch.preprocess.dpt import DPTConfig
    from rodynrf_tpu_torch.train import Trainer, config_parser

    ckpt = scene.parent / "preprocess_ckpt"
    ckpt.mkdir()
    raft_path = write_raft_checkpoint(ckpt / "raft-random.pth")
    dpt_cfg = DPTConfig(**PRE_DPT)
    t0 = time.time()
    dpt_bytes = write_dpt_checkpoint(ckpt / "dpt-random.pt", dpt_cfg, device)
    dpt_ckpt_s = time.time() - t0
    data = ["--dataset_path", str(scene), "--zfill", str(PRE_ZFILL)]

    def run(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rep = fn()
        torch.cuda.synchronize()
        rep["command_s"] = time.time() - t0
        rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if not rep.get("finite", True):
            raise AssertionError(f"{label}: a non-finite output")
        return rep

    flow = run("11a flow", lambda: preprocess(
        ["flow", *data, "--model", str(raft_path), "--iters", str(PRE_ITERS),
         "--long_side", str(PRE_LONG_SIDE)], device))
    depth = run("11b depth", lambda: generate_depth.main(
        [*data, "--model", str(ckpt / "dpt-random.pt")], device, dpt_cfg))
    masks = run("11c masks", lambda: preprocess(["mask", *data], device))
    if not any(masks["f_found"]):
        raise AssertionError("11c: LMedS accepted no fundamental matrix on any flow")
    T = CLI_SCENE["T"]
    for sub, n in (("flow", 2 * (T - 1)), ("disp", T), ("epipolar_error_png", T)):
        if len(list((scene / sub).iterdir())) != n:
            raise AssertionError(f"preprocessing wrote {sub}/ without its {n} files")
    disp = np.stack([np.load(p) for p in sorted((scene / "disp").glob("*.npy"))])
    if not np.ptp(disp) > 0:
        raise AssertionError("11b: every disparity map is constant")

    argv = [RECIPE[0], RECIPE[1], "--datadir", str(scene), "--basedir", str(scene.parent / "log"),
            "--expname", "preprocessed", "--downsample_train", "2", "--N_voxel_init", CLI_VOXELS,
            "--n_iters", str(CLI_STEPS), "--use_foreground_mask", "epipolar_error_png",
            *ONE_BATCH]
    args = config_parser(argv)
    t0 = time.time()
    sc = load_scene(args, device)
    load_s = time.time() - t0
    if not (np.isfinite(sc.flows_f).all() and np.isfinite(sc.disps).all()):
        raise AssertionError("the loaded preprocessed scene is not finite")
    tr = Trainer(args, sc, device=device)
    reset_counters()
    losses = [float(tr.run_step()["total_loss"]) for _ in range(CLI_STEPS)]
    launches = counters()
    del tr
    want = {k: v * CLI_STEPS for k, v in per_step.items()}
    if launches != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"11d: losses {losses}, launches {launches} != {want}")
    info = {
        "scene": f"{T}x{CLI_SCENE['H']}x{CLI_SCENE['W']} (phase 7's, frames only)",
        "weights": "seeded random, official key layouts (no checkpoints in the repository)",
        "flow": {"size": flow["size"], "iters": PRE_ITERS, "pairs": len(flow["raft_s"]),
                 "ms_per_pair_median": _median_ms(flow["raft_s"][1:]),
                 "ms_per_pair": [1e3 * s for s in flow["raft_s"]],
                 "pair_s_with_io": flow["pair_s"], "command_s": flow["command_s"],
                 "peak_gib": flow["peak_gib"], "finite": flow["finite"]},
        "depth": {"size": depth["size"], "frames": len(depth["dpt_s"]),
                  "ms_per_frame_median": _median_ms(depth["dpt_s"][1:]),
                  "ms_per_frame": [1e3 * s for s in depth["dpt_s"]],
                  "command_s": depth["command_s"], "peak_gib": depth["peak_gib"],
                  "param_bytes": dpt_bytes, "checkpoint_write_s": dpt_ckpt_s,
                  "config": dict(PRE_DPT) or "DPT-Large", "finite": depth["finite"],
                  "disp_max": float(disp.max()), "disp_positive_share": float((disp > 0).mean())},
        "masks": {"s_per_frame_median": _median_ms(masks["frame_s"]) / 1e3,
                  "frame_s": masks["frame_s"], "mask_share_mean": float(np.mean(
                      masks["mask_share"])), "command_s": masks["command_s"],
                  "peak_gib": masks["peak_gib"], "maps": len(masks["f_found"]),
                  "maps_with_f": sum(masks["f_found"]),
                  "semantic": "absent: no Mask-RCNN weights in the repository"},
        "train": {"load_scene_s": load_s, "steps": CLI_STEPS, "losses": losses,
                  "fg_mask_mean": float(sc.fg_masks.mean()), "launches": launches},
        "card_vs_cpu": compare_preprocess_devices(raft_path, device),
        "lmeds_full_size": compare_full_size_lmeds(CLI_SCENE["H"], CLI_SCENE["W"], device),
        "profile": (profile_preprocess_networks(raft_path, ckpt / "dpt-random.pt", dpt_cfg,
                                                flow["size"], depth["size"])
                    if device == "cuda" else {}),
        "card": smi,
    }
    return {"path": "preprocess", "launches": launches, "launches_per_step": per_step}, info


def profile_preprocess_networks(raft_path: Path, dpt_path: Path, cfg, flow_hw, depth_hw):
    """One RAFT pair (batch 2, PRE_ITERS refinements) and one DPT frame at
    the phase's sizes: CUDA-event ms (median of 3 windows of 3 calls), the
    profiler's device-busy ms and device activities per call, and the idle
    share between them."""
    from rodynrf_tpu_torch.preprocess.dpt import load_dpt
    from rodynrf_tpu_torch.preprocess.raft import load_raft

    raft = load_raft(str(raft_path), "cuda")
    dpt = load_dpt(str(dpt_path), "cuda", cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = 255 * torch.rand(2, 3, *flow_hw, device="cuda", generator=gen)
    b = 255 * torch.rand(2, 3, *flow_hw, device="cuda", generator=gen)
    x = torch.rand(1, 3, *depth_hw, device="cuda", generator=gen)

    def pair():
        with torch.inference_mode():
            raft(a, b, iters=PRE_ITERS)

    def frame():
        with torch.inference_mode():
            dpt(x)

    out = {}
    for name, fn in (("raft_pair", pair), ("dpt_frame", frame)):
        ms, spread = median_ms(fn, windows=3, reps=3)
        dev_ms, launches = device_profile(fn, reps=3)
        out[name] = {"ms": ms, "spread_ms": spread, "device_ms": dev_ms,
                     "device_activities": launches, "idle": 1.0 - dev_ms / ms}
    del raft, dpt
    torch.cuda.empty_cache()
    return out


def _median_ms(seconds) -> float:
    s = sorted(seconds)
    return 1e3 * s[len(s) // 2] if s else float("nan")


def compare_preprocess_devices(raft_path: Path, device: str) -> dict:
    """Phase 11e: RAFT (11a's weights, 128×128, 4 refinements) and the narrow
    DPT of tests/test_preprocess.py:93 (96×128) on `device` against the same
    modules on the CPU, and the LMedS mask of one flow on both from the same
    generator seed."""
    from rodynrf_tpu_torch.preprocess.dpt import DPTConfig
    from rodynrf_tpu_torch.preprocess.motion_masks import epipolar_error_map, motion_mask_for_frame
    from rodynrf_tpu_torch.preprocess.raft import load_raft

    rng = np.random.default_rng(3)
    img1 = torch.from_numpy(rng.uniform(0, 255, (1, 3, 128, 128)).astype(np.float32))
    img2 = (img1 + torch.from_numpy(rng.normal(0, 8, img1.shape).astype(np.float32))).clamp(0, 255)
    flows = {}
    for dev in (device, "cpu"):
        with torch.inference_mode():
            flows[dev] = load_raft(str(raft_path), dev)(img1.to(dev), img2.to(dev),
                                                        iters=4).cpu()
    epe = float(torch.linalg.vector_norm(flows[device] - flows["cpu"], dim=1).max())
    flow_scale = float(torch.linalg.vector_norm(flows["cpu"], dim=1).max())

    dpt = random_dpt(DPTConfig(**NARROW_DPT), seed=0)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 3, 96, 128)).astype(np.float32))
    with torch.inference_mode():
        ref = dpt(img)
        got = dpt.to(device)(img.to(device)).cpu()
    if not ref.abs().max() > 0:
        raise AssertionError("11e: the narrow DPT's depth is all zero")
    rel = float((got - ref).abs().max() / ref.abs().max())

    flow = flows["cpu"][0].permute(1, 2, 0).contiguous()
    flow = 3.0 * flow / torch.linalg.vector_norm(flow, dim=-1).max().clamp_min(1e-12)
    flow[40:80, 50:90, 1] += 6.0  # an independently moving patch
    masks = {}
    for dev in (device, "cpu"):
        gen = torch.Generator().manual_seed(0)
        err = epipolar_error_map(flow.to(dev), 128, 128, gen)
        masks[dev] = motion_mask_for_frame([err], 128, 128).cpu()
    agree = float((masks[device] == masks["cpu"]).float().mean())
    out = {"raft_max_epe_px": epe, "raft_epe_limit_px": RAFT_EPE_LIMIT,
           "raft_flow_scale_px": flow_scale, "dpt_max_rel": rel, "dpt_rel_limit": DPT_REL_LIMIT,
           "lmeds_mask_agreement": agree, "lmeds_agreement_min": LMEDS_AGREE_MIN,
           "lmeds_mask_share": float(masks["cpu"].mean())}
    if not (epe <= RAFT_EPE_LIMIT and rel <= DPT_REL_LIMIT and agree >= LMEDS_AGREE_MIN):
        raise AssertionError(f"11e: the card disagrees with the CPU: {out}")
    return out


def two_view_flow(H: int, W: int):
    """Flow in pixels [H, W, 2] of a static scene (smooth depth, a camera
    rotating and translating) with an independently moving patch, moved
    H/12 px across the near-horizontal epipolar lines, and the patch's
    mask."""
    from rodynrf_tpu_torch.preprocess.motion_masks import get_uv_grid

    uv = get_uv_grid(H, W).double().numpy()
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    depth = 2.0 + 0.5 * np.sin(3 * xx) * np.cos(2 * yy) + 0.3 * yy
    X = np.concatenate([uv * depth[..., None], depth[..., None]], -1)
    a = 0.04
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    X2 = X @ R.T + np.array([0.08, 0.005, 0.03])
    d = X2[..., :2] / X2[..., 2:] - uv
    flow = np.stack([d[..., 0] * (W - 1) / 2, d[..., 1] * (H - 1) / 2], -1)
    moving = np.zeros((H, W), bool)
    moving[H // 3:H // 3 + H // 4, W // 2:W // 2 + W // 5] = True
    flow[moving, 1] += H / 12
    return torch.from_numpy(flow.astype(np.float32)), torch.from_numpy(moving)


def compare_full_size_lmeds(H: int, W: int, device: str) -> dict:
    """Phase 11e at the scene's size: the LMedS fit, quantile, threshold and
    morphology of `two_view_flow` on `device` from one generator seed. It
    must accept an F, and its mask must cover the moving patch (>=
    PATCH_HIT_MIN of it) and spare the static pixels (<= STATIC_HIT_MAX of
    them). The card is held to the CPU at 128×128 (above), and the port's
    masks to the JAX package's cv2 LMedS by tests/test_torch_preprocess_masks.py;
    the CPU's fit at this size (41-51 s on the H100 machine's host) is not
    repeated."""
    from rodynrf_tpu_torch.preprocess.motion_masks import epipolar_fit, motion_mask_for_frame

    flow, moving = two_view_flow(H, W)
    t0 = time.time()
    err, found = epipolar_fit(flow.to(device), H, W, torch.Generator().manual_seed(0))
    m = motion_mask_for_frame([err], H, W).cpu()
    out = {"size": [H, W], "f_found": found, "mask_share": float(m.mean()),
           "patch_share": float(moving.float().mean()),
           "patch_hit": float(m[moving].mean()), "patch_hit_min": PATCH_HIT_MIN,
           "static_hit": float(m[~moving].mean()), "static_hit_max": STATIC_HIT_MAX,
           "fit_s": time.time() - t0}
    if not (found and out["patch_hit"] >= PATCH_HIT_MIN
            and out["static_hit"] <= STATIC_HIT_MAX):
        raise AssertionError(f"11e: the full-size LMedS mask is wrong: {out}")
    return out


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
    torch.profiler (`profile_call`)."""
    import numpy as np

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
    return profile_call("render", lambda: chunk(p, packs, aabb_t, rays, ts), top)


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
    each with its peak; one profiled step, and both kernels held to their
    plain versions at one micro-batch's shapes (10c; the segment sum at the
    merged layout's, since 'auto' puts the 640³ dynamic field on the strided
    one). Returns (the walk's record, the 10c kernel cases)."""
    import dataclasses

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

    # 640³: a profiled step. The full checkpoint is not saved at this size
    # (42-47 s on the H100 machine's host): the CPU tests hold save_full
    # and its exact resume, and phase 7 saves and resumes at 300³
    prof = profile_step(tr)
    log(f"[walk] 640³: profiled step device busy {prof['device_busy_ms']:.1f} ms, "
        f"{prof['device_launches']} launches ({smi})")

    # 10c: the kernels at one micro-batch's shapes at 640³
    S = tr.step_fn.S
    points = sample_points(tr, tr.args.batch_size // S.grad_accum)
    merged = dataclasses.replace(S.dynamic_cfg, vm_layout="merged")
    cases = check_kernels_at(tr, points, "640", merged_cfg=merged)
    record = {"path": "walk_640", **policies(S), "sizes": sizes, "launches": launches,
              "one_batch_640": one_batch,
              "profile_640": prof,
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


def timed_step(tr):
    torch.cuda.synchronize()
    t0 = time.time()
    m = tr.run_step()
    torch.cuda.synchronize()
    return m, time.time() - t0


def grad_tree(tr):
    from rodynrf_tpu_torch.train.step import named_leaves

    return {p: t.grad.detach().clone() for p, t in named_leaves(tr.full_params())
            if t.grad is not None} if not tr.grid_dims else {
        p: g for p, g in named_leaves(_whole_grads(tr))}


def _whole_grads(tr):
    from rodynrf_tpu_torch.parallel.mesh import gather_full, mesh_group

    tree = {k: tr.params[k] for k in ("static", "dynamic", "pose", "fov")}
    grads = _map_tree(lambda t: t.grad.detach(), tree)
    return gather_full(grads, tr.grid_dims, mesh_group(tr.mesh))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def compare_steps(label, ref_m, ref_g, m, g):
    """Every loss and gradient leaf of a step against the reference step's:
    {loss_rel, grad_rel (worst of scale), bit_equal leaves, leaves, top: the
    three leaves furthest off}."""
    if set(g) != set(ref_g):
        raise AssertionError(f"{label}: gradient leaves {sorted(set(g) ^ set(ref_g))}")
    rels, equal = {}, 0
    for p, r in ref_g.items():
        x = g[p].to(r.device)
        equal += int(torch.equal(x, r))
        rels[p] = float((x - r).abs().max()) / max(float(r.abs().max()), 1e-30)
    top = sorted(rels, key=rels.get, reverse=True)[:3]
    return {"loss_rel": max(abs(float(m[k]) - float(ref_m[k])) / max(abs(float(ref_m[k])), 1e-30)
                            for k in ref_m),
            "grad_rel": max(rels.values()), "bit_equal": equal, "leaves": len(ref_g),
            "top": [["/".join(map(str, p)), rels[p]] for p in top]}


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms for the body (warn_only: an op
    without a deterministic version runs as it is); yields the list of the
    distinct warnings it raised."""
    import warnings

    seen = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
        seen.extend(sorted({str(w.message)[:160] for w in caught
                            if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(False)


def check_against(label, got, card_self):
    """`got` (compare_steps) within DP_GRAD_RTOL, or within twice the card's
    own run-to-run difference of the same step where that is larger."""
    for key in ("loss_rel", "grad_rel"):
        bound = max(DP_GRAD_RTOL, 2.0 * card_self[key])
        if got[key] > bound:
            raise AssertionError(f"{label}: {key} {got[key]:.3e} past {bound:.3e} (the card's "
                                 f"own {card_self[key]:.3e}); furthest leaves {got['top']}")


def drive_distributed(scene, smi: str):
    """Phase 13: the distributed step on this card. 13a: a NCCL process
    group of world size 1 and a default-path trainer on its data mesh,
    stepped with a non-distributed trainer from the same seed (the same
    weights, batches and draws): losses and every gradient leaf compared,
    ms/step of both, table-gradient launches of the distributed steps, one
    gradient all-reduce's time. 13b: the same with --shard_grids 1 against
    13a's steps, with its peak. 13c: every card through cli.main when the
    machine has more than one. Returns the main-path records."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from rodynrf_tpu_torch.parallel.collectives import all_reduce_mean_
    from rodynrf_tpu_torch.parallel.mesh import mesh_group
    from rodynrf_tpu_torch.train import Trainer, parse_cmd
    from rodynrf_tpu_torch.train.step import named_leaves

    store = tempfile.mkdtemp(prefix="chip_smoke_store_")  # under TMPDIR, as launch.run_ranks
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    records = []
    try:
        t_phase = time.time()
        ref = Trainer(parse_cmd(" ".join(CONFIG_DEFAULT + ONE_PROCESS)), scene)
        again = Trainer(parse_cmd(" ".join(CONFIG_DEFAULT + ONE_PROCESS)), scene)
        dp = Trainer(parse_cmd(" ".join(CONFIG_DEFAULT)), scene)
        if ref.mesh is not None or dp.mesh is None or dp.mesh.size() != 1:
            raise AssertionError("13a: the distributed trainer is not on a 1-rank data mesh")
        S, layouts = dp.step_fn.S, dp.table_layouts()
        per_step = launches_per_step(S, layouts)
        ref_ms, dp_ms, cmp, own, saved, timed_cmp = [], [], [], [], [], []
        launches = {k: 0 for k in KERNELS}

        def dp_step():
            reset_counters()
            m, t = timed_step(dp)
            c = counters()
            launches.update({k: launches[k] + c[k] for k in KERNELS})
            return m, t

        torch.cuda.reset_peak_memory_stats()
        # the compared steps: under torch's deterministic algorithms, so the
        # card's atomics (index_add_, scatter_add_ backwards) do not hide what
        # the mesh path changes; `again` shows what remains of them
        with deterministic_algorithms() as nondeterministic:
            for i in range(DP_STEPS):
                m_ref, _ = timed_step(ref)
                g_ref = grad_tree(ref)
                m_again, _ = timed_step(again)
                own.append(compare_steps(f"13a step {i}, again", m_ref, g_ref, m_again,
                                         grad_tree(again)))
                m_dp, _ = dp_step()
                g_dp = grad_tree(dp)
                cmp.append(compare_steps(f"13a step {i}", m_ref, g_ref, m_dp, g_dp))
                log(f"[13a] step {i}: distributed vs not {json.dumps(cmp[-1])}; the card's "
                    f"own run-to-run {json.dumps(own[-1])}")
                check_against(f"13a step {i}", cmp[-1], own[-1])
                saved.append(({k: float(v) for k, v in m_dp.items()},
                              {p: v.cpu() for p, v in g_dp.items()}))
                del g_ref, g_dp
        # the timed steps: the card as it runs by default
        for i in range(DP_STEPS):
            m_ref, t_ref = timed_step(ref)
            g_ref = grad_tree(ref)
            m_dp, t_dp = dp_step()
            timed_cmp.append(compare_steps(f"13a timed step {i}", m_ref, g_ref, m_dp,
                                           grad_tree(dp)))
            ref_ms.append(t_ref * 1e3)
            dp_ms.append(t_dp * 1e3)
            del g_ref
        peak_dp = torch.cuda.max_memory_allocated()
        if launches != {k: v * 2 * DP_STEPS for k, v in per_step.items()}:
            raise AssertionError(f"13a: launches {launches} != {per_step} x {2 * DP_STEPS}")
        group = mesh_group(dp.mesh)
        bufs = [t.grad.detach().clone() for _, t in named_leaves(dp.params)]
        ar_bytes = sum(b.numel() * b.element_size() for b in bufs)
        ar_ms, ar_spread = median_ms(lambda: all_reduce_mean_(bufs, group), windows=5,
                                     reps=DP_ALLREDUCE_REPS)
        del ref, again, bufs
        torch.cuda.empty_cache()
        med = lambda xs: sorted(xs)[len(xs) // 2]
        rec = {
            "path": "dp1", "world_size": 1, "backend": dist.get_backend(), "grid":
            list(S.static_cfg.grid_size), "layouts": layouts, **policies(S),
            "n_samples": S.n_samples, "steps": DP_STEPS, "ms_per_step": dp_ms,
            "ms_per_step_median": med(dp_ms), "default_ms_per_step": ref_ms,
            "default_ms_per_step_median": med(ref_ms),
            "rays_per_s": dp.args.batch_size / (med(dp_ms) / 1e3),
            "launches": launches, "launches_per_step": per_step,
            "vs_default": cmp, "default_vs_itself": own,
            "deterministic_mode_warned": nondeterministic,
            "vs_default_timed_steps": timed_cmp,
            "allreduce_ms": ar_ms, "allreduce_spread_ms": ar_spread, "allreduce_bytes": ar_bytes,
            # three 300³ trainers' state resident (dp and the two references)
            "peak_gib_three_trainers": peak_dp / 2**30, "card": smi,
        }
        log(f"[13a] dp1 (NCCL, world 1): {rec['ms_per_step_median']:.1f} ms/step against the "
            f"non-distributed default's {rec['default_ms_per_step_median']:.1f} in the same call; "
            f"gradients within {max(c['grad_rel'] for c in cmp):.3e} of scale "
            f"({[c['bit_equal'] for c in cmp]} of {cmp[0]['leaves']} leaves bit for bit per "
            f"step, deterministic algorithms), the default against itself "
            f"{max(c['grad_rel'] for c in own):.3e}; in the timed steps (the card's atomics "
            f"on) {max(c['grad_rel'] for c in timed_cmp):.3e}; launches "
            f"{launches}; gradient all-reduce {ar_ms:.3f} ms over {ar_bytes / 2**20:.1f} MiB "
            f"({smi})")
        log(json.dumps({"main_path": rec}))
        records.append(rec)
        del dp
        torch.cuda.empty_cache()

        # 13b. --shard_grids 1: at world size 1 the shard is the whole grid
        sh = Trainer(parse_cmd(" ".join(CONFIG_DEFAULT + ["--shard_grids", "1"])), scene)
        if not sh.grid_dims:
            raise AssertionError("13b: no plane grid is sharded")
        S_sh = sh.step_fn.S
        per_step_sh = launches_per_step(S_sh, sh.table_layouts())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sh_ms, cmp_sh = [], []
        launches_sh = {k: 0 for k in KERNELS}

        def sh_step():
            reset_counters()
            m, t = timed_step(sh)
            c = counters()
            launches_sh.update({k: launches_sh[k] + c[k] for k in KERNELS})
            return m, t

        with deterministic_algorithms():
            for i in range(DP_STEPS):
                m_sh, _ = sh_step()
                m_ref, g_ref = saved[i]
                cmp_sh.append(compare_steps(f"13b step {i}", m_ref, g_ref, m_sh, grad_tree(sh)))
                log(f"[13b] step {i}: against 13a {json.dumps(cmp_sh[-1])}")
                check_against(f"13b step {i}", cmp_sh[-1], own[i])
        for i in range(DP_STEPS):
            sh_ms.append(sh_step()[1] * 1e3)
        peak_sh = torch.cuda.max_memory_allocated()
        if launches_sh != {k: v * 2 * DP_STEPS for k, v in per_step_sh.items()}:
            raise AssertionError(f"13b: launches {launches_sh} != {per_step_sh} x "
                                 f"{2 * DP_STEPS}")
        rec_sh = {
            "path": "dp1_shard_grids", "world_size": 1, "sharded_leaves": len(sh.grid_dims),
            "ms_per_step": sh_ms, "ms_per_step_median": med(sh_ms),
            "launches": launches_sh, "launches_per_step": per_step_sh,
            "vs_dp1": cmp_sh, "peak_gib": peak_sh / 2**30,
            "card": smi,
        }
        log(f"[13b] --shard_grids 1 ({len(sh.grid_dims)} planes, world 1): "
            f"{rec_sh['ms_per_step_median']:.1f} ms/step, against 13a: gradients within "
            f"{max(c['grad_rel'] for c in cmp_sh):.3e} of scale "
            f"({[c['bit_equal'] for c in cmp_sh]} leaves bit for bit); peak "
            f"{peak_sh / 2**30:.2f} GiB ({smi})")
        log(json.dumps({"main_path": rec_sh}))
        records.append(rec_sh)
        del sh, saved
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # 13c. every card: spawned workers (NCCL), one per card
    if torch.cuda.device_count() > 1:
        drive_multi_card(smi)  # its kernels run in the workers: not counted here
    else:
        log("[13c] not run: this machine has one card; NCCL refuses two ranks of one "
            "communicator on one card, so the multi-rank numerics rest on the gloo tests on "
            "the CPU (tests/test_torch_parallel*.py)")
    log(f"[13] phase {time.time() - t_phase:.1f} s")
    return records


def drive_multi_card(smi: str):
    """Phase 13c (more than one card): phase 7's on-disk scene, cli.main at
    300³ for DP_STEPS steps on one card (twice: the card's own run-to-run
    difference) and on every card (--n_devices 0: one spawned NCCL worker
    per card), for each path of CONFIG_MULTI: float32 strided held at every
    step, the default path at its first step (MULTI_LOSS_RTOL); then one
    640³ --shard_grids 1 step on every card at the recipe's auto
    grad_accum. Prints and returns the every-card record (its kernels ran
    in the workers: their launches are not counted here)."""
    import shutil
    import tempfile

    from rodynrf_tpu_torch.cli import main as cli_main
    from rodynrf_tpu_torch.testing import write_video_scene

    n = torch.cuda.device_count()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        write_video_scene(str(root / "scene"), **CLI_SCENE)
        base = [RECIPE[0], RECIPE[1], "--datadir", str(root / "scene"),
                "--basedir", str(root / "log"), "--downsample_train", "2",
                "--N_voxel_init", CLI_VOXELS, "--n_iters", str(DP_STEPS), "--no_tensorboard",
                "1", "--render_test", "0", "--N_vis", "0", "--progress_refresh_rate", "1",
                *ONE_BATCH]
        runs = {}
        for path, extra_path in CONFIG_MULTI.items():
            for name, extra in (("one", ONE_PROCESS), ("one_again", ONE_PROCESS),
                                ("all", ["--n_devices", "0"])):
                runs[path, name] = cli_main(base + ["--expname", f"{path}_{name}", *extra_path,
                                                    *extra])
        big = cli_main(base[:-len(ONE_BATCH)] + [
            "--expname", "walk640", "--N_voxel_init", str(640 ** 3), "--n_iters", "1",
            "--n_devices", "0", "--shard_grids", "1"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rel = lambda a, b: [abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"])]
    paths = {}
    for path in CONFIG_MULTI:
        one, again, every = (runs[path, k] for k in ("one", "one_again", "all"))
        all_rel, own_rel = rel(one, every), rel(one, again)
        bound = [max(MULTI_LOSS_RTOL, MULTI_OWN_FACTOR * o) for o in own_rel]
        held = range(DP_STEPS) if path == "f32_strided" else range(1)
        if (every["n_devices"] != n or len(all_rel) != DP_STEPS
                or not all(math.isfinite(x) for x in every["losses"])
                or any(all_rel[i] > bound[i] for i in held)):
            raise AssertionError(f"13c {path} on {every['n_devices']} of {n} cards: losses "
                                 f"{every['losses']} against one card's {one['losses']} "
                                 f"(relative {all_rel}, bounds {bound}, steps held "
                                 f"{list(held)})")
        paths[path] = dict(one=one, every=every, all_rel=all_rel, own_rel=own_rel, bound=bound,
                           held=list(held))
    if big["n_devices"] != n or not all(math.isfinite(x) for x in big["losses"]):
        raise AssertionError(f"13c 640³: {big['losses']} on {big['n_devices']} of {n} cards")
    # steady ms/step: between the first and the last progress line
    ms = lambda r: 1e3 * (r["progress_s"][-1] - r["progress_s"][0]) / (DP_STEPS - 1)
    one, every = paths["default"]["one"], paths["default"]["every"]
    rec = {
        "path": f"dp{n}", "world_size": n,
        "losses": {p: v["every"]["losses"] for p, v in paths.items()},
        "losses_one_card": {p: v["one"]["losses"] for p, v in paths.items()},
        "loss_rel": {p: v["all_rel"] for p, v in paths.items()},
        "loss_rel_one_card_again": {p: v["own_rel"] for p, v in paths.items()},
        "loss_bound": {p: v["bound"] for p, v in paths.items()},
        "steps_held": {p: v["held"] for p, v in paths.items()},
        "ms_per_step": ms(every), "ms_per_step_one_card": ms(one),
        "ms_per_step_f32": ms(paths["f32_strided"]["every"]),
        "ms_per_step_f32_one_card": ms(paths["f32_strided"]["one"]),
        "rays_per_s": 1024 / (ms(every) / 1e3), "rays_per_s_one_card": 1024 / (ms(one) / 1e3),
        "first_step_s": every["progress_s"][0], "peak_gib_rank0": every.get("peak_gib"),
        "peak_gib_one_card": one.get("peak_gib"),
        "walk640_shard_grids": {"loss": big["losses"], "step_s": big["progress_s"][0],
                                "peak_gib_rank0": big.get("peak_gib")},
        "card": smi,
    }
    for p, v in paths.items():
        log(f"[13c] {p}: {n} cards' losses off one card's by {v['all_rel']} (one card against "
            f"itself {v['own_rel']}; held at steps {v['held']} to {v['bound']})")
    log(f"[13c] {n} cards, default path: {rec['ms_per_step']:.1f} ms/step "
        f"({rec['rays_per_s']:.0f} rays/s) against one card's {rec['ms_per_step_one_card']:.1f}; "
        f"peak {rec['peak_gib_rank0']:.2f} GiB on rank 0 (one card "
        f"{rec['peak_gib_one_card']:.2f}); 640³ --shard_grids 1 step "
        f"{big['progress_s'][0]:.1f} s, peak {big.get('peak_gib'):.2f} GiB on rank 0 ({smi})")
    log(json.dumps({"main_path": rec}))
    return rec


# ---------------------------------------------------------------------------
# phase 14: the DAVIS recipe from JPEG frames
# ---------------------------------------------------------------------------


def jpeg_counters():
    from rodynrf_tpu_torch.ops import jpeg

    return {k: getattr(jpeg, k).launches for k in JPEG_KERNELS}


def reset_jpeg_counters():
    from rodynrf_tpu_torch.ops import jpeg

    for k in JPEG_KERNELS:
        getattr(jpeg, k).launches = 0


def jpeg_bytes(host) -> dict:
    """Bytes each JPEG kernel must move for a batch (each input read once,
    each output written once): entropy reads the baseline segments'
    compressed bytes, the segment list and its frames' Huffman tables and
    writes the baseline frames' int16 blocks; the progressive decode reads
    its segments' bytes, segment list, scan words and per-scan tables and
    writes the progressive frames' blocks (once, though its rounds refine
    them in place); the IDCT reads the blocks and quantisers and writes the
    planes; the colour pass reads the planes and writes 3 bytes a pixel."""
    b0 = host.plane_block0.tolist()
    prog_blocks = sum(b0[p0 + nc] - b0[p0] for f, (_, _, _, nc, p0) in
                      zip(host.frames, host.frame.tolist()) if f.progressive)
    prog_data = int(host.pseg[:, 1].sum()) if host.pseg.shape[0] else 0
    tables = host.huff.numel() * 4 + host.scan.numel() * 4 + host.seg.numel() * 4
    ptables = host.phuff.numel() * 4 + host.pscan.numel() * 4 + host.pseg.numel() * 4
    blocks = host.n_blocks * 128
    return {"jpeg_entropy": host.data.numel() - prog_data + tables + blocks - prog_blocks * 128,
            "jpeg_progressive": prog_data + ptables + prog_blocks * 128,
            "jpeg_idct": blocks + host.quant.numel() * 4 + host.n_plane_bytes,
            "jpeg_color": host.n_plane_bytes + host.n_pixels * 3}


def one_batch_launches(baseline: bool = True, rounds: int = 0) -> dict:
    """The JPEG launches of one decode_jpegs batch: the baseline entropy
    decode if the batch has baseline frames, one progressive launch per
    round, one IDCT and one colour pass."""
    return {"jpeg_entropy": int(baseline), "jpeg_progressive": rounds, "jpeg_idct": 1,
            "jpeg_color": 1}


def progressive_round_ms(dev, coef0, windows: int):
    """(ms of each round by the profiler's kernel events, ms of the whole
    decode) of ops/jpeg.jpeg_progressive on a batch on the card. The rounds
    refine their blocks in place, so every call starts from a fresh copy of
    the baseline decode's blocks `coef0`: the whole decode is the CUDA-event
    median of copy + wrapper less that of the copy alone (`windows` windows
    of one call each). The per-round split reads one wrapper call's kernel
    events under torch.profiler (None if it recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    from rodynrf_tpu_torch.ops import jpeg as K

    work = coef0.clone()

    def decode():
        work.copy_(coef0)
        K.jpeg_progressive(work, dev)

    total = median_ms(decode, windows, 1)[0] - median_ms(lambda: work.copy_(coef0), windows, 1)[0]
    per_round = None
    for _ in range(3):  # a profiler run now and then records no device activity: redo it
        work.copy_(coef0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K.jpeg_progressive(work, dev)
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "progressive_kernel" in e.name)
        if len(kernels) == len(dev.rounds):
            per_round = [us / 1e3 for _, us in kernels]
            break
    return per_round, total


def jpeg_case(label: str, paths, device: str = "cuda", reps=(5, 20)) -> dict:
    """14a: a batch of frames through the three kernels and through their
    plain versions on the CPU, equal bit for bit (blocks, status words,
    planes, pixels); each kernel's time for the batch and per frame (CUDA
    events, `reps` windows × launches), the plain versions' CPU time, each
    kernel's byte bound."""
    from rodynrf_tpu_torch.data import jpeg as J
    from rodynrf_tpu_torch.ops import jpeg as K

    host = J.pack([J.read_jpeg(str(p)) for p in paths])
    dev = host.to(device)
    plain_ms = {}
    t0 = time.perf_counter()
    coef_p, st_p = J.entropy_decode_plain(host)
    plain_ms["jpeg_entropy"] = 1e3 * (time.perf_counter() - t0)
    coef0_p = coef_p.clone()  # the baseline decode: where the progressive rounds start
    t0 = time.perf_counter()
    pst_p = J.progressive_decode_plain(coef_p, host)
    plain_ms["jpeg_progressive"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    planes_p = J.idct_plain(coef_p, host)
    plain_ms["jpeg_idct"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    rgb_p = J.color_plain(planes_p, host)
    plain_ms["jpeg_color"] = 1e3 * (time.perf_counter() - t0)
    if st_p.any() or pst_p.any():
        raise AssertionError(f"[14a] {label}: the plain decode flags a corrupt segment")
    coef, st = K.jpeg_entropy(dev)
    coef0 = coef.clone()
    pst = K.jpeg_progressive(coef, dev)
    planes = K.jpeg_idct(coef, dev)
    rgb = K.jpeg_color(planes, dev)
    for name, a, b in (("baseline blocks", coef0, coef0_p), ("status", st, st_p),
                       ("blocks", coef, coef_p), ("progressive status", pst, pst_p),
                       ("planes", planes, planes_p), ("pixels", rgb, rgb_p)):
        a = a.cpu()
        if a.shape != b.shape or not torch.equal(a, b):
            n = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"[14a] {label}: the kernels' {name} differ from the plain "
                                 f"versions' ({n} elements)")
    nbytes = jpeg_bytes(host)
    work = {"jpeg_entropy": host.seg.shape[0] > 0, "jpeg_progressive": bool(host.rounds),
            "jpeg_idct": True, "jpeg_color": True}
    nbytes = {k: v for k, v in nbytes.items() if work[k]}
    case = {"case": label, "frames": len(paths), "pixels": host.n_pixels,
            "blocks": host.n_blocks, "segments": int(host.seg.shape[0]),
            "progressive_frames": sum(f.progressive for f in host.frames),
            "progressive_segments": int(host.pseg.shape[0]), "rounds": len(host.rounds),
            "compressed_bytes": int(host.data.numel()), "max_abs_err": 0,
            "plain_cpu_ms": {k: v for k, v in plain_ms.items() if work[k]}, "bytes": nbytes,
            "bound_ms": {k: 1e3 * v / HBM_BYTES_PER_S for k, v in nbytes.items()}}
    if device == "cuda":
        windows, n = reps
        case["ms"] = {
            "jpeg_entropy": median_ms(lambda: K.jpeg_entropy(dev), windows, n)[0],
            "jpeg_idct": median_ms(lambda: K.jpeg_idct(coef, dev), windows, n)[0],
            "jpeg_color": median_ms(lambda: K.jpeg_color(planes, dev), windows, n)[0]}
        if host.rounds:
            case["ms_per_round"], case["ms"]["jpeg_progressive"] = progressive_round_ms(
                dev, coef0, max(windows, 3))
        case["ms"] = {k: v for k, v in case["ms"].items() if work[k]}
        case["ms_per_frame"] = {k: v / len(paths) for k, v in case["ms"].items()}
    log(f"[14a] {label}: {len(paths)} frames ({case['progressive_frames']} progressive, "
        f"{case['rounds']} rounds), {host.n_pixels} pixels, {case['segments']} + "
        f"{case['progressive_segments']} segments, {case['compressed_bytes']} compressed "
        f"bytes: kernels = "
        f"plain versions bit for bit; kernel ms {case.get('ms')}, per round "
        f"{case.get('ms_per_round')}, bound ms {case['bound_ms']}, plain CPU ms "
        f"{case['plain_cpu_ms']}")
    return case


def davis_step_path(tr, path: str, smi: str, load_launches=None):
    """DAVIS_WARM + DAVIS_TIMED steps of a trainer with the counts set to 0
    before them (`load_launches`: the JPEG launches of the scene load that
    just preceded, counted into this path's record; none for a trainer on
    an already loaded scene), launches checked against the layouts auto
    chose. Returns the `main_path` record."""
    S = tr.step_fn.S
    layouts = tr.table_layouts()
    per_step = launches_per_step(S, layouts)
    n = DAVIS_WARM + DAVIS_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    run_steps(tr, DAVIS_WARM, f"{path} warm")
    torch.cuda.synchronize()
    t0 = time.time()
    run_steps(tr, DAVIS_TIMED, f"{path} timed")
    step_s = (time.time() - t0) / DAVIS_TIMED
    launches = {**counters(), **(load_launches or {k: 0 for k in JPEG_KERNELS})}
    peak = torch.cuda.max_memory_allocated()
    for k in KERNELS:
        if launches[k] != per_step[k] * n:
            raise AssertionError(f"{path}: {k} launches {launches[k]} != {per_step[k]} x {n}")
    record = {"path": path, "layouts": layouts, "grid": list(S.static_cfg.grid_size),
              **policies(S), "n_samples": S.n_samples, "ms_per_step": step_s * 1e3,
              "rays_per_s": tr.args.batch_size / step_s, "peak_gib": peak / 2**30,
              "steps": n, "timed_steps": DAVIS_TIMED, "launches": launches,
              "launches_per_step": per_step, "card": smi}
    log(f"[14c] {path}: grid {record['grid']}, {S.n_samples} samples/ray, layouts {layouts}, "
        f"{step_s * 1e3:.1f} ms/step, {record['rays_per_s']:.1f} rays/s, peak "
        f"{peak / 2**30:.2f} GiB, launches {launches} ({smi})")
    log(json.dumps({"main_path": record}))
    return record


def drive_davis(smi: str, device: str = "cuda"):
    """Phase 14: configs/DAVIS.txt from JPEG frames. Writes a DAVIS-layout
    scene of DAVIS_SCENE's frames as baseline 4:2:0 JPEG and one of
    DAVIS_PROGRESSIVE's as progressive JPEG, then 14a the kernels against
    their plain versions (the fixtures, baseline and mixed with the
    progressive ones; each scene's frames as one batch), 14b the
    preprocessing commands (flow, depth into dpt/, masks into
    epipolar_error_png/, 5-digit names), 14c the recipe through cli.main at
    its 16³ start (3 steps, evaluation, checkpoint) and a trainer's timed
    steps at 16³ and 256³, 14d the progressive scene through load_scene
    (card = CPU) and cli.main (1 step, --render_test 0). Prints the `davis`
    line; returns the main-path records. (`device` and the module's DAVIS_*
    sizes let the phase be rehearsed on the CPU.)"""
    import shutil
    import tempfile

    from rodynrf_tpu_torch.cli import main as cli_main
    from rodynrf_tpu_torch.data import jpeg as J
    from rodynrf_tpu_torch.data.jpeg import decode_jpegs
    from rodynrf_tpu_torch.data.video_dataset import load_scene
    from rodynrf_tpu_torch.ops import jpeg as K
    from rodynrf_tpu_torch.preprocess import generate_depth
    from rodynrf_tpu_torch.preprocess import main as preprocess
    from rodynrf_tpu_torch.preprocess.dpt import DPTConfig
    from rodynrf_tpu_torch.testing import write_jpeg, write_video_scene
    from rodynrf_tpu_torch.train import Trainer, config_parser

    t_phase = time.time()
    T, H, W = DAVIS_SCENE["T"], DAVIS_SCENE["H"], DAVIS_SCENE["W"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_davis_"))
    records = []
    try:
        scene = root / "scene"
        t0 = time.time()
        write_video_scene(str(scene), T, H, W, seed=14, layout="davis", fmt="jpg",
                          frames_only=True)
        write_s = time.time() - t0
        frames = sorted((scene / "images").glob("*.jpg"))
        PT, PH, PW = (DAVIS_PROGRESSIVE[k] for k in ("T", "H", "W"))
        prog = root / "progressive"
        t0 = time.time()
        write_video_scene(str(prog), PT, PH, PW, seed=14, layout="davis", fmt="jpg",
                          progressive=True)
        write_s = {"baseline": write_s, "progressive": time.time() - t0}
        prog_frames = sorted((prog / "images").glob("*.jpg"))

        # 14a. the kernels against their plain versions: the fixtures, the
        # scene's frames as the one batch the loader, flow and depth decode,
        # and one frame re-encoded with restart markers
        every = sorted(JPEG_FIXTURES.glob("*.jpg"))
        fixtures = [p for p in every if "progressive" not in p.name]
        slow = (3, 2)  # windows × launches for the whole-frame cases
        cases = [jpeg_case("fixtures", fixtures, device),
                 jpeg_case(f"{T} frames {W}x{H} 4:2:0 q{DAVIS_QUALITY} (the loader's batch)",
                           frames, device, slow)]
        first = decode_jpegs(frames[:1], device)[0].cpu().numpy()
        rst = root / "restart.jpg"
        write_jpeg(str(rst), first, DAVIS_QUALITY, "420", DAVIS_RESTART)
        cases.append(jpeg_case(f"{W}x{H} 4:2:0 q{DAVIS_QUALITY} restart {DAVIS_RESTART}",
                               [rst], device, slow))
        cases.append(jpeg_case("fixtures, baseline + progressive", every, device))
        cases.append(jpeg_case(f"{PT} frames {PW}x{PH} 4:2:0 q{DAVIS_QUALITY} progressive "
                               f"(the loader's batch)", prog_frames, device, slow))
        # decode_jpegs on the two batches (host parse + copy + kernels +
        # status), and the kernels on the restart batch (the frames batch's
        # are its 14a case)
        batch = {}
        for key, paths in (("frames", frames), ("restart", [rst] * T),
                           ("progressive", prog_frames)):
            torch.cuda.synchronize()
            t0 = time.time()
            decode_jpegs(paths, device)
            torch.cuda.synchronize()
            batch_s = time.time() - t0
            host = J.pack([J.read_jpeg(str(p)) for p in paths])
            n = len(paths)
            rec = batch[key] = {"frames": n, "segments": int(host.seg.shape[0]),
                                "progressive_segments": int(host.pseg.shape[0]),
                                "rounds": len(host.rounds), "decode_jpegs_s": batch_s,
                                "decode_jpegs_ms_per_frame": 1e3 * batch_s / n}
            if key == "frames":
                rec["kernel_ms"] = cases[1].get("ms")
            elif key == "progressive":
                rec["kernel_ms"] = cases[4].get("ms")
            elif device == "cuda":
                dev = host.to(device)
                coef, _ = K.jpeg_entropy(dev)
                planes = K.jpeg_idct(coef, dev)
                rec["kernel_ms"] = {
                    "jpeg_entropy": median_ms(lambda: K.jpeg_entropy(dev), *slow)[0],
                    "jpeg_idct": median_ms(lambda: K.jpeg_idct(coef, dev), *slow)[0],
                    "jpeg_color": median_ms(lambda: K.jpeg_color(planes, dev), *slow)[0]}
                del coef, planes, dev
            if rec.get("kernel_ms"):
                rec["kernel_ms_per_frame"] = {k: v / n for k, v in rec["kernel_ms"].items()}
            log(f"[14a] {n} frames as one batch ({key}: {rec['segments']} + "
                f"{rec['progressive_segments']} progressive segments): "
                f"decode_jpegs {batch_s * 1e3:.1f} ms (host parse + copy + kernels + status), "
                f"kernels {rec.get('kernel_ms')}")

        # 14b. preprocessing on the card, every frame read through the kernels
        ckpt = root / "ckpt"
        ckpt.mkdir()
        raft_path = write_raft_checkpoint(ckpt / "raft-random.pth")
        dpt_cfg = DPTConfig(**PRE_DPT)
        write_dpt_checkpoint(ckpt / "dpt-random.pt", dpt_cfg, device)
        data = ["--dataset_path", str(scene), "--zfill", "5"]
        pre = {}
        for label, fn in (
                ("flow", lambda: preprocess(["flow", *data, "--model", str(raft_path),
                                             "--iters", str(PRE_ITERS),
                                             "--long_side", str(PRE_LONG_SIDE)], device)),
                ("depth", lambda: generate_depth.main(
                    [*data, "--model", str(ckpt / "dpt-random.pt"), "--out_dir", "dpt"],
                    device, dpt_cfg)),
                ("mask", lambda: preprocess(["mask", *data], device))):
            reset_jpeg_counters()
            torch.cuda.synchronize()
            t0 = time.time()
            rep = fn()
            torch.cuda.synchronize()
            pre[label] = {"command_s": time.time() - t0, "jpeg_launches": jpeg_counters(),
                          **{k: rep[k] for k in ("read_s", "size", "f_found") if k in rep}}
            if not rep.get("finite", True):
                raise AssertionError(f"14b {label}: a non-finite output")
            want = (one_batch_launches() if label in ("flow", "depth")
                    else {k: 0 for k in JPEG_KERNELS})
            if pre[label]["jpeg_launches"] != want:
                raise AssertionError(f"14b {label}: JPEG launches {pre[label]['jpeg_launches']}"
                                     f", {want} expected (one batch per command)")
        if not any(pre["mask"].pop("f_found")):
            raise AssertionError("14b: LMedS accepted no fundamental matrix on any flow")
        for sub, n in (("flow", 2 * (T - 1)), ("dpt", T), ("epipolar_error_png", T)):
            names = sorted(p.name for p in (scene / sub).iterdir())
            if len(names) != n or len(names[0].split(".")[0].split("_")[0]) != 5:
                raise AssertionError(f"14b: {sub}/ holds {names[:3]}..., not {n} 5-digit files")
        log(f"[14b] preprocessing of {T} {W}x{H} JPEG frames: {pre}")

        # 14c. the recipe through the CLI at its 16³ start
        argv = [*DAVIS_RECIPE, "--datadir", str(scene), "--basedir", str(root / "log"),
                "--expname", "davis", "--n_iters", str(DAVIS_CLI_STEPS), "--N_voxel_t", str(T),
                "--no_tensorboard", "1", "--render_path", "0", "--progress_refresh_rate", "1",
                "--downsample_train", "2", *ONE_PROCESS]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        reset_jpeg_counters()
        t0 = time.time()
        rep = cli_main(argv, device)
        cli_s = time.time() - t0
        launches = {**counters(), **jpeg_counters()}
        peak_cli = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in rep["losses"]) or len(rep["losses"]) != \
                DAVIS_CLI_STEPS:
            raise AssertionError(f"14c CLI: losses {rep['losses']}")
        if len(rep["psnrs"]) != T or not all(math.isfinite(p) for p in rep["psnrs"]):
            raise AssertionError(f"14c CLI: evaluation PSNRs {rep['psnrs']}")

        args16 = config_parser(argv)
        reset_jpeg_counters()
        t0 = time.time()
        sc = load_scene(args16, device)
        load_s = time.time() - t0
        load_launches = jpeg_counters()
        if load_launches != one_batch_launches():
            raise AssertionError(f"14c: the loader launched {load_launches}, one batch expected")
        if sc.img_wh != (W // 2, H // 2) or sc.n_frames != T:
            raise AssertionError(f"14c: the loader gave {sc.img_wh} x {sc.n_frames}")
        tr = Trainer(args16, sc, device=device)
        per16 = launches_per_step(tr.step_fn.S, tr.table_layouts())
        want = {**{k: v * DAVIS_CLI_STEPS for k, v in per16.items()}, **load_launches}
        if launches != want:
            raise AssertionError(f"14c CLI: launches {launches} != {want}")
        cli_record = {"path": "davis_cli", "launches": launches, "launches_per_step": per16}
        records.append(cli_record)
        log(json.dumps({"main_path": cli_record}))
        records.append(davis_step_path(tr, "davis_16", smi, load_launches))
        del tr
        torch.cuda.empty_cache()

        # 14c. the same recipe at 256³, on the same loaded scene
        args256 = config_parser(argv + ["--N_voxel_init", DAVIS_VOXELS_256, "--render_test", "0"])
        tr = Trainer(args256, sc, device=device)
        records.append(davis_step_path(tr, "davis_256", smi))
        del tr, sc
        torch.cuda.empty_cache()

        # 14d. the progressive scene: the loader on the card against the
        # loader on the CPU (plain versions), then cli.main, 1 step
        pargv = [*DAVIS_RECIPE, "--datadir", str(prog), "--basedir", str(root / "log"),
                 "--expname", "davis_progressive", "--n_iters", "1", "--N_voxel_t", str(PT),
                 "--no_tensorboard", "1", "--render_test", "0", "--render_path", "0",
                 "--progress_refresh_rate", "1", *ONE_PROCESS]
        pargs = config_parser(pargv)
        rounds = cases[4]["rounds"]
        reset_jpeg_counters()
        t0 = time.time()
        psc = load_scene(pargs, device)
        pload_s = time.time() - t0
        pload = jpeg_counters()
        if pload != one_batch_launches(False, rounds):
            raise AssertionError(f"14d: the loader launched {pload}, "
                                 f"{one_batch_launches(False, rounds)} expected")
        cpu_sc = load_scene(pargs, "cpu")
        if not np.array_equal(np.asarray(psc.rgbs_stack), np.asarray(cpu_sc.rgbs_stack)):
            raise AssertionError("14d: the progressive scene loads differently on the card and "
                                 "on the CPU")
        tr = Trainer(pargs, cpu_sc, device=device)
        pper = launches_per_step(tr.step_fn.S, tr.table_layouts())
        del psc, cpu_sc, tr
        torch.cuda.synchronize()
        reset_counters()
        reset_jpeg_counters()
        t0 = time.time()
        prep = cli_main(pargv, device)
        pcli_s = time.time() - t0
        plaunches = {**counters(), **jpeg_counters()}
        if len(prep["losses"]) != 1 or not all(math.isfinite(x) for x in prep["losses"]):
            raise AssertionError(f"14d CLI: losses {prep['losses']}")
        # a CLI run ends in the reference's final evaluation of the training
        # frames (train.py:2623-2641), --render_test 0 or not
        if len(prep["psnrs"]) != PT or not all(math.isfinite(p) for p in prep["psnrs"]):
            raise AssertionError(f"14d CLI: evaluation PSNRs {prep['psnrs']}")
        pwant = {**pper, **one_batch_launches(False, rounds)}
        if plaunches != pwant:
            raise AssertionError(f"14d CLI: launches {plaunches} != {pwant}")
        prog_record = {"path": "davis_progressive", "launches": plaunches,
                       "launches_per_step": pper, "steps": 1}
        records.append(prog_record)
        # the DAVIS recipe's checkpoint (contract rays, --fea_pe 6, the
        # time-embedded feature MLP) read back: the same PSNRs as the final
        # evaluation
        t0 = time.time()
        prrep = cli_main(pargv + ["--render_only", "1", "--render_test", "1", "--ckpt",
                                  prep["ckpt"]], device)
        prender_s = time.time() - t0
        if prrep["psnrs"] != prep["psnrs"]:
            raise AssertionError(f"14d: render_only PSNRs {prrep['psnrs']} != the final "
                                 f"evaluation's {prep['psnrs']}")
        log(f"[14d] {PT} progressive {PW}x{PH} frames: load_scene {pload_s:.2f} s (card = CPU "
            f"bit for bit), cli.main {pcli_s:.1f} s (loader {prep['loader_s']:.2f} s, final "
            f"evaluation {prep['eval_s']:.1f} s), loss {prep['losses']}, launches {plaunches}; "
            f"--render_only {prender_s:.1f} s, the same PSNRs ({smi})")
        log(json.dumps({"main_path": prog_record}))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    davis = {
        "scene": f"{T} frames {W}x{H}, DAVIS layout, baseline 4:2:0 JPEG q{DAVIS_QUALITY} "
                 f"(testing.write_jpeg), preprocessed on the card; trained at "
                 f"--downsample_train 2 ({W // 2}x{H // 2})",
        "progressive_scene": f"{PT} frames {PW}x{PH}, DAVIS layout, progressive 4:2:0 JPEG "
                             f"q{DAVIS_QUALITY} (testing.write_jpeg, libjpeg's standard "
                             f"script); trained at --downsample_train 2",
        "progressive": {"load_scene_s": pload_s, "load_launches": pload, "cli_s": pcli_s,
                        "loader_s": prep["loader_s"], "train_s": prep["train_s"],
                        "eval_s": prep["eval_s"], "losses": prep["losses"],
                        "psnrs": prep["psnrs"], "launches": plaunches,
                        "render_only_s": prender_s, "render_only_psnrs_equal": True},
        "write_s": write_s, "jpeg_cases": cases, "jpeg_batch": batch, "preprocess": pre,
        "cli": {"main_s": cli_s, "loader_s": rep["loader_s"], "train_s": rep["train_s"],
                "eval_s": rep["eval_s"], "losses": rep["losses"], "psnrs": rep["psnrs"],
                "peak_gib": peak_cli / 2**30,
                "launches": launches, "load_scene_s": load_s},
        "steps": {r["path"]: {k: r[k] for k in ("grid", "layouts", "n_samples", "ms_per_step",
                                                "rays_per_s", "peak_gib", "launches_per_step")}
                  for r in records if "ms_per_step" in r},
        "phase_s": time.time() - t_phase, "card": smi,
    }
    log(json.dumps({"davis": davis}))
    return records, davis


# ---------------------------------------------------------------------------
# phase 15: the quality run, shortened
# ---------------------------------------------------------------------------


def drive_quality(smi: str, device: str = "cuda", scene=None, n_iters: int = QUALITY_ITERS,
                  extra: str = "", expected_events=None, export_dim: int = QUALITY_EXPORT_DIM):
    """Phase 15: `tools.quality_run.run` of the ndc recipe on its 8×96×128
    scene (or `scene`, with the recipe flags `extra`) for n_iters
    iterations with the counts set to 0 before it: every schedule event at
    the iteration the plan gives (`expected_events`, default QUALITY_EVENTS
    at QUALITY_ITERS), both table-gradient kernels launched, every metric
    finite, the eval PSNR above the first logged train PSNR. Then
    `tools.export_alpha` of its checkpoint on the card (default max_dim:
    the mask's occupancy) and at `export_dim` on the card and on the CPU:
    the masks may differ only at voxels whose pooled alpha lies within
    QUALITY_MASK_ATOL of the threshold. Prints one `quality` JSON line;
    returns (its `main_path` record, the line's content)."""
    import shutil
    import tempfile

    from rodynrf_tpu_torch.data import make_synthetic_scene
    from rodynrf_tpu_torch.tools import export_alpha, quality_run

    if scene is None:
        scene = make_synthetic_scene(**quality_run.SCENE, ray_type="ndc")
    if expected_events is None and n_iters == QUALITY_ITERS:
        expected_events = QUALITY_EVENTS
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_"))
    try:
        t0 = time.time()
        reset_counters()
        rec = quality_run.run("ndc", n_iters, scene=scene, device=device, out=str(root),
                              extra=extra, log=lambda *a: None)
        launches = counters()
        run_s = time.time() - t0
        ckpt, thres = rec["ckpt"], 1e-4
        t1 = time.time()
        mask = export_alpha.export(ckpt, str(root / "mask.npz"), device=device)
        export_s = time.time() - t1
        paths = {dev: str(root / f"mask_{export_dim}_{dev}.npz") for dev in (device, "cpu")}
        secs = {}
        for dev, path in paths.items():
            t1 = time.time()
            export_alpha.export(ckpt, path, export_dim, thres, device=dev)
            secs[dev] = time.time() - t1
        alpha, _, _ = export_alpha.checkpoint_alpha(ckpt, export_dim, device)
        pooled = export_alpha.pooled_alpha(alpha).cpu().numpy()
        agree = export_alpha.compare_masks(paths[device], paths["cpu"], pooled, thres,
                                           QUALITY_MASK_ATOL)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info = {
        "n_iters": n_iters, "scene": rec["scene"], "grid_final": rec["grid_final"],
        "n_samples": rec["n_samples"], "ms_per_step_median": rec["ms_per_step_median"],
        "ms_per_step_by_grid": rec["ms_per_step_by_grid"], "peak_gib": rec["peak_gib"],
        "eval_psnr": rec["eval_psnr"], "eval_ssim": rec["eval_ssim_mean"],
        "first_logged_train_psnr": rec["first_logged_train_psnr"],
        "train_psnr_curve": rec["train_psnr_curve"], "events": rec["events"],
        "events_expected": rec["events_expected"], "launches": launches,
        "mask_occupancy": mask["occupancy"], "mask_grid": mask["grid"], "export_s": export_s,
        "card_vs_cpu": {**agree, "max_dim": export_dim, "export_s": secs},
        "run_s": run_s, "phase_s": time.time() - t0, "card": smi,
    }
    log(f"[15] quality_run ndc {n_iters} iterations: {info['ms_per_step_median']:.1f} ms/step, "
        f"eval PSNR {info['eval_psnr']:.3f} SSIM {info['eval_ssim']}, events {rec['events']}, "
        f"launches {launches}, mask occupancy {mask['occupancy']}, card vs CPU {agree} "
        f"({info['phase_s']:.1f} s; {smi})")
    log(json.dumps({"quality": info}))
    values = [info["eval_psnr"], info["eval_ssim"], info["ms_per_step_median"],
              *(p for _, p in info["train_psnr_curve"]), *rec["final_metrics"].values()]
    if not all(v is not None and math.isfinite(v) for v in values):
        raise AssertionError(f"15: a non-finite metric: {values}")
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"15: a table-gradient kernel launched no time: {launches}")
    want = expected_events if expected_events is not None else rec["events_expected"]
    if rec["events"] != want or rec["events_expected"] != want:
        raise AssertionError(f"15: events {rec['events']}, the plan's {rec['events_expected']}, "
                             f"expected {want}")
    if not info["eval_psnr"] > info["first_logged_train_psnr"]:
        raise AssertionError(f"15: eval PSNR {info['eval_psnr']} not above the first logged "
                             f"train PSNR {info['first_logged_train_psnr']}")
    if agree["differ_off_threshold"] or not agree["aabb_equal"]:
        raise AssertionError(f"15: the card's mask disagrees with the CPU's: {agree}")
    record = {"path": "quality", "grid": rec["grid_final"], "n_samples": rec["n_samples"],
              "ms_per_step": rec["ms_per_step_median"], "steps": n_iters,
              "launches": launches, "peak_gib": rec["peak_gib"], "card": smi}
    log(json.dumps({"main_path": record}))
    return record, info


def main() -> int:
    t_start = time.time()
    kernels_only = "--kernels-only" in sys.argv[1:]
    parallel_only = "--parallel-only" in sys.argv[1:]
    davis_only = "--davis-only" in sys.argv[1:]
    quality_only = "--quality-only" in sys.argv[1:]
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
    reports = cuda_build.build(KERNELS + JPEG_SOURCES)
    log(f"[build] {time.time() - t0:.1f} s (compiled: {sorted(reports) or 'none, cached'})")
    for name, rep in reports.items():
        for fn, info in ptxas_summary(rep):
            log(f"[build] {name}: {fn}: {info}")

    if quality_only:  # phase 15 alone
        drive_quality(smi)
        log(f"[done] {time.time() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}), flush=True)
        return 0
    scene = make_synthetic_scene(**SCENE, ray_type=parse_cmd(" ".join(RECIPE)).ray_type)
    if parallel_only or davis_only:  # phase 13 or phase 14 alone
        for rec in (drive_distributed(scene, smi) if parallel_only else drive_davis(smi)[0]):
            log(f"[{13 if parallel_only else 14}] {rec['path']}: launches {rec['launches']}")
        log(f"[done] {time.time() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}), flush=True)
        return 0
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

    # 11. preprocessing on the card from phase 7's frames, then training on it
    pre_record, pre_info = drive_preprocess(smi, default["launches_per_step"])
    records.append(pre_record)
    log(json.dumps({"preprocess": pre_info}))
    torch.cuda.empty_cache()

    # 8. the golden gates on the card
    log(json.dumps({"golden": golden_gates(smi)}))

    # 9. compaction at full width (9d ran inside phase 7)
    compact_records, compact_info = drive_compaction(scene, smi)
    records.extend(compact_records)

    # 10b-10c. the recipe's upsample schedule to 640³, the kernels there
    walk, cases_640 = walk_schedule(scene, smi)
    records.append(walk)

    # 14. the DAVIS recipe from JPEG frames: the JPEG kernels, preprocessing,
    # the recipe at 16³ and 256³
    davis_records, davis = drive_davis(smi)
    records.extend(davis_records)

    # 15. the quality run, shortened: the schedule's events, the kernels, the
    # evaluation and the mask export
    records.append(drive_quality(smi)[0])

    # 13. the distributed step (a NCCL group of its own, torn down after)
    records.extend(drive_distributed(scene, smi))

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
    for name, source in (("jpeg_entropy", "jpeg_entropy.cu"),
                         ("jpeg_progressive", "jpeg_progressive.cu"),
                         ("jpeg_idct", "jpeg_idct.cu"), ("jpeg_color", "jpeg_idct.cu")):
        # the scene's frames as one batch: 1920×1080 baseline, or 854×480
        # progressive for the progressive decode
        frame_case = davis["jpeg_cases"][4 if name == "jpeg_progressive" else 1]
        kernels.append({
            "name": name, "route": "cuda", "source": f"rodynrf_tpu_torch/csrc/{source}",
            "replaces": "rodynrf_tpu/data/video_dataset.py:29 (PIL's libjpeg-turbo on the host; "
                        "no TPU kernel)",
            "launches": launches(name),
            # only phase 14's records count JPEG launches; the others read 0
            "launches_by_path": {r["path"]: r.get("launches", r.get("launches_after"))
                                 .get(name, 0) for r in records},
            "max_abs_err": max(c["max_abs_err"] for c in davis["jpeg_cases"]),
            "ms": frame_case["ms"][name], "ms_per_frame": frame_case["ms_per_frame"][name],
            "plain_ms": frame_case["plain_cpu_ms"][name],
            "plain_device": "cpu", "bound_ms": frame_case["bound_ms"][name],
            "bound_by": "bytes", "library_ms": None, "case": frame_case["case"],
            "ms_per_round": frame_case.get("ms_per_round") if name == "jpeg_progressive"
            else None,
            "cases": [{k: c.get(k) for k in ("case", "frames", "segments", "rounds", "ms",
                                             "plain_cpu_ms", "bound_ms")}
                      for c in davis["jpeg_cases"]],
            "batch_ms": {k: b["kernel_ms"].get(name) for k, b in davis["jpeg_batch"].items()},
        })
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
