"""The readings that set each limit: the program's numbers over many seeds
(the lower reading), the lower-precision control's (the reference with its
matrix products in TF32, put in the program's place) and, for training,
the planted faults' (the upper reading).

    python3 -m portbench.lib.controls --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 2]

on the card, from the root of a checkout; one JSON line per reading. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..reference import render as RR
from . import compare, inputs, loops
from .harness import execute
from .spec import load_cell, reference_recipe, scene_box


def control_train(cell, seed: int, device, keep: float = 1.0, matmul: str = "tf32"):
    """Numbers of a stand-in for the program against the reference on the
    cell's own inputs: the reference in `matmul` precision (the control), or
    with `keep` < 1 the reference on the first share of every batch (the
    fault "half the batch left out, the mean over the rest")."""
    cfg = cell.config
    recipe = reference_recipe(cfg, seed)
    scene, poses = inputs.make_scene(cfg, seed, device)
    p0 = {p: t.cpu().numpy() for p, t in inputs.make_params(recipe.model, poses, seed,
                                                              device).items()}
    it, n = int(cfg["iteration"]), int(cell.traffic["compared_steps"])
    ref = loops.reference_train(recipe, scene, p0, it, seed, n, device)
    alt = loops.reference_train(recipe, scene, p0, it, seed, n, device, matmul=matmul, keep=keep)
    return compare.train_numbers(alt[0], ref[0], alt[1], ref[1],
                                 {p: alt[2][p] - p0[p] for p in p0},
                                 {p: ref[2][p] - p0[p] for p in p0})


def control_render(cell, seed: int, device, frames: int = 2, matmul: str = "tf32"):
    """The control's render numbers: the reference in `matmul` precision
    against the reference, at the pixels a run would compare, of `frames`
    frames."""
    cfg = cell.config
    model = reference_recipe(cfg, seed).model
    _, poses = inputs.make_scene(cfg, seed, device, arrays=False)
    params = {p: t.cpu() for p, t in inputs.make_params(model, poses, seed, device).items()}
    c2w, focal = loops.cameras(params, model)
    ts = np.linspace(-1.0, 1.0, model.T) if model.T > 1 else np.zeros(1)
    n_rays = int(cell.traffic["compared_rays_per_frame"])
    tree = inputs.fresh_tree(params, device, requires_grad=False)
    aabb = torch.as_tensor(scene_box(model.ray_type), device=device)
    rng = np.random.default_rng(seed)
    HW = model.H * model.W
    got = {key: {k: [] for k in RR.MAPS} for key in ("ref", "alt")}
    alt_model = dataclasses.replace(model, matmul=matmul)
    for k in range(frames):
        pix = torch.as_tensor(np.sort(rng.choice(HW, size=min(n_rays, HW), replace=False)),
                              device=device)
        for key, mdl in (("ref", model), ("alt", alt_model)):
            maps = RR.render_rays(tree, mdl, aabb, torch.as_tensor(c2w[k], device=device),
                                  focal, float(ts[k]), pix)
            for name, v in maps.items():
                got[key][name].append(v.reshape(len(pix), -1).cpu().numpy())
    cat = lambda d: {k: np.concatenate(v, 0) for k, v in d.items()}
    return compare.render_numbers(cat(got["alt"]), cat(got["ref"]))


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    kind = cell.traffic["loop"]
    for s in _seeds(a.seeds):
        t0 = time.perf_counter()
        res, checks, run = execute(a.workload, s, a.seconds, False, a.device, t0)
        print(json.dumps({"reading": "program", "cell": a.workload, "seed": s,
                          "correct": res["correct"], "numbers": {k: v[0] for k, v in
                                                                 checks.items()},
                          "setup_s": res["metrics"]["setup_s"]["value"],
                          "rate": list(res["metrics"].values())[0]["value"],
                          "peak_gib": res["device"]["memory_peak_bytes"] / 2 ** 30,
                          "leaves": run.widest or None,
                          "s": time.perf_counter() - t0}), flush=True)
        loops._free(a.device)
    for s in _seeds(a.control_seeds):
        t0 = time.perf_counter()
        nums = (control_train(cell, s, a.device) if kind == "train"
                else control_render(cell, s, a.device))
        print(json.dumps({"reading": "control_tf32", "cell": a.workload, "seed": s,
                          "correct": compare.judge(nums, cell.limits), "numbers": nums,
                          "s": time.perf_counter() - t0}), flush=True)
        loops._free(a.device)
    for s in _seeds(a.fault_seeds):
        if kind != "train":
            break
        t0 = time.perf_counter()
        nums = control_train(cell, s, a.device, keep=0.5, matmul="float32")
        print(json.dumps({"reading": "fault_half_batch", "cell": a.workload, "seed": s,
                          "correct": compare.judge(nums, cell.limits), "numbers": nums,
                          "s": time.perf_counter() - t0}), flush=True)
        loops._free(a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
