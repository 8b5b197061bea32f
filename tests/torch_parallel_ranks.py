"""Rank-side code of the port's multi-process tests (tests/test_torch_parallel*.py).

Each function runs in a rank spawned by
`rodynrf_tpu_torch.parallel.launch.run_ranks` (gloo, one CPU thread per
rank), or in the test process itself as the one-process reference. The
module imports only the port, numpy and torch: a spawned rank imports it by
name and must not import JAX or the JAX package (each result says whether
either was loaded).
"""

from __future__ import annotations

import dataclasses
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from rodynrf_tpu_torch.parallel.mesh import gather_full, mesh_group
from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene
from rodynrf_tpu_torch.train import Trainer, parse_cmd
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.schedule import PermutationSampler
from rodynrf_tpu_torch.train.step import make_train_step

IT = 25  # past upsamp3 = 20: every gated loss term is live
CMD = tiny_cmd("ndc", 1)
STRIDED = CMD + " --vm_layout strided"
# a 32³ grid, up to 28 samples per ray, a mask threshold inside the random
# fields' alpha (tests/test_torch_compact_train.py)
COMPACT = (" --N_voxel_init 32768 --N_voxel_final 32768 --nSamples 64 --compact_train 1"
           " --alpha_mask_thre 0.04 --compact_quantile 0.5")
CASES = {
    "f32": STRIDED,
    # the TV weights doubled: the TV gradient is the difference to "f32"
    "tv2": STRIDED + " --TV_weight_density 0.2 --TV_weight_app 0.02",
    "bf16": CMD + " --bf16 1",  # auto: the dynamic field's tables merged
    "accum2": STRIDED + " --grad_accum 2",
    "fused": STRIDED + " --fused_passes 1",
    "flat": STRIDED + COMPACT,
    # 2 flat slots per ray: the batch's occupied samples overflow the bucket
    "flat_overflow": STRIDED + COMPACT,
    # batched passes: one flat bucket over several passes' rows
    "fused_flat_overflow": STRIDED + COMPACT + " --fused_passes 1",
}
OVERFLOW_F = 2


def jax_loaded() -> bool:
    return "jax" in sys.modules or "rodynrf_tpu" in sys.modules


def batch(tr):
    ps = PermutationSampler(tr.scene.n_rays, tr.args.batch_size, 7)
    return torch.as_tensor(ps.nextids()), torch.as_tensor(ps.nextids())


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f64(v) for v in tree]
    return torch.tensor(np.asarray(tree, np.float64), requires_grad=True)


def step_grads(name: str, weights=None, f64: bool = False):
    """One golden_det step of case `name` at iteration IT on the TINY
    scene, in float64 with `f64`: (gradient tree as numpy, metrics as
    floats, flat slots per ray or None). `weights`: a numpy parameter tree
    to start from (else the trainer's seeded init)."""
    a = parse_cmd(CASES[name])
    a.golden_det = 1
    tr = Trainer(a, tiny_scene("ndc"), device="cpu")
    if weights is not None:
        tr.set_params(weights)
    S, flat = tr.step_fn.S, None
    if name.startswith("flat"):
        tr.update_alpha_mask()
        flat = OVERFLOW_F if name.endswith("overflow") else (tr.compact_flat
                                                          or tr._probe_compact_k()[1])
        S = dataclasses.replace(tr.step_fn.S, compact_flat=flat)
    params, aabb, data = tr.params, tr.aabb, tr.data
    if f64:
        params = _f64(params_to_numpy(params))
        aabb = aabb.double()
        data = {k: v.double() if v.is_floating_point() else v for k, v in data.items()}
    ri, rr = batch(tr)
    sc = {"iteration": IT, "focal_fixed": tr.focal_fixed, **tr.schedule.scalars(IT)}
    g, m = make_train_step(S, "cpu").grads_and_metrics(params, aabb, data, ri, rr, None, sc)
    return params_to_numpy(g), {k: float(v) for k, v in m.items()}, flat


def step_cases(rank: int, names, weights_path=None):
    """`step_grads` of every (case, f64) in `names` on this rank; rank 0's
    results and whether JAX was loaded on any rank."""
    weights = None
    if weights_path is not None:
        with open(weights_path, "rb") as f:
            weights = pickle.load(f)
    out = {n: step_grads(n[0], weights, n[1]) for n in names}
    loaded = [None] * dist.get_world_size()
    dist.all_gather_object(loaded, jax_loaded())
    return out, any(loaded)


def _numpy(tree):
    """numpy copies of a tree (a CPU tensor's .numpy() shares its memory)."""
    return _tree(np.copy, params_to_numpy(tree))


def shard_grids_run(rank: int, tmp: str):
    """Replicated, then --shard_grids 1, on this group: 2 Adam steps, the
    step that ends in the first upsample and one after it, save_full, and a
    resume from the saved file against the run going on. Each rank checks
    that its plane grids and their Adam moments hold 1/W of the sharded
    axis. Returns {mode: record} with whole (gathered) parameters and
    gradients."""
    W = dist.get_world_size()
    out = {}
    for mode in ("replicated", "sharded"):
        cmd = STRIDED + (" --shard_grids 1" if mode == "sharded" else "")
        tr = Trainer(parse_cmd(cmd), tiny_scene("ndc"), device="cpu")
        rec = {"losses": [], "params": [], "grads": [], "dims": list(tr.grid_dims)}

        def note(m):
            group = mesh_group(tr.mesh)
            grads = {k: v for k, v in tr.params.items() if k in ("static", "dynamic", "pose",
                                                                 "fov")}
            # zeros on the leaves an upsample has just made
            grads = _tree(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, grads)
            rec["losses"].append(float(m["total_loss"]))
            rec["params"].append(_numpy(tr.full_params()))
            rec["grads"].append(_numpy(gather_full(grads, tr.grid_dims, group)))

        for _ in range(2):
            note(tr.run_step())
        if mode == "sharded":
            _check_shards(tr, W)
        grid0 = tr.static_cfg.grid_size
        tr.iteration = tr.args.upsamp_list[0]
        note(tr.run_step())  # ends in the upsample
        if tuple(tr.static_cfg.grid_size) == tuple(grid0):
            raise AssertionError("the upsample did not grow the grid")
        note(tr.run_step())
        if mode == "sharded":
            _check_shards(tr, W)
        path = f"{tmp}/{mode}.npz"
        tr.save_full(path)
        with open(path, "rb") as f:
            rec["ckpt"] = f.read()
        a = parse_cmd(cmd + f" --ckpt {path}")
        resumed = Trainer(a, tiny_scene("ndc"), device="cpu")
        rec["resumed_dims"] = list(resumed.grid_dims)
        rec["resumed_loss"] = float(resumed.run_step()["total_loss"])
        rec["continued_loss"] = float(tr.run_step()["total_loss"])
        out[mode] = rec
    return out


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _check_shards(tr, W):
    """Every sharded plane and its Adam moments hold 1/W of the whole
    grid's axis; at least one plane is sharded."""
    if not tr.grid_dims:
        raise AssertionError("no plane grid is sharded")
    full = tr.full_params()
    state = tr.opt_state["fields"].state
    for path, dim in tr.grid_dims:
        t, whole = _leaf(tr.params, path), tuple(_leaf(full, path).shape)
        want = tuple(n // W if i == dim else n for i, n in enumerate(whole))
        if tuple(t.shape) != want or whole[dim] % W:
            raise AssertionError(f"{path}: shard {tuple(t.shape)} of {whole} on axis {dim}")
        for k in ("exp_avg", "exp_avg_sq"):
            if tuple(state[t][k].shape) != want:
                raise AssertionError(f"{path}: Adam {k} {tuple(state[t][k].shape)}")


def compositor_run(rank: int, inputs_path: str):
    """The sample-sharded compositor on a (2, 2) mesh over the four ranks,
    on this rank's blocks of the inputs in `inputs_path`: the outputs for
    both ray types (is_train off), the white-filled outputs (is_train on,
    a coin per ray), and the gradients of sum(rgb_full) + 0.1 sum(depth_full)
    to both sigmas. Rank 0 returns every rank's (ray index, sample index,
    results)."""
    from rodynrf_tpu_torch.parallel.sample_shard import (
        make_2d_mesh,
        make_sample_sharded_raw2outputs,
        shard_compositor_inputs,
    )

    d = np.load(inputs_path)
    mesh = make_2d_mesh(2, 2, "cpu")
    res = {}
    for case in ("ndc", "contract", "white", "grads"):
        args = [torch.from_numpy(d[f"{case}_{i}"]) for i in range(8)]
        blocks = list(shard_compositor_inputs(mesh, *args))
        ray_type = "contract" if case == "contract" else "ndc"
        fn = make_sample_sharded_raw2outputs(mesh, is_train=case == "white", ray_type=ray_type)
        if case == "white":
            white = torch.from_numpy(d["white"])
            n = white.shape[0] // 2
            i = mesh.get_local_rank("ray")
            out = fn(*blocks, white[i * n:(i + 1) * n])
        elif case == "grads":
            blocks[1].requires_grad_(True)
            blocks[3].requires_grad_(True)
            out = fn(*blocks)
            (out.rgb_full.sum() + (out.depth_full * 0.1).sum()).backward()
            res["grad_sigma_s"] = blocks[1].grad.numpy()
            res["grad_sigma_d"] = blocks[3].grad.numpy()
        else:
            out = fn(*blocks)
        res[case] = {k: v.detach().numpy() for k, v in out._asdict().items()}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (mesh.get_local_rank("ray"), mesh.get_local_rank("sample"),
                                      res, jax_loaded()))
    return gathered


def gradient_rule_rank(rank: int):
    """loss = sum(gather_rows(x[span]²)) + sum(x)³ with x the same on every
    rank: each rank's gradient after the backward and the average
    (sync_gradients), and one process's (2x + 3 sum(x)²)."""
    from rodynrf_tpu_torch.parallel.collectives import gather_rows
    from rodynrf_tpu_torch.parallel.mesh import sync_gradients

    x = torch.linspace(-1.0, 2.0, 8, dtype=torch.float64).requires_grad_(True)
    W = dist.get_world_size()
    n = 8 // W
    rows = gather_rows(x[rank * n:(rank + 1) * n] ** 2, dist.group.WORLD)
    (rows.sum() + x.sum() ** 3).backward()
    sync_gradients({"x": x}, {"x": x}, (), dist.group.WORLD)
    want = 2.0 * x.detach() + 3.0 * x.detach().sum() ** 2
    return x.grad.numpy(), want.numpy()


def read_guard_rank(rank: int):
    """The "f32" step on the mesh once for each compositor output that the
    dual pass gathers, with that one output left out of the gather: the
    total loss of each (the rest of the outputs are NaN placeholders)."""
    from rodynrf_tpu_torch.train import step

    read = dict(step._READ)
    losses = {}
    try:
        for f in read["dual"]:
            step._READ["dual"] = tuple(x for x in read["dual"] if x != f)
            losses[f] = step_grads("f32")[1]["total_loss"]
    finally:
        step._READ.update(read)
    return losses
