"""The two loops a traffic mix can name ("loop": "train" | "render"), each
with its set-up, its timed window, its traced stretch and the comparison
with the plain reference that decides `correct`.

train:  Trainer.run_step back to back. Set-up builds the trainer at the
        configuration's final grid, copies the benchmark's parameters into
        it, sets its iteration (the learning-rate schedule replayed to it) and
        its draw generator, and takes the first `compared_steps` steps
        through the window's own call; those steps are the warm-up and the
        ones the reference follows.
render: render_image of the frames in turn through make_chunk_renderer.
        Set-up renders one frame; every frame of the window is compared on a
        sample of its pixels drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import model as M
from ..reference import render as RR
from ..reference import step as RS
from . import compare, inputs, trace
from .spec import Cell, program_args, reference_recipe, scene_box


@dataclasses.dataclass
class Run:
    """What a run measured; the metrics read it."""

    cell: Cell
    seed: int
    kind: str
    recipe: RS.Recipe
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                 # steps or frames in the window
    work: float = 0.0              # rays in the window
    host_ms: List[float] = dataclasses.field(default_factory=list)  # untraced calls
    unit_s: float = 0.0            # wall seconds per untraced unit
    chunks_per_unit: int = 1
    stretch: Optional[trace.Stretch] = None       # trace.py's device stretch
    host_stretch: Optional[trace.Stretch] = None  # and its host stretch
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)
    widest: Dict[str, list] = dataclasses.field(default_factory=dict)  # leaves, for a look

    @property
    def model(self) -> M.Model:
        return self.recipe.model


def _sync(device):
    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def draw_seed(seed: int) -> int:
    """The seed of the CPU generator that draws the step's jitter and coins."""
    return (int(seed) * 2654435761 + 12345) % (2 ** 63)


def _window(run: Run, seconds: float, call, units_of_call: float, profiled: int, trace_on: bool,
            sync, device="cpu"):
    """Call `call` back to back for `seconds` of the host clock (at least
    once), profiling `profiled` calls twice (trace.py's device and host
    stretches) once half the window has passed (in a traced run always
    once, after the window if no call ended inside it). Fills the run's
    window numbers."""
    n, prof_wall = 0, 0.0
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0
        if el >= seconds and n > 0 and (not trace_on or run.stretch is not None):
            break
        if trace_on and run.stretch is None and el >= seconds / 2:
            t1 = time.perf_counter()
            if torch.device(device).type == "cuda":
                run.stretch = trace.profile_device(call, profiled, sync, device)
            else:
                run.stretch = trace.Stretch(units=profiled, kernels=[], host_ops=[], start=0.0,
                                            end=0.0)
                for _ in range(profiled):
                    call()
            run.host_stretch = trace.profile_host(call, profiled, sync)
            prof_wall = time.perf_counter() - t1
            n += 2 * profiled
            continue
        a = time.perf_counter()
        call()
        run.host_ms.append((time.perf_counter() - a) * 1e3)
        n += 1
    sync()
    run.window_s = time.perf_counter() - t0
    run.units = n
    run.work = n * units_of_call
    untraced = n - (2 * profiled if run.stretch is not None else 0)
    if untraced > 0:
        run.unit_s = (run.window_s - prof_wall) / untraced


def _host(tree) -> Dict[tuple, np.ndarray]:
    return {p: t.detach().float().cpu().numpy().copy() for p, t in M.leaves(tree)}


def start_at(trainer, iteration: int) -> None:
    """Put the trainer at `iteration` as a resume from a checkpoint taken
    there would: the learning-rate and upsample schedule replayed up to it
    (the grid is already the final one, so the voxel list is only popped)."""
    for i in range(iteration):
        trainer.schedule.after_step(i)
        if i in trainer.args.upsamp_list:
            if trainer.n_voxel_list:
                trainer.n_voxel_list.pop(0)
            trainer.schedule.on_upsample(i)
    trainer.iteration = iteration


def _adam_grads(trainer) -> Dict[tuple, np.ndarray]:
    """Each leaf's first gradient as the optimizer got it: exp_avg / (1 -
    beta1) of its Adam after one step; zeros where no optimizer holds a
    state for the leaf (it never stepped)."""
    out = {}
    for path, t in M.leaves(trainer.params):
        out[path] = np.zeros(tuple(t.shape), np.float32)
        for opt in trainer.opt_state.values():
            st = opt.state.get(t)
            if st and "exp_avg" in st:
                beta1 = next(g["betas"][0] for g in opt.param_groups
                             if any(p is t for p in g["params"]))
                out[path] = st["exp_avg"].float().cpu().numpy() / (1.0 - beta1)
                break
    return out


def run_train(cell: Cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
              matmul: str = "float32") -> Run:
    from rodynrf_tpu_torch.train import Trainer

    sync = _sync(device)
    cfg, tf = cell.config, cell.traffic
    recipe = reference_recipe(cfg, seed)
    run = Run(cell=cell, seed=seed, kind="train", recipe=recipe)
    scene, poses = inputs.make_scene(cfg, seed, device)
    params = inputs.make_params(recipe.model, poses, seed, device)
    tr = Trainer(program_args(cfg, seed), scene, device=device)
    inputs.fill(tr.params, params)
    p0 = {p: t.cpu().numpy() for p, t in params.items()}
    del params
    start_at(tr, int(cfg["iteration"]))
    tr.gen = torch.Generator().manual_seed(draw_seed(seed))
    n_cmp = int(tf["compared_steps"])
    losses, grads = [], None
    for k in range(n_cmp):
        m = tr.run_step()
        losses.append(float(m["total_loss"]))
        if k == 0:
            grads = _adam_grads(tr)
    p_end = _host(tr.params)
    sync()
    run.setup_s = time.perf_counter() - t_start
    setup_peak = _peak(device)
    _reset_peak(device)

    _window(run, seconds, tr.run_step, recipe.batch_size, int(tf["profiled_units"]), trace_on,
            sync, device)
    run.peak_window_bytes = _peak(device)
    run.peak_bytes = max(setup_peak, run.peak_window_bytes)

    del tr, m
    _free(device)
    ref_losses, ref_grads, ref_end = reference_train(recipe, scene, p0, int(cfg["iteration"]),
                                                     seed, n_cmp, device, matmul)
    change = {p: p_end[p] - p0[p] for p in p0}
    ref_change = {p: ref_end[p] - p0[p] for p in p0}
    run.numbers = compare.train_numbers(losses, ref_losses, grads, ref_grads, change, ref_change)
    run.widest = compare.widest_leaves(grads, ref_grads, change, ref_change)
    return run


def reference_train(recipe: RS.Recipe, scene, p0, iteration: int, seed: int, n_steps: int,
                    device, matmul: str = "float32", keep: float = 1.0):
    """The plain reference's first `n_steps` steps from the parameters p0 on
    the scene's arrays: (losses, the first step's gradients, the parameters
    after the last step), host arrays keyed by leaf path. `keep` < 1 plants
    a fault: each batch's rays cut to that share."""
    rec = dataclasses.replace(recipe, model=dataclasses.replace(recipe.model, matmul=matmul))
    params = inputs.fresh_tree({p: torch.as_tensor(v) for p, v in p0.items()}, device)
    opts = RS.make_optimizers(params)
    data = {k: torch.as_tensor(v).to(device) for k, v in scene.device_arrays().items()}
    aabb = torch.as_tensor(scene.scene_bbox, device=device)
    s1 = RS.Sampler(scene.n_rays, rec.batch_size, rec.seed)
    s2 = RS.Sampler(scene.n_rays, rec.batch_size, rec.seed + 1)
    gen = torch.Generator().manual_seed(draw_seed(seed))
    losses, grads = [], None
    for k in range(n_steps):
        n = int(rec.batch_size * keep)
        idx = torch.as_tensor(s1.next()[:n], dtype=torch.int64).to(device)
        idx2 = torch.as_tensor(s2.next()[:n], dtype=torch.int64).to(device)
        loss, _ = RS.step(params, opts, rec, aabb, data, idx, idx2, gen, iteration + k,
                          scene.focal)
        losses.append(loss)
        if k == 0:
            grads = {p: t.grad.float().cpu().numpy().copy() for p, t in M.leaves(params)}
    return losses, grads, _host(params)


def cameras(params, model: M.Model):
    """(poses [T, 3, 4], focal) of the parameters' cameras, on the CPU."""
    with torch.no_grad():
        c2w = M.pose_to_mtx(params[("pose",)].detach().cpu()).numpy()
        fov = float(params[("fov",)].detach().cpu()[0, 0])
    return c2w, float(max(model.H, model.W) / 2.0 / np.tan(fov))


def run_render(cell: Cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
               matmul: str = "float32") -> Run:
    from rodynrf_tpu_torch.render import renderer as R
    from rodynrf_tpu_torch.train import Trainer

    sync = _sync(device)
    cfg, tf = cell.config, cell.traffic
    recipe = reference_recipe(cfg, seed)
    model = recipe.model
    run = Run(cell=cell, seed=seed, kind="render", recipe=recipe)
    scene, poses = inputs.make_scene(cfg, seed, device)
    params = inputs.make_params(model, poses, seed, device)
    tr = Trainer(program_args(cfg, seed), scene, device=device)
    inputs.fill(tr.params, params)
    c2w, focal = cameras(params, model)
    params = {p: t.cpu() for p, t in params.items()}
    prog = tr.full_params()
    chunk = int(tf["chunk"])
    render_chunk = R.make_chunk_renderer(
        tr.static_cfg, tr.dynamic_cfg, cfg["recipe"]["ray_type"], tr.n_samples,
        tr.static_cfg.step_size(np.asarray(scene.scene_bbox)))
    aabb = tr.aabb
    del tr
    _free(device)
    T, H, W = model.T, model.H, model.W
    ts = np.linspace(-1.0, 1.0, T) if T > 1 else np.zeros(1)
    run.chunks_per_unit = -(-H * W // chunk)
    frames: List[tuple] = []
    state = {"k": 0}

    def frame():
        k = state["k"] % T
        maps = R.render_image(render_chunk, prog, aabb, c2w[k], focal, float(ts[k]), H, W,
                              model.ray_type, chunk=chunk)
        state["k"] += 1
        return k, maps

    frame()  # warm-up: every chunk shape of a frame
    sync()
    run.setup_s = time.perf_counter() - t_start
    setup_peak = _peak(device)
    _reset_peak(device)

    _window(run, seconds, lambda: frames.append(frame()), H * W,
            int(tf["profiled_units"]), trace_on, sync, device)
    run.peak_window_bytes = _peak(device)
    run.peak_bytes = max(setup_peak, run.peak_window_bytes)

    del prog, render_chunk
    _free(device)
    run.numbers = reference_render(model, params, frames, c2w, focal, ts, seed,
                                   int(tf["compared_rays_per_frame"]), device, matmul)
    return run


def reference_render(model: M.Model, params, frames, c2w, focal, ts, seed: int, n_rays: int,
                     device, matmul: str = "float32") -> Dict[str, float]:
    """The reference's maps at `n_rays` pixels of every frame rendered in the
    window (pixels drawn from the seed), compared with the program's."""
    model = dataclasses.replace(model, matmul=matmul)
    ref_tree = inputs.fresh_tree(params, device, requires_grad=False)
    aabb = torch.as_tensor(scene_box(model.ray_type), device=device)
    rng = np.random.default_rng(seed)
    prog_maps: Dict[str, list] = {k: [] for k in RR.MAPS}
    ref_maps: Dict[str, list] = {k: [] for k in RR.MAPS}
    HW = model.H * model.W
    for k, maps in frames:
        pix = np.sort(rng.choice(HW, size=min(n_rays, HW), replace=False))
        got = RR.render_rays(ref_tree, model, aabb, torch.as_tensor(c2w[k], device=device), focal,
                             float(ts[k]), torch.as_tensor(pix, device=device))
        for name in RR.MAPS:
            flat = maps[name].reshape(HW, -1)
            prog_maps[name].append(flat[pix])
            ref_maps[name].append(got[name].reshape(len(pix), -1).cpu().numpy())
    cat = lambda d: {k: np.concatenate(v, 0) for k, v in d.items()}
    return compare.render_numbers(cat(prog_maps), cat(ref_maps))


LOOPS = {"train": run_train, "render": run_render}
