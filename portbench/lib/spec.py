"""A cell of the benchmark, found by name in its data files.

    workloads/<cell>.json   {"config", "traffic", "limits", "why"}
    configs/<config>.json   the recipe's keys as published, the keys this run
                            changes, the scene it synthesises
    traffic/<traffic>.json  the loop that drives the program and its knobs
    metrics/<metric>.py     one per-layer metric: UNIT, LAYER, MOVES, BETTER
                            and read(run) -> value or None

Nothing in this module knows a configuration, a traffic mix or a metric by
name: a new one is a new file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    metrics: Dict[str, ModuleType]  # per-layer metrics this cell's rate moves

    @property
    def rate_metric(self) -> str:
        return self.traffic["rate_metric"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("UNIT", "LAYER", "MOVES", "BETTER", "read"):
        if not hasattr(mod, key):
            raise ValueError(f"{path}: a metric file defines {key}")
    return mod


def all_metrics(root: Path = ROOT) -> Dict[str, ModuleType]:
    return {p.name[:-3]: load_metric(p) for p in sorted((root / "metrics").glob("*.py"))}


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _json(root / "workloads" / f"{name}.json")
    cfg = _json(root / "configs" / f"{w['config']}.json")
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    metrics = {k: m for k, m in all_metrics(root).items() if m.MOVES == traffic["rate_metric"]}
    return Cell(name, w, cfg, traffic, metrics)


def recipe_flags(cfg: dict) -> List[str]:
    """The program's command-line flags: the published recipe's keys with
    the run's changes over them (a list value repeats its flag)."""
    keys = {**cfg["recipe"], **cfg.get("run", {})}
    argv: List[str] = []
    for k, v in keys.items():
        for item in (v if isinstance(v, list) else [v]):
            argv += [f"--{k}", str(item)]
    return argv


def program_args(cfg: dict, seed: int):
    """The program's parsed options for this configuration and seed."""
    from rodynrf_tpu_torch.train import config_parser

    return config_parser(recipe_flags(cfg) + ["--seed", str(seed)])


def _grid(n_voxels: int, box: np.ndarray) -> tuple:
    """Voxel budget -> per-axis resolution over the float32 scene box (the
    reference's N_to_reso, utils.py:58-61)."""
    ext = np.asarray(box, np.float64)[1] - np.asarray(box, np.float64)[0]
    size = (ext.prod() / n_voxels) ** (1.0 / 3.0)
    return tuple(int(e) for e in ext / size)


def scene_box(ray_type: str) -> np.ndarray:
    """The scene's float32 bounding box (the datasets' scene_bbox)."""
    return np.array(SCENE_BOX[ray_type], np.float32)


SCENE_BOX = {"ndc": ((-1.5, -1.67, -1.0), (1.5, 1.67, 1.0)),
             "contract": ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))}
NEAR_FAR = {"ndc": (0.0, 1.0), "contract": (0.1, 256.0)}


def reference_recipe(cfg: dict, seed: int, matmul: str = "float32"):
    """The plain reference's model and recipe for this configuration, from
    the configuration's own keys and the reference's defaults (train.py's
    opt.py) for the keys the recipe leaves out."""
    from ..reference import model as M
    from ..reference import step as RS

    a = {**DEFAULTS, **cfg["recipe"], **cfg.get("run", {})}
    ray = a["ray_type"]
    box = scene_box(ray)
    grid = _grid(int(a["N_voxel_init"]), box)
    n_samples = min(int(a["nSamples"]), int(math.sqrt(sum(g * g for g in grid))
                                            / float(a["step_ratio"])))
    step_size = float(((box[1] - box[0]) / (np.asarray(grid) - 1)).mean()
                      * float(a["step_ratio"]))
    bf16 = cfg["gather"] == "bfloat16"

    def field(mode, fea_pe):
        return M.FieldSpec(
            grid=grid, density_n_comp=tuple(a["n_lamb_sigma"]), app_n_comp=tuple(a["n_lamb_sh"]),
            app_dim=int(a["data_dim_color"]), shading_mode=mode, fea_pe=fea_pe,
            view_pe=int(a["view_pe"]), pos_pe=int(a["pos_pe"]), featureC=int(a["featureC"]),
            density_shift=float(a["density_shift"]), fea2dense_act=a["fea2denseAct"],
            distance_scale=float(a["distance_scale"]),
            ray_march_weight_thres=float(a["rm_weight_mask_thre"]), bf16=bf16)

    sc = cfg["scene"]
    # the static field's feature encoding is fixed at 2 bands and the
    # dynamic field's at none (train.py:889, 918), whatever fea_pe says
    model = M.Model(static=field(a["shadingModeStatic"], 2), dynamic=field(a["shadingMode"], 0),
                    ray_type=ray, near_far=NEAR_FAR[ray], n_samples=n_samples,
                    step_size=step_size, H=int(sc["height"]), W=int(sc["width"]),
                    T=int(a["N_voxel_t"]), matmul=matmul)
    if float(a["Ortho_weight"]) > 0:
        raise ValueError("the reference step has no line-orthogonality term")
    weights = RS.Weights(
        distortion_static=float(a["distortion_weight_static"]),
        distortion_dynamic=float(a["distortion_weight_dynamic"]),
        monodepth_static=float(a["monodepth_weight_static"]),
        monodepth_dynamic=float(a["monodepth_weight_dynamic"]),
        small_scene_flow=float(a["small_scene_flow_weight"]),
        smooth_scene_flow=float(a["smooth_scene_flow_weight"]),
        l1=float(a["L1_weight_inital"]), tv_density=float(a["TV_weight_density"]),
        tv_app=float(a["TV_weight_app"]))
    accum = int(cfg["micro_batches"])
    return RS.Recipe(
        model=model, weights=weights, optimize_poses=bool(int(a["optimize_poses"])),
        optimize_focal=bool(int(a["optimize_focal_length"])), use_disp=bool(int(a["use_disp"])),
        n_iters=int(a["n_iters"]), upsamp_list=tuple(int(u) for u in a["upsamp_list"]),
        lr_init=float(a["lr_init"]), lr_basis=float(a["lr_basis"]),
        lr_decay_target_ratio=float(a["lr_decay_target_ratio"]), grad_accum=accum,
        batch_size=int(a["batch_size"]), seed=seed)


# the reference's option defaults (opt.py) for keys a recipe may leave out
DEFAULTS = {
    "nSamples": 1_000_000, "data_dim_color": 27, "pos_pe": 6, "view_pe": 6, "featureC": 128,
    "density_shift": -10.0, "fea2denseAct": "softplus", "distance_scale": 25.0,
    "rm_weight_mask_thre": 1e-4, "shadingModeStatic": "MLP_Fea_TimeEmbedding",
    "Ortho_weight": 0.0, "distortion_weight_static": 0.0, "distortion_weight_dynamic": 0.0,
    "monodepth_weight_static": 0.04, "monodepth_weight_dynamic": 0.04,
    "small_scene_flow_weight": 0.1, "smooth_scene_flow_weight": 0.1, "L1_weight_inital": 0.0,
    "TV_weight_density": 0.0, "TV_weight_app": 0.0, "lr_init": 0.02, "lr_basis": 1e-3,
    "lr_decay_target_ratio": 0.1, "optimize_poses": 0,
    "optimize_focal_length": 0, "use_disp": 0,
}
