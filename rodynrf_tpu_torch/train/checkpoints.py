"""Checkpointing: the native .npz format and the reference's .th format
(port of rodynrf_tpu/train/checkpoints.py).

The native format is the JAX package's, so a checkpoint crosses between the
two packages either way: the parameter tree with slash-joined keys
(`_flatten`), stored float32, plus a `__meta__` JSON header (both field
configs, the aabb, `extra`, `format_version` 1). An occupancy mask
(fields/alpha_mask.AlphaGridMask) rides bit-packed under `__alpha__/`
(shape, mask, aabb), as the JAX package stores it.

The `.th` exporter writes what the reference's PyTorch code loads (its
state_dict names and layouts plus the kwargs block, train.py:435-449,
tensorBase.py:438-470); the importer loads reference-trained checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..fields.alpha_mask import AlphaGridMask, pack_alpha, unpack_alpha
from ..fields.config import FieldConfig

SEP = "/"
# FieldConfig keys of the JAX package that the port's config lacks: the
# table-gradient route, which changes no output (the port's are the kernels)
_FOREIGN_CFG_KEYS = {"grad_impl"}


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[: -len(SEP)]] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_checkpoint(
    path: str,
    params,
    static_cfg: FieldConfig,
    dynamic_cfg: FieldConfig,
    aabb,
    extra: Dict[str, Any] | None = None,
    alpha_mask: AlphaGridMask | None = None,
):
    """Write a native checkpoint. `params` is a nested dict/list tree of
    tensors or arrays (floats stored f32); `alpha_mask` an AlphaGridMask or
    None."""
    flat = _flatten(params)
    if alpha_mask is not None:
        packed = pack_alpha(alpha_mask)
        flat["__alpha__/shape"] = np.asarray(packed["alphaMask.shape"])
        flat["__alpha__/mask"] = packed["alphaMask.mask"]
        flat["__alpha__/aabb"] = packed["alphaMask.aabb"]
    meta = {
        "static_cfg": dataclasses.asdict(static_cfg),
        "dynamic_cfg": dataclasses.asdict(dynamic_cfg),
        "aabb": _to_numpy(aabb).tolist(),
        "extra": extra or {},
        "format_version": 1,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **flat)


def _cfg_from_meta(d: Dict[str, Any]) -> FieldConfig:
    known = {f.name for f in dataclasses.fields(FieldConfig)}
    kw = {}
    for k, v in d.items():
        if k in known:
            kw[k] = v
        elif k not in _FOREIGN_CFG_KEYS:
            raise ValueError(f"checkpoint field config has an unknown key {k!r}")
    for k in ("grid_size", "density_n_comp", "app_n_comp", "near_far"):
        kw[k] = tuple(kw[k])
    return FieldConfig(**kw)


def load_checkpoint(path: str, return_alpha: bool = False):
    """-> (params as numpy trees, static_cfg, dynamic_cfg, aabb, extra[,
    alpha]) where alpha is an AlphaGridMask on the CPU, or None."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    alpha_mask = None
    if "__alpha__/mask" in flat:
        alpha_mask = unpack_alpha({f"alphaMask.{k}": flat.pop(f"__alpha__/{k}")
                                   for k in ("shape", "mask", "aabb")})
    params = _unflatten(flat)
    static_cfg = _cfg_from_meta(meta["static_cfg"])
    dynamic_cfg = _cfg_from_meta(meta["dynamic_cfg"])
    aabb = np.asarray(meta["aabb"], np.float32)
    if return_alpha:
        return params, static_cfg, dynamic_cfg, aabb, meta["extra"], alpha_mask
    return params, static_cfg, dynamic_cfg, aabb, meta["extra"]


# ---------------------------------------------------------------------------
# torch .th compatibility (reference checkpoint format)
# ---------------------------------------------------------------------------

def _shading_state(shading, mode: str, prefix: str) -> Dict[str, np.ndarray]:
    """Shading params -> reference renderModule.* names
    (tensorBase.py:81-278 module structures)."""
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = _to_numpy(p["w"]).T
        sd[f"{name}.bias"] = _to_numpy(p["b"])

    if mode in ("MLP_Fea", "MLP_Fea_woView", "MLP_PE", "MLP"):
        # Sequential(l, ReLU, l, ReLU, l) -> indices 0, 2, 4
        for i, layer in enumerate(shading["mlp"]):
            lin(f"{prefix}.mlp.{2 * i}", layer)
    elif mode in ("MLP_Fea_TimeEmbedding", "MLP_Fea_late_view"):
        for i, layer in enumerate(shading["mlp"]):
            lin(f"{prefix}.mlp.{2 * i}", layer)
        lin(f"{prefix}.mlp_view.0", shading["mlp_view"][0])
    elif mode == "RGB":
        pass
    else:
        raise ValueError(mode)
    return sd


def _vm_state(params, key: str) -> Dict[str, np.ndarray]:
    sd = {}
    for i in range(3):
        sd[f"{key}_plane.{i}"] = _to_numpy(params[f"{key}_plane"][i])[None]  # [1,C,H,W]
        sd[f"{key}_line.{i}"] = _to_numpy(params[f"{key}_line"][i])[None, ..., None]  # [1,C,L,1]
    return sd


def static_state_dict(params, cfg: FieldConfig) -> Dict[str, np.ndarray]:
    sd = {}
    sd.update(_vm_state(params, "density"))
    sd.update(_vm_state(params, "app"))
    sd["basis_mat.weight"] = _to_numpy(params["basis_mat"]).T
    sd.update(_shading_state(params["shading"], cfg.shading_mode, "renderModule"))
    return sd


def dynamic_state_dict(params, cfg: FieldConfig) -> Dict[str, np.ndarray]:
    sd = {}
    sd.update(_vm_state(params, "density"))
    sd.update(_vm_state(params, "blending"))
    sd.update(_vm_state(params, "app"))
    sd["basis_mat.weight"] = _to_numpy(params["basis_mat"]).T
    sd.update(_shading_state(params["shading"], cfg.shading_mode, "renderModule"))

    def lin(name, p):
        sd[f"{name}.weight"] = _to_numpy(p["w"]).T
        sd[f"{name}.bias"] = _to_numpy(p["b"])

    lin("layer1", params["warp_t1"])
    lin("layer2", params["warp_t2"])
    for i, layer in enumerate(params["warp_xyz"]):
        lin(f"layer{3 + i}", layer)
    for i, layer in enumerate(params["density_head"]):
        lin(f"density_layer{1 + i}", layer)
    for i, layer in enumerate(params["blending_head"]):
        lin(f"blending_layer{1 + i}", layer)
    for i, layer in enumerate(params["scene_flow"]):
        lin(f"scene_flow_mlp.{2 * i}", layer)
    return sd


def reference_kwargs(cfg: FieldConfig, aabb, poses_mtx, focal) -> Dict[str, Any]:
    """kwargs block the reference embeds in its ckpt (tensorBase.py:438-463)."""
    return {
        "aabb": torch.tensor(_to_numpy(aabb), dtype=torch.float32),
        "gridSize": list(cfg.grid_size),
        "tSize": cfg.t_size,
        "density_n_comp": list(cfg.density_n_comp),
        "appearance_n_comp": list(cfg.app_n_comp),
        "app_dim": cfg.app_dim,
        "density_shift": cfg.density_shift,
        "alphaMask_thres": cfg.alpha_mask_thres,
        "distance_scale": cfg.distance_scale,
        "rayMarch_weight_thres": cfg.ray_march_weight_thres,
        "fea2denseAct": cfg.fea2dense_act,
        "near_far": list(cfg.near_far),
        "step_ratio": cfg.step_ratio,
        "shadingMode": cfg.shading_mode,
        "pos_pe": cfg.pos_pe,
        "view_pe": cfg.view_pe,
        "fea_pe": cfg.fea_pe,
        "featureC": cfg.featureC,
        "se3_poses": torch.tensor(_to_numpy(poses_mtx), dtype=torch.float32),
        "focal_ratio_refine": torch.tensor(float(focal)),
    }


def export_th(
    path: str, params, cfg: FieldConfig, aabb, poses_mtx, focal, *, dynamic: bool,
    alpha_mask: AlphaGridMask | None = None,
):
    """Write a reference-loadable .th checkpoint (train.py:2417-2426 files).
    alpha_mask: an AlphaGridMask, stored as the reference's TensorBase.save
    stores its mask (tensorBase.py:465-469): the bit-packed bool volume of
    shape [1, 1, D, H, W, T] and its aabb, at the top level."""
    sd_np = dynamic_state_dict(params, cfg) if dynamic else static_state_dict(params, cfg)
    state_dict = {k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in sd_np.items()}
    ckpt = {"kwargs": reference_kwargs(cfg, aabb, poses_mtx, focal), "state_dict": state_dict}
    if alpha_mask is not None:
        packed = pack_alpha(alpha_mask)
        ckpt["alphaMask.shape"] = (1, 1) + tuple(int(s) for s in packed["alphaMask.shape"])
        ckpt["alphaMask.mask"] = packed["alphaMask.mask"]
        ckpt["alphaMask.aabb"] = torch.tensor(packed["alphaMask.aabb"], dtype=torch.float32)
    torch.save(ckpt, path)


def _import_shading(sd, mode: str, prefix: str):
    def lin(name):
        return {"w": sd[f"{name}.weight"].T.copy(), "b": sd[f"{name}.bias"].copy()}

    if mode in ("MLP_Fea", "MLP_Fea_woView", "MLP_PE", "MLP"):
        return {"mlp": [lin(f"{prefix}.mlp.{2 * i}") for i in range(3)]}
    if mode in ("MLP_Fea_TimeEmbedding", "MLP_Fea_late_view"):
        return {
            "mlp": [lin(f"{prefix}.mlp.{2 * i}") for i in range(2)],
            "mlp_view": [lin(f"{prefix}.mlp_view.0")],
        }
    if mode == "RGB":
        return {}
    raise ValueError(mode)


def import_th(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a reference .th -> (params as numpy trees, meta). Handles both
    static (TensorVMSplit) and dynamic (TensorVMSplit_TimeEmbedding)
    checkpoints. The file holds tensors, lists and ints in its kwargs, so it
    is unpickled whole (`weights_only=False`): load only the repo's own
    recordings and checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().numpy() for k, v in ckpt["state_dict"].items()}
    kwargs = ckpt["kwargs"]
    mode = kwargs["shadingMode"]

    def vm(key):
        planes = [sd[f"{key}_plane.{i}"][0].copy() for i in range(3)]
        lines = [sd[f"{key}_line.{i}"][0, ..., 0].copy() for i in range(3)]
        return planes, lines

    params: Dict[str, Any] = {}
    params["density_plane"], params["density_line"] = vm("density")
    params["app_plane"], params["app_line"] = vm("app")
    params["basis_mat"] = sd["basis_mat.weight"].T.copy()
    params["shading"] = _import_shading(sd, mode, "renderModule")

    dynamic = "blending_plane.0" in sd
    if dynamic:
        params["blending_plane"], params["blending_line"] = vm("blending")

        def lin(name):
            return {"w": sd[f"{name}.weight"].T.copy(), "b": sd[f"{name}.bias"].copy()}

        params["warp_t1"] = lin("layer1")
        params["warp_t2"] = lin("layer2")
        params["warp_xyz"] = [lin(f"layer{i}") for i in (3, 4, 5)]
        params["density_head"] = [lin(f"density_layer{i}") for i in (1, 2)]
        params["blending_head"] = [lin(f"blending_layer{i}") for i in (1, 2)]
        params["scene_flow"] = [lin(f"scene_flow_mlp.{2 * i}") for i in range(4)]

    meta = {
        "kwargs": {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in kwargs.items()},
        "dynamic": dynamic,
    }
    # the packed occupancy mask (reference: tensorBase.py:465-469 save;
    # its 472-484 load crashes on a missing tSize argument, so the mask is
    # rebuilt here as an AlphaGridMask instead)
    if "alphaMask.aabb" in ckpt:
        shape = tuple(int(s) for s in ckpt["alphaMask.shape"])
        aabb_t = ckpt["alphaMask.aabb"]
        meta["alpha_mask"] = unpack_alpha({
            "alphaMask.shape": shape[2:] if len(shape) == 6 else shape,  # drop [1, 1, ...]
            "alphaMask.mask": np.asarray(ckpt["alphaMask.mask"]),
            "alphaMask.aabb": aabb_t.numpy() if hasattr(aabb_t, "numpy") else np.asarray(aabb_t),
        })
    return params, meta
