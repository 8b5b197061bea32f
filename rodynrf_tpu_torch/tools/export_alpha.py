"""Export a dual-field occupancy (alpha) mask from a converged checkpoint
(counterpart of scripts/export_alpha.py).

The reference's eval renderer skips samples whose AlphaGridMask bit is 0
(tensorBase.py:745-765); its mask is built from the dense alpha volume
(getDenseAlpha/updateAlphaMask, tensorBase.py:564-629). For the dual model
a sample is skippable only when both fields are transparent there, so the
export takes max(alpha_static, alpha_dynamic(t)) per time slice before
thresholding.

    python -m rodynrf_tpu_torch.tools.export_alpha ckpt.npz [out.npz] [max_dim=192] [thres=1e-4]

Writes the packed mask with the JAX script's npz keys ('.' replaced by '_',
`occupancy`, `meta`), which `fields/alpha_mask.load_alpha_npz` and the JAX
package's loader both read, and prints the same JSON line. `main(argv,
device="cuda")` runs on the card and refuses without one unless the caller
passes device="cpu".
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..device import check_device
from ..fields.alpha_mask import (
    dual_dense_alpha,
    load_alpha_npz,
    max_pool3d_same,
    pack_alpha,
    update_alpha_mask,
)
from ..train.checkpoints import load_checkpoint
from ..train.convert import params_from_numpy


def checkpoint_alpha(ckpt: str, max_dim: int = 192, device="cuda"):
    """(dense dual alpha [X, Y, Z, T] of `ckpt` at min(grid, max_dim) per
    axis over linspace(-1, 1, n_frames), its aabb, the grid) on `device`."""
    dev = check_device(device)
    params, static_cfg, dynamic_cfg, aabb, extra = load_checkpoint(ckpt)
    n_t = int(extra.get("n_frames", 12)) if isinstance(extra, dict) else 12
    gs = [min(int(g), max_dim) for g in dynamic_cfg.grid_size]
    t_values = np.linspace(-1.0, 1.0, n_t)
    fields = params_from_numpy({"static": params["static"], "dynamic": params["dynamic"]}, dev)
    return dual_dense_alpha(fields, static_cfg, dynamic_cfg, aabb, t_values, gs), aabb, gs


def export(ckpt: str, out_path: str | None = None, max_dim: int = 192, thres: float = 1e-4,
           device="cuda") -> dict:
    """The mask of `ckpt` (checkpoint_alpha, thresholded by
    update_alpha_mask), written to `out_path` (default: alpha_mask.npz
    beside the checkpoint). Returns the printed record: {out, grid,
    occupancy, new_aabb}."""
    if out_path is None:
        out_path = os.path.join(os.path.dirname(ckpt), "alpha_mask.npz")
    alpha, aabb, gs = checkpoint_alpha(ckpt, max_dim, device)
    mask, new_aabb = update_alpha_mask(alpha, torch.as_tensor(aabb, device=alpha.device), thres)
    occ = float(mask.alpha_volume.double().mean())
    packed = pack_alpha(mask)
    np.savez_compressed(
        out_path,
        **{k.replace(".", "_"): v for k, v in packed.items()},
        occupancy=np.float32(occ),
        meta=json.dumps({"ckpt": os.path.basename(ckpt), "grid": gs, "thres": thres}),
    )
    return {"out": out_path, "grid": gs, "occupancy": round(occ, 4),
            "new_aabb": new_aabb.cpu().numpy().tolist()}


def pooled_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """The [Z, Y, X, T] volume update_alpha_mask thresholds: the dense alpha
    [X, Y, Z, T] clamped to [0, 1], in the mask's axis order, 3³
    max-pooled."""
    return max_pool3d_same(torch.clamp(alpha, 0, 1).permute(2, 1, 0, 3), 3)


def compare_masks(path_a: str, path_b: str, pooled: np.ndarray, thres: float,
                  atol: float = 1e-5) -> dict:
    """Two exported masks of one volume, voxel by voxel: how many differ,
    and how many of those lie more than `atol` from the threshold in
    `pooled` (pooled_alpha of either export's dense alpha): a mask built
    from alphas that agree to atol may differ only where alpha is within
    atol of thres."""
    a, b = (load_alpha_npz(p) for p in (path_a, path_b))
    va, vb = a.alpha_volume.numpy() > 0, b.alpha_volume.numpy() > 0
    if va.shape != vb.shape or va.shape != pooled.shape:
        raise ValueError(f"mask shapes {va.shape}, {vb.shape}, pooled {pooled.shape}")
    differ = va != vb
    off = differ & (np.abs(pooled.astype(np.float64) - thres) > atol)
    return {"voxels": int(va.size), "differ": int(differ.sum()), "differ_off_threshold":
            int(off.sum()), "atol": atol, "aabb_equal": bool(np.array_equal(
                a.aabb.numpy(), b.aabb.numpy()))}


def main(argv=None, device="cuda") -> dict:
    """The JAX script's positional arguments: ckpt [out.npz] [max_dim]
    [thres]."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_device(device)
    if not argv:
        raise SystemExit("usage: python -m rodynrf_tpu_torch.tools.export_alpha ckpt.npz "
                         "[out.npz] [max_dim=192] [thres=1e-4]")
    rec = export(argv[0], argv[1] if len(argv) > 1 else None,
                 int(argv[2]) if len(argv) > 2 else 192,
                 float(argv[3]) if len(argv) > 3 else 1e-4, device=device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
