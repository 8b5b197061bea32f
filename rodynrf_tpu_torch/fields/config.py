"""Static field configuration, shared by both field types (port of
rodynrf_tpu/fields/config.py).

Carries every hyperparameter the reference threads through TensorBase.__init__
(reference: models/tensorBase.py:281-339) — minus device/aabb, which are
runtime tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class FieldConfig:
    grid_size: Tuple[int, int, int]
    t_size: int
    density_n_comp: Tuple[int, ...] = (16, 4, 4)
    app_n_comp: Tuple[int, ...] = (48, 12, 12)
    app_dim: int = 27
    shading_mode: str = "MLP_Fea_late_view"
    density_shift: float = -10.0
    alpha_mask_thres: float = 0.001
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 0.0001
    fea2dense_act: str = "softplus"
    near_far: Tuple[float, float] = (2.0, 6.0)
    step_ratio: float = 2.0
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    featureC: int = 128
    # 'bfloat16' packs the gather tables in bf16 (interpolation, MLPs and
    # optimizers stay f32); 'float32' keeps them f32
    grid_sample_dtype: str = "float32"
    # multiscale table layout: 'strided' (one corner-packed table per stride),
    # 'merged' (one row per joint multiscale cell) or 'auto' (picks by table
    # bytes, ops/fused_vm.resolve_layout)
    vm_layout: str = "auto"

    @property
    def gather_dtype(self):
        """The packed tables' dtype: torch.bfloat16, or None for f32."""
        if self.grid_sample_dtype == "float32":
            return None
        if self.grid_sample_dtype == "bfloat16":
            return torch.bfloat16
        raise ValueError(f"unknown grid_sample_dtype {self.grid_sample_dtype!r}")

    def with_grid(self, grid_size) -> "FieldConfig":
        return dataclasses.replace(self, grid_size=tuple(int(g) for g in grid_size))

    def step_size(self, aabb: np.ndarray) -> float:
        """Marching step: mean voxel edge × step_ratio (reference:
        tensorBase.py:373-384)."""
        aabb = np.asarray(aabb)
        units = (aabb[1] - aabb[0]) / (np.asarray(self.grid_size) - 1)
        return float(units.mean() * self.step_ratio)

    def n_samples(self, aabb: np.ndarray) -> int:
        """Samples to cover the aabb diagonal (reference: tensorBase.py:381-382)."""
        aabb = np.asarray(aabb)
        diag = float(np.linalg.norm(aabb[1] - aabb[0]))
        return int(diag / self.step_size(aabb)) + 1


def n_to_reso(n_voxels: int, aabb) -> Tuple[int, int, int]:
    """Total voxel budget -> per-axis resolution (reference: utils.py:58-61)."""
    aabb = np.asarray(aabb, np.float64)
    extent = aabb[1] - aabb[0]
    voxel_size = (extent.prod() / n_voxels) ** (1.0 / 3.0)
    return tuple(int(x) for x in (extent / voxel_size))


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    """(reference: utils.py:64-65)."""
    return int(np.linalg.norm(np.asarray(reso, np.float64)) / step_ratio)
