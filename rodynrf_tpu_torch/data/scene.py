"""SceneData — the framework's in-memory dataset contract.

Carries exactly the preloaded tensors the reference datasets expose
(reference: dataLoader/nvidia.py:348-472 all_rgbs/all_ts/all_flows_*/
all_disps/all_foreground_masks/all_poses/scene_bbox/near_far/img_wh/focal),
as host numpy arrays in flat `(T*H*W, C)` layout for training and stacked
`(T, H, W, C)` layout for evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class SceneData:
    # flat training tensors, length N = T*H*W
    rgbs: np.ndarray  # [N, 3] f32 in [0, 1]
    ts: np.ndarray  # [N] f32 in [-1, 1]
    flows_f: np.ndarray  # [N, 2] f32 (pixels)
    flow_masks_f: np.ndarray  # [N] f32 {0,1}
    flows_b: np.ndarray  # [N, 2]
    flow_masks_b: np.ndarray  # [N]
    disps: np.ndarray  # [N] f32 monocular disparity
    fg_masks: np.ndarray  # [N] f32 {0,1} motion mask
    # geometry
    img_wh: Tuple[int, int]
    n_frames: int
    scene_bbox: np.ndarray  # [2, 3] f32
    near_far: Tuple[float, float]
    focal: Optional[float] = None  # known focal (with_GT_poses)
    poses: Optional[np.ndarray] = None  # [T, 3, 4] GT c2w (with_GT_poses)
    white_bg: bool = False
    # stacked eval tensors
    rgbs_stack: Optional[np.ndarray] = None  # [T, H, W, 3]

    @property
    def n_rays(self) -> int:
        return self.rgbs.shape[0]

    def device_arrays(self):
        """The host arrays the trainer moves to the device for the train step."""
        return {
            "rgbs": self.rgbs,
            "ts": self.ts,
            "flows_f": self.flows_f,
            "flow_masks_f": self.flow_masks_f,
            "flows_b": self.flows_b,
            "flow_masks_b": self.flow_masks_b,
            "disps": self.disps,
            "fg_masks": self.fg_masks,
        }


def default_focal(W: int, H: int) -> float:
    """Focal prior when intrinsics are unknown (reference: nvidia.py:279-282)."""
    return max(H, W) / 2.0 * np.sqrt(3.0)


def default_bbox(ray_type: str) -> np.ndarray:
    """(reference: nvidia.py:246-251)."""
    if ray_type == "contract":
        return np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]], np.float32)
    return np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)
